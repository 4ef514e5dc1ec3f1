"""The reference's pattern-driven model skeleton (``repro.models.transformer``)
for all ten of its models: global attention (``"attn"``, GQA or MLA) with
a SwiGLU or MoE feed-forward, windowed local attention (``"local"``),
RG-LRU (``"rglru"``) and the self-contained xLSTM blocks (``"mlstm"``,
``"slstm"``); the vision projector (image tokens first) and the audio
frontend (a projection of precomputed frames, masked frames, a conv
positional embedding) with an encoder's bidirectional attention. That
covers the dense models (qwen3-1.7b, stablelm-1.6b, deepseek-7b, yi-34b),
granite-moe-1b, deepseek-v2-236b, recurrentgemma-2b, xlstm-125m,
llava-next-mistral-7b and hubert-xlarge.

Functional, as the reference: :meth:`TransformerLM.init` returns a dict
of tensors and every method takes it explicitly, so the serving engine
passes ``model`` and ``params`` as the reference's does. Parameters keep
the reference's tree: ``embed`` (an audio model has ``frontend_proj``,
``conv_pos`` and ``mask_embed`` instead; a vision one ``projector`` too);
``blocks["g0".."g{G-1}"]``, one entry per
kind of ``cfg.block_pattern``, stacked with a leading ``n_tiles =
n_layers // G`` axis; ``tail``, a list of the ``n_layers % G`` blocks
left over (the pattern's first kinds); ``final_norm`` and, untied,
``lm_head``. Weights are ``(in, out)`` for ``x @ W``.
:mod:`repro_torch.models.convert` carries the reference's parameters
across. The reference's ``lax.scan`` over tiles is a loop over layers
here, in the same order: tile by tile, then the tail.

API:
  init(gen) -> params
  loss(params, batch) -> (scalar, metrics)
  forward_logits(params, batch) -> logits          # full sequence
  init_cache(batch_size, cache_len) -> caches      # zeroed decode cache
  prefill(params, batch, cache_len) -> (last_logits, caches)
  decode_step(params, tokens, caches, position) -> (logits, caches)

An encoder (hubert-xlarge) has no decode step: it raises there, as the
reference does.

``remat=True`` recomputes each tile's forward in the backward
(``torch.utils.checkpoint``, non-reentrant) while autograd records. It
saves nothing inside the tile but its inputs, where the reference's
default ``"dots"`` policy also keeps the matmul outputs: PyTorch's
checkpoint has no policy by operation, and the point of remat is the
memory. Either way the numbers are the same.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device

from . import attention as attn
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import shardctx
from . import xlstm as xlstm_mod
from .layers import (
    Params,
    dense_init,
    embed_init,
    mlp_apply,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    softmax_cross_entropy,
)

KINDS = ("attn", "local", "rglru", "mlstm", "slstm")
XLSTM = ("mlstm", "slstm")          # self-contained blocks: no ln2, no FFN
_SUPPORTED = {"attention": ("full", "mla"), "modality": ("text", "vision_text", "audio")}


def _unsupported(cfg) -> str:
    for kind in cfg.block_pattern:
        if kind not in KINDS:
            return f"block kind {kind!r}"
    for field, values in _SUPPORTED.items():
        if getattr(cfg, field) not in values:
            return f"{field} {getattr(cfg, field)!r}"
    return ""


def _unstack(tree, n: int):
    """The ``n`` tiles of a tree stacked over tiles, as a list of trees of
    views (``torch.unbind``: its backward stacks the tiles' gradients in
    one pass, where indexing would add a stack-sized gradient per tile)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree))


def _stack(trees):
    """Trees of equal structure stacked along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _write(dst, src) -> None:
    """Copies the tree ``src`` into the tree ``dst`` (views into the caches)."""
    for k, v in src.items():
        if isinstance(v, dict):
            _write(dst[k], v)
        else:
            dst[k].copy_(v)


class TransformerLM(nn.Module):
    def __init__(self, cfg, *, param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                 remat: bool = False) -> None:
        super().__init__()
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(f"{cfg.name}: {missing} is not a part of the models")
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.remat = remat
        G = len(cfg.block_pattern)
        self.n_tiles = cfg.n_layers // G
        self.n_tail = cfg.n_layers % G
        self.tail_kinds = cfg.block_pattern[: self.n_tail]

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _mla(self, kind: str) -> bool:
        return self.cfg.attention == "mla" and kind == "attn"

    def _block_init(self, gen, device, kind: str, lead: tuple = ()) -> Params:
        cfg, dt = self.cfg, self.param_dtype
        p: Params = {"ln1": rmsnorm_init(cfg.d_model, dt, device, lead)}
        if kind in XLSTM:
            init = xlstm_mod.mlstm_init if kind == "mlstm" else xlstm_mod.slstm_init
            p["core"] = init(gen, cfg, dt, device, lead)
            return p
        if kind == "rglru":
            p["core"] = rglru_mod.rglru_init(gen, cfg, dt, device, lead)
        elif self._mla(kind):
            p["attn"] = attn.mla_init(gen, cfg, dt, device, lead)
        else:
            p["attn"] = attn.gqa_init(gen, cfg, dt, device, lead)
        p["ln2"] = rmsnorm_init(cfg.d_model, dt, device, lead)
        if cfg.moe and kind == "attn":
            p["ffn"] = moe_mod.moe_init(gen, cfg, dt, device, lead)
        else:
            p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dt, device, lead)
        return p

    def init(self, gen: torch.Generator) -> Params:
        """Parameters drawn from ``gen`` on the generator's device, with the
        reference's distributions (not its bits)."""
        cfg, dt, dev = self.cfg, self.param_dtype, gen.device
        d = cfg.d_model
        params: Params = {}
        if cfg.modality == "audio":
            params["frontend_proj"] = dense_init(gen, d, d, dt, dev)
            w = 0.02 * torch.randn((128, d), generator=gen, dtype=torch.float32, device=dev)
            params["conv_pos"] = {"w": w.to(dt), "b": torch.zeros((d,), dtype=dt, device=dev)}
            params["mask_embed"] = (0.02 * torch.randn((d,), generator=gen, dtype=torch.float32,
                                                       device=dev)).to(dt)
        else:
            params["embed"] = embed_init(gen, cfg.vocab_size, d, dt, dev)
        if cfg.modality == "vision_text":
            params["projector"] = {"w1": dense_init(gen, cfg.vision_dim, d, dt, dev),
                                   "w2": dense_init(gen, d, d, dt, dev)}
        if self.n_tiles > 0:
            params["blocks"] = {f"g{g}": self._block_init(gen, dev, kind, (self.n_tiles,))
                                for g, kind in enumerate(cfg.block_pattern)}
        if self.n_tail:
            params["tail"] = [self._block_init(gen, dev, kind) for kind in self.tail_kinds]
        params["final_norm"] = rmsnorm_init(cfg.d_model, dt, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt, dev)
        return params

    def _tiles(self, tree) -> List[list]:
        """The tiles of ``tree`` (the parameters or the caches), each the
        list of its blocks' subtrees in ``block_pattern`` order (views)."""
        if self.n_tiles == 0:
            return []
        groups = [_unstack(tree["blocks"][f"g{g}"], self.n_tiles)
                  for g in range(len(self.cfg.block_pattern))]
        return [[grp[i] for grp in groups] for i in range(self.n_tiles)]

    def _layers(self, tree) -> Iterator[Tuple[str, object]]:
        """(kind, layer's subtree) of ``tree`` in the order the layers run:
        tile by tile, then the tail."""
        for tile in self._tiles(tree):
            yield from zip(self.cfg.block_pattern, tile)
        for i, kind in enumerate(self.tail_kinds):
            yield kind, tree["tail"][i]

    def _collect(self, per_layer):
        """Per-layer trees in :meth:`_layers` order, as the reference's
        ``blocks`` (stacked over tiles) and ``tail``."""
        out, G = {}, len(self.cfg.block_pattern)
        if self.n_tiles > 0:
            out["blocks"] = {f"g{g}": _stack(per_layer[g:self.n_tiles * G:G]) for g in range(G)}
        if self.n_tail:
            out["tail"] = list(per_layer[self.n_tiles * G:])
        return out

    # ------------------------------------------------------------------
    # blocks: pre-norm mixer (attention, MLA or RG-LRU) + SwiGLU or MoE,
    # or a self-contained xLSTM block
    # ------------------------------------------------------------------
    def _moe(self, h, p_ffn):
        """MoE FFN: the launcher-installed override when there is one, else
        the gather dispatch of :mod:`repro_torch.models.moe`."""
        override = shardctx.get("moe_apply")
        if override is not None:
            res = override(h, p_ffn, self.cfg, capacity_factor=self.cfg.capacity_factor)
            if res is not None:
                return res
        return moe_mod.moe_apply(h, p_ffn, self.cfg, capacity_factor=self.cfg.capacity_factor)

    def _ffn(self, x, p, kind: str, decode: bool = False):
        h2 = rmsnorm(x, p["ln2"], self.cfg.norm_eps)
        if self.cfg.moe and kind == "attn":
            if decode:
                f, aux = moe_mod.moe_apply(h2, p["ffn"], self.cfg, no_drop=True)
            else:
                f, aux = self._moe(h2, p["ffn"])
            return x + f, aux
        return x + mlp_apply(h2, p["ffn"]), None

    def _window(self, kind: str) -> int:
        return self.cfg.window if kind == "local" else 0

    def _block_forward(self, x, p, kind: str):
        cfg = self.cfg
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if kind == "mlstm":
            return x + xlstm_mod.mlstm_block_forward(h, p["core"], cfg), None
        if kind == "slstm":
            return x + xlstm_mod.slstm_block_forward(h, p["core"], cfg), None
        causal = not cfg.is_encoder
        if kind == "rglru":
            x = x + rglru_mod.rglru_block_forward(h, p["core"], cfg)
        elif self._mla(kind):
            x = x + attn.mla_forward(h, p["attn"], cfg, causal=causal)
        else:
            x = x + attn.gqa_forward(h, p["attn"], cfg, causal=causal, window=self._window(kind))
        return self._ffn(x, p, kind)

    def _block_prefill(self, x, p, kind: str, cache_len: int):
        h = rmsnorm(x, p["ln1"], self.cfg.norm_eps)
        if kind in XLSTM:
            prefill = (xlstm_mod.mlstm_block_prefill if kind == "mlstm"
                       else xlstm_mod.slstm_block_prefill)
            a, cache = prefill(h, p["core"], self.cfg)
            return x + a, cache
        if kind == "rglru":
            a, cache = rglru_mod.rglru_block_prefill(h, p["core"], self.cfg)
        elif self._mla(kind):
            a, cache = attn.mla_prefill(h, p["attn"], self.cfg, cache_len)
        else:
            window = self._window(kind)
            a, cache = attn.gqa_prefill(h, p["attn"], self.cfg, cache_len, window=window)
            T, W = x.shape[1], cache["k"].shape[1]
            if window > 0 and T >= W:
                # ring-buffer alignment: the token at position q sits in
                # slot q % window (see gqa_decode_step)
                shift = (T - W) % W
                cache = {n: torch.roll(c, shift, dims=1) for n, c in cache.items()}
        return self._ffn(x + a, p, kind)[0], cache

    def _block_decode(self, x, p, kind: str, cache, position):
        h = rmsnorm(x, p["ln1"], self.cfg.norm_eps)
        if kind in XLSTM:
            step = xlstm_mod.mlstm_block_step if kind == "mlstm" else xlstm_mod.slstm_block_step
            a, new = step(h, p["core"], self.cfg, cache)
            _write(cache, new)
            return x + a
        if kind == "rglru":
            a, new = rglru_mod.rglru_block_step(h, p["core"], self.cfg, cache)
            _write(cache, new)
        elif self._mla(kind):   # the new latent row is written into the cache in place
            a, _ = attn.mla_decode_step(h, p["attn"], self.cfg, cache, position)
        else:       # the new K/V row is written into the cache in place
            a, _ = attn.gqa_decode_step(h, p["attn"], self.cfg, cache, position,
                                        window=self._window(kind))
        return self._ffn(x + a, p, kind, decode=True)[0]

    # ------------------------------------------------------------------
    # embedding and head
    # ------------------------------------------------------------------
    def _embed(self, params, batch) -> torch.Tensor:
        """Token embeddings (with a vision model's projected image tokens
        first, where the batch has ``image_embeds``), or an audio model's
        frames (B, T, d_model) through its frontend."""
        cfg, cdt = self.cfg, self.compute_dtype
        if cfg.modality == "audio":
            x = batch["frames"].to(cdt) @ params["frontend_proj"].to(cdt)
            if "mask" in batch:     # masked prediction: masked frames replaced before the conv
                x = torch.where(batch["mask"][..., None].to(x.device),
                                params["mask_embed"].to(cdt), x)
            # conv positional embedding: kernel 128, depthwise, padded
            # (64, 63), a cross-correlation as the reference's
            w = params["conv_pos"]["w"].to(cdt)                       # (K, d)
            K = w.shape[0]
            xp = torch.nn.functional.pad(x.transpose(1, 2), (K // 2, K - 1 - K // 2))
            pos = torch.nn.functional.conv1d(xp, w.T[:, None, :], groups=cfg.d_model)
            pos = pos.transpose(1, 2) + params["conv_pos"]["b"].to(cdt)
            return x + torch.nn.functional.gelu(pos, approximate="tanh")
        # row gather first, then the cast: the same values as the
        # reference's cast-then-gather, without casting the whole table
        x = params["embed"][batch["tokens"]].to(cdt)
        if cfg.modality == "vision_text" and "image_embeds" in batch:
            pj = params["projector"]
            img = batch["image_embeds"].to(cdt) @ pj["w1"].to(cdt)
            img = torch.nn.functional.gelu(img, approximate="tanh") @ pj["w2"].to(cdt)
            x = torch.cat([img, x], dim=1)                           # image tokens first
        return x

    def _head(self, params, x) -> torch.Tensor:
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].to(x.dtype).T
        return x @ params["lm_head"].to(x.dtype)

    # ------------------------------------------------------------------
    # full-sequence forward
    # ------------------------------------------------------------------
    def _blocks_forward(self, x, aux, blocks, kinds):
        for p, kind in zip(blocks, kinds):
            x, a = self._block_forward(x, p, kind)
            if a is not None:
                aux = aux + a
        return x, aux

    def forward_hidden(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The last hidden states and the sum of the MoE aux losses."""
        cfg = self.cfg
        x = self._embed(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self.remat and torch.is_grad_enabled()
        for tile in self._tiles(params):
            if remat:
                x, aux = checkpoint(self._blocks_forward, x, aux, tile, cfg.block_pattern,
                                    use_reentrant=False)
            else:
                x, aux = self._blocks_forward(x, aux, tile, cfg.block_pattern)
        if self.n_tail:
            x, aux = self._blocks_forward(x, aux, params["tail"], self.tail_kinds)
        return x, aux

    def forward_logits(self, params, batch) -> torch.Tensor:
        x, _ = self.forward_hidden(params, batch)
        return self._head(params, x)

    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        """Mean next-token cross-entropy over ``batch["labels"]`` (masked by
        ``batch["mask"]`` where given: an encoder's masked frames), plus
        0.01 x the MoE aux loss; a vision model's image positions carry no
        loss. Returns (loss, {"ce", "aux", "loss"})."""
        cfg = self.cfg
        x, aux = self.forward_hidden(params, batch)
        if cfg.modality == "vision_text":
            x = x[:, -batch["tokens"].shape[1]:, :]      # image positions carry no loss
        logits = self._head(params, x)
        ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
        loss = ce + (0.01 if cfg.moe else 0.0) * aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}

    forward = forward_logits

    # ------------------------------------------------------------------
    # serving: cache init / prefill / decode
    # ------------------------------------------------------------------
    def _cache_one(self, kind: str, batch: int, cache_len: int, dev, lead: tuple = ()):
        cfg, cdt = self.cfg, self.compute_dtype
        if kind == "mlstm":
            return xlstm_mod.mlstm_state_init(batch, cfg, cdt, dev, lead)
        if kind == "slstm":
            return xlstm_mod.slstm_state_init(batch, cfg, dev, lead)
        if self._mla(kind):
            return {"c_kv": torch.zeros(lead + (batch, cache_len, cfg.kv_lora_rank), dtype=cdt,
                                        device=dev),
                    "k_rope": torch.zeros(lead + (batch, cache_len, cfg.qk_rope_head_dim),
                                          dtype=cdt, device=dev)}
        if kind == "rglru":
            return {"h": torch.zeros(lead + (batch, cfg.lru_width), dtype=torch.float32,
                                     device=dev),
                    "conv": torch.zeros(lead + (batch, cfg.conv1d_size - 1, cfg.lru_width),
                                        dtype=cdt, device=dev)}
        S = min(cache_len, cfg.window) if kind == "local" else cache_len
        shape = lead + (batch, S, cfg.n_kv_heads, cfg.head_dim)
        return {n: torch.zeros(shape, dtype=cdt, device=dev) for n in ("k", "v")}

    def init_cache(self, batch: int, cache_len: int, *, device: DeviceLike = None):
        """Zeroed caches on ``device`` (None: the card): attention K/V in
        ``compute_dtype`` (a local block's holds ``min(cache_len, window)``
        rows; MLA's the latent ``c_kv`` and ``k_rope``), an RG-LRU block's
        f32 state ``h`` and its conv inputs, the xLSTM blocks' f32 states
        (their stabilizers ``m`` at -1e30) and the mLSTM's conv inputs."""
        return self._caches(batch, cache_len, resolve_device(device))

    def cache_specs(self, batch: int, cache_len: int):
        """The tree of :meth:`init_cache` as tensors on the ``meta`` device:
        the same keys, shapes and dtypes, nothing allocated."""
        return self._caches(batch, cache_len, torch.device("meta"))

    def _caches(self, batch: int, cache_len: int, dev: torch.device):
        caches = {}
        if self.n_tiles > 0:
            caches["blocks"] = {f"g{g}": self._cache_one(kind, batch, cache_len, dev,
                                                         (self.n_tiles,))
                                for g, kind in enumerate(self.cfg.block_pattern)}
        if self.n_tail:
            caches["tail"] = [self._cache_one(kind, batch, cache_len, dev)
                              for kind in self.tail_kinds]
        return caches

    def prefill(self, params, batch, cache_len: int):
        """Logits of the last token (B, 1, V) and the caches: attention K/V
        in k's dtype padded to ``cache_len`` (a local block's ring buffer
        aligned for decode; MLA's latent), recurrent states. A vision
        model's image tokens come first, so its decode positions start
        at ``n_image_tokens + len(tokens)``."""
        x = self._embed(params, batch)
        per_layer = []
        for kind, p in self._layers(params):
            x, c = self._block_prefill(x, p, kind, cache_len)
            per_layer.append(c)
        return self._head(params, x[:, -1:, :]), self._collect(per_layer)

    def decode_step(self, params, tokens, caches, position):
        """tokens: (B, 1) int; position: (B,). The caches are updated in
        place and returned."""
        if self.cfg.modality == "audio":
            raise ValueError("encoder-only arch has no decode step")
        x = params["embed"][tokens].to(self.compute_dtype)
        for (kind, p), (_, c) in zip(self._layers(params), self._layers(caches)):
            x = self._block_decode(x, p, kind, c, position)
        return self._head(params, x), caches


def make_model(cfg, **kw) -> TransformerLM:
    return TransformerLM(cfg, **kw)
