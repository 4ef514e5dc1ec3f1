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
``dense`` (the port's own), the ``cfg.first_k_dense`` leading layers
(global attention with a dense SwiGLU of ``d_ff`` ahead of an MoE
model's expert layers, as deepseek-v2's first), stacked with a leading
axis, each its own remat tile; ``blocks["g0".."g{G-1}"]``, one entry per
kind of ``cfg.block_pattern``, stacked with a leading ``n_tiles`` axis
over the layers after them; ``tail``, a list of the blocks left over
(the pattern's first kinds); ``final_norm`` and, untied,
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

The attention caches (K/V, MLA's latent) may be held split over a mesh,
as the reference places them for flash-decoding: under the ``shardctx``
rule ``"cache_split"`` (a ``launch.flash_decode.SplitCaches``, which
knows the placement and gives each layer its
:class:`~repro_torch.models.attention.CacheBlock`), ``init_cache`` and
``prefill`` allocate and write only this rank's block, and
``decode_step`` reads caches held split (DTensors) through the
flash-decode override only. Parameters placed on the mesh (DTensors) serve
under the same rule, made with them: where they partition GQA over
``model`` (Megatron's column/row split), each rank computes its own heads
and holds its own KV heads of the cache, read with no merge; partitioned
MLA reads its latent cache held whole on every rank, as MQA (one KV
head: recurrentgemma's local blocks) its K and V; a partitioned RG-LRU
layer computes and holds its channels of the state, a partitioned xLSTM
block its heads of it; partitioned MoE
experts (split on their expert dim or on their columns) serve in prefill
and in the drop-free decode alike; an embedding and head split on their
vocabulary look each token up on the rank that owns it (one all-reduce)
and return the whole logits (one all-gather of the last position's
blocks), a prefill or a step.

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
    embed_lookup,
    mlp_apply,
    mlp_init,
    model_parallel,
    rmsnorm,
    rmsnorm_init,
    softmax_cross_entropy,
    vocab_parallel_cross_entropy,
)

KINDS = ("attn", "local", "rglru", "mlstm", "slstm")
DENSE = "dense"                     # a leading global-attention layer with a dense SwiGLU
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
        self.n_dense = cfg.first_k_dense
        self.n_tiles = (cfg.n_layers - self.n_dense) // G
        self.n_tail = (cfg.n_layers - self.n_dense) % G
        self.tail_kinds = cfg.block_pattern[: self.n_tail]

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _mla(self, kind: str) -> bool:
        return self.cfg.attention == "mla" and kind in ("attn", DENSE)

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
        if self.n_dense:
            params[DENSE] = self._block_init(gen, dev, DENSE, (self.n_dense,))
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

    def _dense(self, tree) -> list:
        """The leading dense layers' subtrees of ``tree`` (views)."""
        return _unstack(tree[DENSE], self.n_dense) if self.n_dense else []

    def _layers(self, tree) -> Iterator[Tuple[str, object]]:
        """(kind, layer's subtree) of ``tree`` in the order the layers run:
        the leading dense layers, tile by tile, then the tail."""
        for p in self._dense(tree):
            yield DENSE, p
        for tile in self._tiles(tree):
            yield from zip(self.cfg.block_pattern, tile)
        for i, kind in enumerate(self.tail_kinds):
            yield kind, tree["tail"][i]

    def _collect(self, per_layer):
        """Per-layer trees in :meth:`_layers` order, as the reference's
        ``blocks`` (stacked over tiles) and ``tail``."""
        out, G, K = {}, len(self.cfg.block_pattern), self.n_dense
        if K:
            out[DENSE] = _stack(per_layer[:K])
        if self.n_tiles > 0:
            out["blocks"] = {f"g{g}": _stack(per_layer[K + g:K + self.n_tiles * G:G])
                             for g in range(G)}
        if self.n_tail:
            out["tail"] = list(per_layer[K + self.n_tiles * G:])
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
        return x + mlp_apply(h2, p["ffn"], model_parallel("mlp")), None

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

    def _block_prefill(self, x, p, kind: str, cache_len: int, block=None):
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
        if block is not None:   # this rank's block of the cache held split
            cache = {n: c[block.row:block.row + block.rows,
                          block.slot:block.slot + block.slots].clone() for n, c in cache.items()}
        return self._ffn(x + a, p, kind)[0], cache

    def _block_decode(self, x, p, kind: str, cache, position, block=None, writes=None):
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
            a, _ = attn.mla_decode_step(h, p["attn"], self.cfg, cache, position, block=block,
                                        writes=writes)
        else:       # the new K/V row is written into the cache in place
            a, _ = attn.gqa_decode_step(h, p["attn"], self.cfg, cache, position,
                                        window=self._window(kind), block=block, writes=writes)
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
        x = embed_lookup(params["embed"], batch["tokens"], cdt, model_parallel("vocab"))
        if cfg.modality == "vision_text" and "image_embeds" in batch:
            pj = params["projector"]
            img = batch["image_embeds"].to(cdt) @ pj["w1"].to(cdt)
            img = torch.nn.functional.gelu(img, approximate="tanh") @ pj["w2"].to(cdt)
            x = torch.cat([img, x], dim=1)                           # image tokens first
        return x

    def _head(self, params, x) -> torch.Tensor:
        """The logits of ``x`` after the final norm; with the vocabulary
        split over ``model`` (:func:`model_parallel` of "vocab"), this
        rank's block of them (..., V/m), the gradient of its input summed
        over the ranks (``enter``)."""
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        vp = model_parallel("vocab")
        if vp is not None:
            x = vp.enter(x)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].to(x.dtype).T
        return x @ params["lm_head"].to(x.dtype)

    def _logits(self, params, x) -> torch.Tensor:
        """The whole logits (..., V) of ``x``: with the vocabulary split,
        the ranks' blocks all-gathered over ``model`` (no gradient)."""
        logits = self._head(params, x)
        vp = model_parallel("vocab")
        return logits if vp is None else vp.gather(logits, dim=-1)

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
        tiles = [([p], (DENSE,)) for p in self._dense(params)]
        tiles += [(tile, cfg.block_pattern) for tile in self._tiles(params)]
        for tile, kinds in tiles:
            if remat:
                x, aux = checkpoint(self._blocks_forward, x, aux, tile, kinds,
                                    use_reentrant=False)
            else:
                x, aux = self._blocks_forward(x, aux, tile, kinds)
        if self.n_tail:
            x, aux = self._blocks_forward(x, aux, params["tail"], self.tail_kinds)
        return x, aux

    def forward_logits(self, params, batch) -> torch.Tensor:
        x, _ = self.forward_hidden(params, batch)
        return self._logits(params, x)

    def loss(self, params, batch) -> Tuple[torch.Tensor, dict]:
        """Mean next-token cross-entropy over ``batch["labels"]`` (masked by
        ``batch["mask"]`` where given: an encoder's masked frames), plus
        ``cfg.aux_coef`` (0.01 unless set) x the MoE aux loss; a vision
        model's image positions carry no loss. Returns (loss, {"ce", "aux", "loss"}). With the vocabulary
        split over ``model``, each rank's block of the logits goes to the
        vocabulary-parallel cross-entropy: no rank builds the whole."""
        cfg = self.cfg
        x, aux = self.forward_hidden(params, batch)
        if cfg.modality == "vision_text":
            x = x[:, -batch["tokens"].shape[1]:, :]      # image positions carry no loss
        logits = self._head(params, x)
        vp = model_parallel("vocab")
        if vp is None:
            ce = softmax_cross_entropy(logits, batch["labels"], batch.get("mask"))
        else:
            ce = vocab_parallel_cross_entropy(logits, batch["labels"], vp, batch.get("mask"))
        loss = ce + (cfg.aux_coef if cfg.moe else 0.0) * aux
        return loss, {"ce": ce, "aux": aux, "loss": loss}

    forward = forward_logits

    # ------------------------------------------------------------------
    # serving: cache init / prefill / decode
    # ------------------------------------------------------------------
    def _slots(self, kind: str, cache_len: int) -> int:
        """The slots of a ``kind`` layer's attention cache: a local block's
        ring buffer holds ``min(cache_len, window)``."""
        return min(cache_len, self.cfg.window) if kind == "local" else cache_len

    def _split_block(self, kind: str, batch: int, cache_len: int, split):
        """This rank's block of a ``kind`` layer's attention cache held
        split by ``split`` (the ``"cache_split"`` rule); None without one
        and for a recurrent state."""
        if split is None or not split.slot_split(self, kind):
            return None
        return split.block(batch, self._slots(kind, cache_len), f"a {kind!r} layer's cache")

    def _cache_one(self, kind: str, batch: int, cache_len: int, dev, lead: tuple = (),
                   block=None, kv_heads: int = 0, width: int = 0, heads: int = 0):
        cfg, cdt = self.cfg, self.compute_dtype
        if kind == "mlstm":
            return xlstm_mod.mlstm_state_init(batch, cfg, cdt, dev, lead, heads)
        if kind == "slstm":
            return xlstm_mod.slstm_state_init(batch, cfg, dev, lead, heads)
        if kind == "rglru":
            W = width or cfg.lru_width
            return {"h": torch.zeros(lead + (batch, W), dtype=torch.float32, device=dev),
                    "conv": torch.zeros(lead + (batch, cfg.conv1d_size - 1, W), dtype=cdt,
                                        device=dev)}
        rows, S = ((batch, self._slots(kind, cache_len)) if block is None
                   else (block.rows, block.slots))
        if self._mla(kind):
            return {"c_kv": torch.zeros(lead + (rows, S, cfg.kv_lora_rank), dtype=cdt,
                                        device=dev),
                    "k_rope": torch.zeros(lead + (rows, S, cfg.qk_rope_head_dim), dtype=cdt,
                                          device=dev)}
        shape = lead + (rows, S, kv_heads or cfg.n_kv_heads, cfg.head_dim)
        return {n: torch.zeros(shape, dtype=cdt, device=dev) for n in ("k", "v")}

    def init_cache(self, batch: int, cache_len: int, *, device: DeviceLike = None):
        """Zeroed caches on ``device`` (None: the card): attention K/V in
        ``compute_dtype`` (a local block's holds ``min(cache_len, window)``
        rows; MLA's the latent ``c_kv`` and ``k_rope``), an RG-LRU block's
        f32 state ``h`` and its conv inputs, the xLSTM blocks' f32 states
        (their stabilizers ``m`` at -1e30) and the mLSTM's conv inputs.
        Under the ``"cache_split"`` rule, DTensors of which each rank
        allocates its attention caches' block only (and its channels of a
        partitioned RG-LRU layer's state, its heads of a partitioned xLSTM
        block's)."""
        dev = resolve_device(device)
        split = shardctx.get("cache_split")
        caches = self._caches(batch, cache_len, dev, split)
        return caches if split is None else split.hold(self, caches, batch, cache_len)

    def cache_specs(self, batch: int, cache_len: int):
        """The tree of :meth:`init_cache` as tensors on the ``meta`` device:
        the same keys, shapes and dtypes, nothing allocated."""
        return self._caches(batch, cache_len, torch.device("meta"))

    def _caches(self, batch: int, cache_len: int, dev: torch.device, split=None):
        def one(kind, lead):
            if split is None:
                return self._cache_one(kind, batch, cache_len, dev, lead)
            return self._cache_one(kind, batch, cache_len, dev, lead,
                                   self._split_block(kind, batch, cache_len, split),
                                   split.kv_heads(self, kind), split.lru_width(self, kind),
                                   split.state_heads(self, kind))

        caches = {}
        if self.n_dense:
            caches[DENSE] = one(DENSE, (self.n_dense,))
        if self.n_tiles > 0:
            caches["blocks"] = {f"g{g}": one(kind, (self.n_tiles,))
                                for g, kind in enumerate(self.cfg.block_pattern)}
        if self.n_tail:
            caches["tail"] = [one(kind, ()) for kind in self.tail_kinds]
        return caches

    def prefill(self, params, batch, cache_len: int):
        """Logits of the last token (B, 1, V) and the caches: attention K/V
        in k's dtype padded to ``cache_len`` (a local block's ring buffer
        aligned for decode; MLA's latent), recurrent states. A vision
        model's image tokens come first, so its decode positions start
        at ``n_image_tokens + len(tokens)``. Under the ``"cache_split"``
        rule each layer keeps only this rank's block of its attention
        cache, and the caches come as DTensors."""
        split = shardctx.get("cache_split")
        params, rules = self._serving_params(params, split)
        with shardctx.added(rules):
            x = self._embed(params, batch)
            B = x.shape[0]
            per_layer = []
            for kind, p in self._layers(params):
                x, c = self._block_prefill(x, p, kind, cache_len,
                                           self._split_block(kind, B, cache_len, split))
                per_layer.append(c)
            logits = self._logits(params, x[:, -1:, :])
        caches = self._collect(per_layer)
        if split is not None:
            caches = split.hold(self, caches, B, cache_len)
        return logits, caches

    def _serving_params(self, params, split):
        """The parameters a prefill or decode step computes with, and the
        rules it runs under: placed ones (DTensors) through the
        ``"cache_split"`` rule (``SplitCaches.params``: a partitioned
        leaf's block under ``"model_parallel"``, every other leaf whole)."""
        if split is not None:
            return split.params(self, params)
        if _any_dtensor(params):
            raise ValueError("parameters on a mesh (DTensors) serve under the shardctx rule "
                             "'cache_split' (launch.flash_decode.SplitCaches(mesh, model, "
                             "params))")
        return params, {}

    def decode_step(self, params, tokens, caches, position):
        """tokens: (B, 1) int; position: (B,). The caches are updated in
        place and returned; caches held split (DTensors, under the
        ``"cache_split"`` rule) each rank updates in its own block."""
        if self.cfg.modality == "audio":
            raise ValueError("encoder-only arch has no decode step")
        split = shardctx.get("cache_split")
        params, rules = self._serving_params(params, split)
        if split is not None:
            local, blocks, done = split.local(self, caches, position)
        elif _any_dtensor(caches):
            raise ValueError("caches held on a mesh (DTensors) decode under the shardctx rule "
                             "'cache_split' (launch.flash_decode.SplitCaches)")
        else:
            local, blocks, done = caches, [None] * self.cfg.n_layers, lambda: None
        plans = {}              # a split cache's SlotWrites, one a block and slot rule
        with shardctx.added(rules):
            x = embed_lookup(params["embed"], tokens, self.compute_dtype,
                             model_parallel("vocab"))
            for (kind, p), (_, c), block in zip(self._layers(params), self._layers(local),
                                                blocks):
                writes = None
                if block is not None:
                    window = self._window(kind)
                    writes = plans.get((block, window))
                    if writes is None:
                        pos = position.to(x.device)
                        slot = pos % window if window > 0 else pos
                        writes = plans[block, window] = attn.SlotWrites(block, slot)
                x = self._block_decode(x, p, kind, c, position, block, writes)
            logits = self._logits(params, x)
        done()
        return logits, caches


def _any_dtensor(tree) -> bool:
    from torch.distributed.tensor import DTensor

    if isinstance(tree, dict):
        return any(_any_dtensor(v) for v in tree.values())
    if isinstance(tree, list):
        return any(_any_dtensor(v) for v in tree)
    return isinstance(tree, DTensor)


def make_model(cfg, **kw) -> TransformerLM:
    return TransformerLM(cfg, **kw)
