"""The dense decoder transformer of the reference's model skeleton
(``repro.models.transformer``), for the ``("attn",)`` block pattern
without MoE: qwen3-1.7b, stablelm-1.6b, deepseek-7b and yi-34b.

Functional, as the reference: :meth:`TransformerLM.init` returns a dict
of tensors and every method takes it explicitly, so the serving engine
passes ``model`` and ``params`` as the reference's does. Parameters keep
the reference's tree: ``embed``, ``blocks["g0"]`` stacked with a leading
``n_tiles`` axis (one tile is one layer for this pattern, so there is no
``tail``), ``final_norm`` and, untied, ``lm_head``; weights are
``(in, out)`` for ``x @ W``. :mod:`repro_torch.models.convert` carries
the reference's parameters across. The reference's ``lax.scan`` over
tiles is a loop over layers here.

API:
  init(gen) -> params
  forward_logits(params, batch) -> logits          # full sequence
  init_cache(batch_size, cache_len) -> caches      # zeroed decode cache
  prefill(params, batch, cache_len) -> (last_logits, caches)
  decode_step(params, tokens, caches, position) -> (logits, caches)

Other block kinds, MLA, MoE and the audio/vision frontends raise
``NotImplementedError`` (ROADMAP.md, Queue 1, the models path).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from . import attention as attn
from .layers import Params, dense_init, embed_init, mlp_apply, mlp_init, rmsnorm, rmsnorm_init

_LATER = {   # what the port's models path does not have yet (ROADMAP.md, Queue 1)
    "local": "windowed local attention blocks",
    "rglru": "RG-LRU blocks",
    "mlstm": "xLSTM blocks",
    "slstm": "xLSTM blocks",
}


def _unsupported(cfg) -> str:
    for kind in cfg.block_pattern:
        if kind != "attn":
            return _LATER.get(kind, f"block kind {kind!r}")
    if cfg.moe:
        return "MoE feed-forward"
    if cfg.attention == "mla":
        return "MLA attention"
    if cfg.modality != "text":
        return f"the {cfg.modality} frontend"
    if cfg.is_encoder:
        return "encoder-only models"
    return ""


def _index(tree, i: int):
    """Layer ``i`` of a tree stacked over tiles (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class TransformerLM(nn.Module):
    def __init__(self, cfg, *, param_dtype=torch.float32, compute_dtype=torch.bfloat16) -> None:
        super().__init__()
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError(
                f"{cfg.name}: {missing} are not ported yet (ROADMAP.md, Queue 1, models path)"
            )
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.n_tiles = cfg.n_layers          # pattern ("attn",): one layer per tile

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _block_init(self, gen, device, lead: tuple = ()) -> Params:
        cfg, dt = self.cfg, self.param_dtype
        return {
            "ln1": rmsnorm_init(cfg.d_model, dt, device, lead),
            "attn": attn.gqa_init(gen, cfg, dt, device, lead),
            "ln2": rmsnorm_init(cfg.d_model, dt, device, lead),
            "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, dt, device, lead),
        }

    def init(self, gen: torch.Generator) -> Params:
        """Parameters drawn from ``gen`` on the generator's device, with the
        reference's distributions (not its bits)."""
        cfg, dt, dev = self.cfg, self.param_dtype, gen.device
        params: Params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dt, dev),
            "blocks": {"g0": self._block_init(gen, dev, (self.n_tiles,))},
        }
        params["final_norm"] = rmsnorm_init(cfg.d_model, dt, dev)
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt, dev)
        return params

    def _layers(self, params) -> Iterator[Params]:
        for i in range(self.n_tiles):
            yield _index(params["blocks"]["g0"], i)

    # ------------------------------------------------------------------
    # blocks (pre-norm attention + SwiGLU)
    # ------------------------------------------------------------------
    def _block_forward(self, x, p):
        x = x + attn.gqa_forward(rmsnorm(x, p["ln1"], self.cfg.norm_eps), p["attn"], self.cfg)
        return x + mlp_apply(rmsnorm(x, p["ln2"], self.cfg.norm_eps), p["ffn"])

    def _block_prefill(self, x, p, cache_len: int):
        a, cache = attn.gqa_prefill(rmsnorm(x, p["ln1"], self.cfg.norm_eps), p["attn"],
                                    self.cfg, cache_len)
        x = x + a
        return x + mlp_apply(rmsnorm(x, p["ln2"], self.cfg.norm_eps), p["ffn"]), cache

    def _block_decode(self, x, p, cache, position):
        a, cache = attn.gqa_decode_step(rmsnorm(x, p["ln1"], self.cfg.norm_eps), p["attn"],
                                        self.cfg, cache, position)
        x = x + a
        return x + mlp_apply(rmsnorm(x, p["ln2"], self.cfg.norm_eps), p["ffn"]), cache

    # ------------------------------------------------------------------
    # embedding and head
    # ------------------------------------------------------------------
    def _embed(self, params, batch) -> torch.Tensor:
        # row gather first, then the cast: the same values as the
        # reference's cast-then-gather, without casting the whole table
        return params["embed"][batch["tokens"]].to(self.compute_dtype)

    def _head(self, params, x) -> torch.Tensor:
        x = rmsnorm(x, params["final_norm"], self.cfg.norm_eps)
        if self.cfg.tie_embeddings:
            return x @ params["embed"].to(x.dtype).T
        return x @ params["lm_head"].to(x.dtype)

    # ------------------------------------------------------------------
    # full-sequence forward
    # ------------------------------------------------------------------
    def forward_hidden(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self._embed(params, batch)
        for p in self._layers(params):
            x = self._block_forward(x, p)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)

    def forward_logits(self, params, batch) -> torch.Tensor:
        x, _ = self.forward_hidden(params, batch)
        return self._head(params, x)

    forward = forward_logits

    # ------------------------------------------------------------------
    # serving: cache init / prefill / decode
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, cache_len: int, *, device: DeviceLike = None):
        """Zeroed caches in ``compute_dtype`` on ``device`` (None: the card)."""
        shape = (self.n_tiles, batch, cache_len, self.cfg.n_kv_heads, self.cfg.head_dim)
        dev = resolve_device(device)
        return {"blocks": {"g0": {n: torch.zeros(shape, dtype=self.compute_dtype, device=dev)
                                  for n in ("k", "v")}}}

    def prefill(self, params, batch, cache_len: int):
        """Logits of the last token (B, 1, V) and the caches, in k's dtype,
        padded to ``cache_len``."""
        x = self._embed(params, batch)
        per_layer = []
        for p in self._layers(params):
            x, c = self._block_prefill(x, p, cache_len)
            per_layer.append(c)
        caches = {"blocks": {"g0": {n: torch.stack([c[n] for c in per_layer])
                                    for n in ("k", "v")}}}
        return self._head(params, x[:, -1:, :]), caches

    def decode_step(self, params, tokens, caches, position):
        """tokens: (B, 1) int; position: (B,). The caches are updated in
        place and returned."""
        x = params["embed"][tokens].to(self.compute_dtype)
        for i, p in enumerate(self._layers(params)):
            x, _ = self._block_decode(x, p, _index(caches["blocks"]["g0"], i), position)
        return self._head(params, x), caches


def make_model(cfg, **kw) -> TransformerLM:
    return TransformerLM(cfg, **kw)

