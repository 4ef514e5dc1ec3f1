"""Per-architecture KV/state cache geometry.

Maps an :class:`ArchConfig` to the byte layout of its shareable cache
objects:

* ``paged_kv``: full/local attention — per-token K+V across attention
  layers (local layers bounded by their window);
* ``latent``: MLA — per-token compressed latent (c_kv + k_rope); ~9x
  smaller than the MHA-equivalent, which proportionally raises how many
  shared objects fit in B (noted in DESIGN.md §4);
* ``state``: RG-LRU / xLSTM — fixed-size prefix state snapshots (the
  shareable object is a snapshot every ``snapshot_stride`` tokens, not
  per-token KV).
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs import ArchConfig


@dataclass(frozen=True)
class KVLayout:
    arch: str
    kind: str              # paged_kv | latent | state
    bytes_per_token: int   # 0 for state archs
    block_tokens: int
    bytes_per_block: int
    state_bytes: int       # snapshot bytes for state archs (else 0)


def _count(cfg: ArchConfig, kind: str) -> int:
    return sum(
        1
        for li in range(cfg.n_layers)
        if cfg.block_pattern[li % len(cfg.block_pattern)] == kind
    )


def layout_for(
    cfg: ArchConfig, *, dtype_bytes: int = 2, block_tokens: int = 16
) -> KVLayout:
    n_attn = _count(cfg, "attn")
    n_local = _count(cfg, "local")
    n_rglru = _count(cfg, "rglru")
    n_mlstm = _count(cfg, "mlstm")
    n_slstm = _count(cfg, "slstm")

    if cfg.attention == "mla":
        per_tok = n_attn * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * dtype_bytes
        return KVLayout(cfg.name, "latent", per_tok, block_tokens,
                        per_tok * block_tokens, 0)

    if n_rglru or n_mlstm or n_slstm:
        state = 0
        state += n_rglru * cfg.lru_width * (4 + (cfg.conv1d_size - 1) * dtype_bytes)
        if n_mlstm:
            up = 2 * cfg.d_model
            dh = up // cfg.n_heads
            state += n_mlstm * cfg.n_heads * (dh * dh + dh + 1) * 4
        if n_slstm:
            state += n_slstm * 4 * cfg.d_model * 4
        # local-attention window KV also belongs to a snapshot
        state += n_local * min(cfg.window, 2048) * cfg.n_kv_heads * cfg.head_dim * 2 * dtype_bytes
        return KVLayout(cfg.name, "state", 0, block_tokens, 0, state)

    per_tok = (n_attn + n_local) * 2 * cfg.n_kv_heads * cfg.head_dim * dtype_bytes
    return KVLayout(cfg.name, "paged_kv", per_tok, block_tokens,
                    per_tok * block_tokens, 0)
