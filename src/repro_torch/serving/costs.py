"""Serving cost layer: closed-form FLOP/byte pricing for prefix caching.

Two halves:

* the analytic **cell cost model** (absorbed from the former
  ``repro_torch.roofline`` seed module): FLOPs/bytes for every (arch x shape)
  cell, validated against XLA cost_analysis on unrolled reduced configs
  by ``tests/test_costmodel.py``;
* the **serving pricing** built on it: per-prompt-token prefill FLOPs
  and a roofline latency proxy (compute vs HBM terms on the TPU v5e
  hardware model), used by the scenario layer to translate prefix-block
  hit counters into FLOPs-saved / latency numbers in
  ``Report.extras["serving"]``.

Why analytic: XLA's HloCostAnalysis counts a while-loop body ONCE
regardless of trip count, so any scan-based model (layers, attention
chunks, sLSTM time steps) under-reports by orders of magnitude. This
module models exactly what the implementation executes — including its
known inefficiencies (full T x S causal attention without block skipping,
capacity-factor MoE overcompute), because the roofline must price the
*implementation*, not the ideal.

Conventions: matmul (m,k)x(k,n) = 2mkn FLOPs; backward = 2x forward
(dgrad+wgrad); remat(dots policy) adds only elementwise recompute
(ignored); optimizer ~20 FLOPs/param. All numbers are GLOBAL; divide by
chip count for per-device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.configs import ArchConfig, ShapeConfig

# Hardware model (TPU v5e, per chip).
PEAK_FLOPS = 197e12       # bf16 / chip
HBM_BW = 819e9            # bytes/s / chip
ICI_BW = 50e9             # bytes/s / link


@dataclass
class CellCost:
    flops_fwd: float           # forward pass, global
    flops_total: float         # fwd (+bwd+opt for train), global
    hbm_bytes_min: float       # lower-bound HBM traffic (params + cache + IO)
    model_flops: float         # 6*N_active*D (train) / 2*N_active*D (infer)
    breakdown: Dict[str, float]


def _attn_flops(B, Tq, S, H, hd, hd_v=None, causal_fold=False) -> float:
    """score qk + weighted pv.

    The XLA reference path computes the full Tq x S score matrix and
    masks (causal_fold=False). The Pallas flash kernel skips
    fully-masked tiles, halving causal self-attention compute
    (causal_fold=True) — used for the kernel-path §Perf variant."""
    hd_v = hd if hd_v is None else hd_v
    s_eff = S / 2.0 if (causal_fold and Tq == S) else S
    return 2.0 * B * H * Tq * s_eff * hd + 2.0 * B * H * Tq * s_eff * hd_v


def _block_flops(
    cfg: ArchConfig, kind: str, B, Tq, S, decode: bool,
    causal_fold: bool = False,
) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    f = 0.0
    if kind in ("attn", "local"):
        if cfg.attention == "mla" and kind == "attn":
            R, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_head_dim,
                             cfg.qk_nope_head_dim, cfg.v_head_dim)
            H = cfg.n_heads
            qlr = cfg.q_lora_rank
            f += 2.0 * B * Tq * d * qlr + 2.0 * B * Tq * qlr * H * (dn + dr)
            f += 2.0 * B * Tq * d * (R + dr)
            if decode:
                # absorbed: q_lat absorb + latent attention + out absorb
                f += 2.0 * B * H * dn * R
                f += _attn_flops(B, Tq, S, H, R + dr, R)
                f += 2.0 * B * H * R * dv
            else:
                f += 2.0 * B * Tq * R * H * dn + 2.0 * B * Tq * R * H * dv
                f += _attn_flops(B, Tq, S, H, dn + dr, dv,
                                 causal_fold=causal_fold)
            f += 2.0 * B * Tq * H * dv * d
        else:
            H, KV = cfg.n_heads, cfg.n_kv_heads
            S_eff = min(S, cfg.window) if (kind == "local" and decode) else S
            f += 2.0 * B * Tq * d * (2 * H + 2 * KV) * hd
            f += _attn_flops(
                B, Tq, S_eff, H, hd,
                causal_fold=causal_fold and not cfg.is_encoder,
            )
        # FFN
        if cfg.moe and kind == "attn":
            E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
            slots = B * Tq if decode else B * Tq * k * cf  # decode: no_drop C=N
            if decode:
                slots = B * Tq * k  # k experts per token, exact
            f += 2.0 * B * Tq * d * E  # router
            f += 6.0 * slots * d * cfg.moe_d_ff
            if cfg.n_shared_experts:
                f += 6.0 * B * Tq * d * cfg.moe_d_ff * cfg.n_shared_experts
        else:
            f += 6.0 * B * Tq * d * cfg.d_ff
    elif kind == "rglru":
        W = cfg.lru_width
        f += 2.0 * B * Tq * d * W * 2            # wx, wgate
        f += 2.0 * B * Tq * cfg.conv1d_size * W  # conv
        f += 2.0 * B * Tq * W * W * 2            # input/rec gates
        f += 10.0 * B * Tq * W                   # scan elementwise
        f += 2.0 * B * Tq * W * d                # w_out
        f += 6.0 * B * Tq * d * cfg.d_ff
    elif kind == "mlstm":
        up = 2 * d
        H = cfg.n_heads
        dh = up // H
        c = min(256, Tq) if Tq > 1 else 1
        f += 2.0 * B * Tq * d * up * 2           # w_up, w_gate_up
        f += 2.0 * B * Tq * 4 * up               # conv
        f += 2.0 * B * Tq * up * up * 3          # q, k, v
        f += 2.0 * B * Tq * up * 2 * H           # gates
        if Tq > 1:
            f += 4.0 * B * H * Tq * c * dh       # intra-chunk qk+pv
            f += 6.0 * B * H * Tq * dh * dh      # state read + C update + n
        else:
            f += 6.0 * B * H * dh * dh           # recurrent step
        f += 2.0 * B * Tq * up * d               # w_down
    elif kind == "slstm":
        H = cfg.n_heads
        dh = d // H
        ff = int(round(d * 4 / 3 / 64)) * 64 or 64
        f += 2.0 * B * Tq * d * 4 * d            # w_in
        f += 8.0 * B * Tq * H * dh * dh          # 4 block-diag recurrences
        f += 6.0 * B * Tq * d * ff               # GLU FFN
    return f


def cell_costs(
    cfg: ArchConfig, shape: ShapeConfig, remat: str = "full",
    causal_fold: bool = False,
) -> CellCost:
    B = shape.global_batch
    decode = shape.kind == "decode"
    Tq = 1 if decode else shape.seq_len
    S = shape.seq_len
    if cfg.modality == "vision_text" and not decode:
        Tq = S  # image tokens + text tokens fill the assigned seq_len

    per_kind: Dict[str, float] = {}
    fwd = 0.0
    for li in range(cfg.n_layers):
        kind = cfg.block_pattern[li % len(cfg.block_pattern)]
        fl = _block_flops(cfg, kind, B, Tq, S, decode, causal_fold)
        per_kind[kind] = per_kind.get(kind, 0.0) + fl
        fwd += fl

    # embedding/frontends + head + loss
    d, V = cfg.d_model, cfg.vocab_size
    if cfg.modality == "audio":
        fwd += 2.0 * B * Tq * d * d + 2.0 * B * Tq * 128 * d
    if cfg.modality == "vision_text":
        n_img = cfg.n_image_tokens
        fwd += 2.0 * B * n_img * (cfg.vision_dim * d + d * d)
    head_T = 1 if (decode or shape.kind == "prefill") else Tq
    if shape.kind == "prefill" and cfg.is_encoder:
        head_T = Tq
    fwd += 2.0 * B * head_T * d * V
    per_kind["head"] = 2.0 * B * head_T * d * V
    if shape.kind == "train":
        fwd += 4.0 * B * Tq * V  # CE/logsumexp elementwise

    n_active = cfg.n_active_params
    if shape.kind == "train":
        # bwd = 2x fwd; 'full' remat recomputes the forward once more.
        mult = 4.0 if remat == "full" else 3.0
        total = mult * fwd + 20.0 * cfg.n_params
        model = 6.0 * n_active * B * shape.seq_len
    elif shape.kind == "prefill":
        total = fwd
        model = 2.0 * n_active * B * shape.seq_len
    else:
        total = fwd
        model = 2.0 * n_active * B

    # HBM traffic lower bound (per step, global):
    #   params read once (bf16) [+ grads written + opt states r/w for train]
    #   decode: full KV cache read + 1-token write
    bytes_min = 2.0 * cfg.n_params
    if shape.kind == "train":
        bytes_min = (4.0 + 4.0 + 16.0 + 2.0) * cfg.n_params  # p, g, mu/nu, bf16
        bytes_min += 2.0 * B * Tq * d * 2 * cfg.n_layers     # act checkpoints
    if decode:
        bytes_min += _kv_cache_bytes(cfg, B, S)
    return CellCost(
        flops_fwd=fwd,
        flops_total=total,
        hbm_bytes_min=bytes_min,
        model_flops=model,
        breakdown=per_kind,
    )


def _kv_cache_bytes(cfg: ArchConfig, B: int, S: int) -> float:
    total = 0.0
    for li in range(cfg.n_layers):
        kind = cfg.block_pattern[li % len(cfg.block_pattern)]
        if kind == "attn" and cfg.attention == "mla":
            total += B * S * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
        elif kind == "attn":
            total += B * S * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        elif kind == "local":
            total += B * min(S, cfg.window) * cfg.n_kv_heads * cfg.head_dim * 2 * 2
        elif kind == "rglru":
            total += B * cfg.lru_width * (4 + 2 * (cfg.conv1d_size - 1))
        elif kind == "mlstm":
            up = 2 * cfg.d_model
            dh = up // cfg.n_heads
            total += B * cfg.n_heads * (dh * dh + dh + 1) * 4
        elif kind == "slstm":
            total += B * cfg.d_model * 4 * 4
    return total


# ---------------------------------------------------------------------------
# Serving pricing: translate prefix-block hit counters into FLOPs saved
# and a prefill-latency proxy.

def prefill_flops_per_token(cfg: ArchConfig) -> float:
    """MODEL_FLOPS prefill pricing: 2 FLOPs per active param per token.

    This is the marginal compute a cached prefix token skips; the cell
    model above prices whole (arch x shape) steps, this prices the
    per-token delta the serving report needs."""
    return 2.0 * cfg.n_active_params


@dataclass(frozen=True)
class ServingCostModel:
    """Per-prompt-token pricing for the serving report.

    ``prefill_time_s`` is a single-chip roofline latency proxy: prefill
    of ``t`` uncached tokens costs ``max(compute, HBM)`` seconds with
    the compute term ``t * flops_per_token / peak_flops`` and the memory
    term ``t * kv_bytes_per_token / hbm_bw`` (KV write traffic). With
    ``unit()`` pricing (no arch bound), "time" is simply the token
    count, so latency proxies stay meaningful but unitless.
    """

    flops_per_token: float
    kv_bytes_per_token: float = 0.0
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW

    @classmethod
    def for_arch(cls, cfg: ArchConfig, bytes_per_token: float = 0.0
                 ) -> "ServingCostModel":
        return cls(
            flops_per_token=prefill_flops_per_token(cfg),
            kv_bytes_per_token=float(bytes_per_token),
        )

    @classmethod
    def unit(cls) -> "ServingCostModel":
        return cls(flops_per_token=1.0, kv_bytes_per_token=0.0,
                   peak_flops=1.0, hbm_bw=1.0)

    def prefill_flops(self, tokens: float) -> float:
        return float(tokens) * self.flops_per_token

    def prefill_time_s(self, tokens: float) -> float:
        t = float(tokens)
        return max(t * self.flops_per_token / self.peak_flops,
                   t * self.kv_bytes_per_token / self.hbm_bw)
