"""The yardstick: the card's published peaks, the least time a piece of
work can take on it, and the work of a K3 launch or K3-bwd call of
grouped-query attention at one head width, counted from its shapes. A
model's own work (its parameters, a step's or a prefill's FLOPs, its
attention's widths) is its architecture module's (:mod:`chipbench.archs`).

Frozen copies, so that a change to the program cannot move them:
``HBM_BYTES_PER_S``, ``PEAK_FLOPS``, :func:`bound_ms` and
:func:`attended_pairs` come from ``chip_smoke.py`` (its constants and
``bound_ms`` / ``attended_pairs``). The model FLOPs are the architecture
modules' own arithmetic, not ``repro_torch.serving.costs`` (which prices
the program's own overcompute).
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet: HBM rate, dense peaks (f32 outside the
# tensor cores, bf16 on them), at the card's full 700 W.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_ms(n_bytes: float, flops: float, dtype: str = "bfloat16") -> tuple:
    """The least ms the work can take: bytes at the HBM rate or operations
    at the peak, whichever is longer, and which of the two it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attended_pairs(T: int, S: int, causal: bool, window: int = 0) -> int:
    """The (t, s) pairs of one head that the mask keeps: s < S, s <= t when
    causal, s > t - window when window > 0 (T = 4096 at window 2048:
    6,292,480 of the causal 8,390,656)."""
    t = np.arange(T)
    lo = np.maximum(t - window + 1, 0) if window > 0 else np.zeros(T, dtype=np.int64)
    hi = np.minimum(t, S - 1) if causal else np.full(T, S - 1)
    return int(np.maximum(hi - lo + 1, 0).sum())


def k3_work(B: int, T: int, H: int, KV: int, D: int, *, lse: bool, elem: int = 2) -> tuple:
    """(bytes, flops) of one causal K3 launch at true widths: q, k, v read
    once, the output (and the f32 lse) written once; QK^T and PV, 2 D
    operations each a pair and head."""
    pairs = attended_pairs(T, T, True)
    n_bytes = elem * (2 * B * T * H * D + 2 * B * T * KV * D) + (4 * B * H * T if lse else 0)
    return n_bytes, 4.0 * B * H * pairs * D


def k3bwd_work(B: int, T: int, H: int, KV: int, D: int, elem: int = 2) -> tuple:
    """(bytes, flops) of one causal K3-bwd call (its three kernels): q, k,
    v, out, dout and the f32 lse read once, dq, dk, dv written once; five
    products of the attended pairs (S, dP, dV, dQ, dK), 2 D operations each."""
    pairs = attended_pairs(T, T, True)
    n_bytes = elem * (5 * B * T * H * D + 4 * B * T * KV * D) + 4 * B * H * T
    return n_bytes, 10.0 * B * H * pairs * D
