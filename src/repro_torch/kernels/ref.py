"""Plain PyTorch oracles for the attention kernels, with the layouts and
f32 upcasts of the reference package's ``repro.kernels.ref``.

They keep the oracles' own semantics, edges included: a sequence or
prefix with no valid position sees every masked score equal (-1e30), so
its softmax is uniform and its output is the mean of the gathered V. The
kernels do not do that (they return zeros, and lse = -1e30); the plain
paths in :mod:`repro_torch.kernels.paged_attention` and
:mod:`repro_torch.kernels.shared_prefix_attention` apply that rule on top
of these oracles.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def reference_attention(
    q: torch.Tensor,   # (B, T, H, D)
    k: torch.Tensor,   # (B, S, KV, D)
    v: torch.Tensor,   # (B, S, KV, Dv)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
    kv_valid_len: Optional[torch.Tensor] = None,   # (B,)
    return_lse: bool = False,
    window: int = 0,
):
    """Dense masked softmax attention with GQA broadcast; with
    ``return_lse``, (out, the rows' logsumexp (B, T, H) in f32). A
    ``window`` > 0 keeps only the keys s > t - window (the reference's
    ``_chunk_bias``)."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, T, KV, G, D) * sm_scale
    s = torch.einsum("btkgd,bskd->btkgs", qf, k.float())
    mask = torch.ones((B, T, S), dtype=torch.bool, device=q.device)
    pos = torch.arange(S, device=q.device)
    t_pos = torch.arange(T, device=q.device)[None, :, None]
    if causal:
        mask &= pos[None, None, :] <= t_pos
    if window > 0:
        mask &= pos[None, None, :] > t_pos - window
    if kv_valid_len is not None:
        mask &= pos[None, None, :] < kv_valid_len.to(q.device)[:, None, None]
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("btkgs,bskv->btkgv", p, v.float())
    out = out.reshape(B, T, H, -1).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, T, H)
    return out


def reference_attention_with_lse(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    *, sm_scale: Optional[float] = None,
    kv_valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-causal attention returning (out, logsumexp) in f32 — the merge
    primitive for shared-prefix attention. lse: (B, T, H)."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, T, KV, G, D) * sm_scale
    s = torch.einsum("btkgd,bskd->btkgs", qf, k.float())
    if kv_valid_len is not None:
        mask = torch.arange(S, device=q.device)[None, :] < kv_valid_len.to(q.device)[:, None]
        s = torch.where(mask[:, None, None, None, :], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                   # (B,T,KV,G)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("btkgs,bskv->btkgv", p, v.float())
    return out.reshape(B, T, H, -1), lse.reshape(B, T, H)


def lse_merge(
    out_a: torch.Tensor, lse_a: torch.Tensor,
    out_b: torch.Tensor, lse_b: torch.Tensor,
) -> torch.Tensor:
    """Merge two attention partials over disjoint KV sets."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)[..., None]
    wb = torch.exp(lse_b - m)[..., None]
    return (out_a * wa + out_b * wb) / (wa + wb)


def reference_paged_attention(
    q: torch.Tensor,            # (B, H, D)
    k_pages: torch.Tensor,      # (KV, P, page, D)
    v_pages: torch.Tensor,      # (KV, P, page, D)
    block_tables: torch.Tensor, # (B, pages_per_seq) int32
    context_lens: torch.Tensor, # (B,) int32
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention over a paged physical KV pool (the device-side
    "shared cache"): each sequence reads its logical pages through its
    block table; physical pages may be shared across sequences."""
    B, H, D = q.shape
    KV, P, page, _ = k_pages.shape
    pages_per_seq = block_tables.shape[1]
    S = pages_per_seq * page
    idx = block_tables.long()
    # gather logical KV: (KV, B, pps, page, D) -> (B, KV, S, D)
    k = k_pages[:, idx].movedim(0, 1).reshape(B, KV, S, D)
    v = v_pages[:, idx].movedim(0, 1).reshape(B, KV, S, D)
    out = reference_attention(
        q[:, None],                        # (B, 1, H, D)
        k.movedim(1, 2),                   # (B, S, KV, D)
        v.movedim(1, 2),
        causal=False,
        sm_scale=sm_scale,
        kv_valid_len=context_lens,
    )
    return out[:, 0]


def reference_shared_prefix_attention(
    q: torch.Tensor,            # (P, M, H, D) queries grouped by prefix
    prefix_k: torch.Tensor,     # (P, S, KV, D) one physical copy per prefix
    prefix_v: torch.Tensor,     # (P, S, KV, D)
    prefix_lens: torch.Tensor,  # (P,) valid length of each prefix
    *,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped shared-prefix attention (the paper's object sharing at the
    kernel level): all M queries of a group attend the group's single
    physical prefix KV. Returns (out (P,M,H,Dv), lse (P,M,H)) for LSE
    merging with per-request suffix attention."""
    return reference_attention_with_lse(
        q, prefix_k, prefix_v, sm_scale=sm_scale, kv_valid_len=prefix_lens
    )
