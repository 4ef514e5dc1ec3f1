"""Public entry points of the attention kernels.

Each takes tensors and runs where they lie: CUDA tensors launch the
hand-written kernel (``csrc/``), CPU tensors run its plain PyTorch
version. Nothing else chooses between the two, and a kernel that fails
to build or launch raises.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import ref
from .flash_attention import FlashAttention, kernel_head_dim
from .flash_attention import flash_attention as _flash
from .paged_attention import paged_attention as _paged
from .shared_prefix_attention import shared_prefix_attention as _shared_prefix


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """(B,T,H,Dqk) x (B,S,KV,Dqk) x (B,S,KV,Dv) -> (B,T,H,Dv); FA2 with
    GQA, top-left causal mask, kv tiles past the diagonal skipped; scores
    scaled by ``scale``, by default 1/sqrt(Dqk). A ``window`` > 0 keeps the keys s > t - window
    (the local blocks' attention), kv tiles wholly before it skipped.

    The kernel is built for a few head sizes (``kernel_head_dim``); other
    widths, and Dv != Dqk (MLA: 192 and 128), are padded with zero
    columns to the smallest one that holds both. A zero column adds an
    exact zero to every dot product, and a zero column of V gives a zero
    output column, cut off after: the result is the unpadded function's,
    in one launch.

    When autograd records (grad mode on and an input that requires grad),
    the call goes through :class:`FlashAttention`: K3 also writes its lse,
    and the backward runs K3-bwd. It sits under the padding, so ``F.pad``
    and the slice carry the gradient of the padded widths. Otherwise (every
    serving call) K3 runs without the lse."""
    Dqk, Dv = q.shape[-1], v.shape[-1]
    D = kernel_head_dim(max(Dqk, Dv))
    scale = 1.0 / math.sqrt(Dqk) if scale is None else scale
    if D != Dqk or D != Dv:
        q, k, v = (F.pad(x, (0, D - x.shape[-1])) for x in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        out = FlashAttention.apply(q, k, v, causal, scale, window)
    else:
        out = _flash(q, k, v, causal=causal, sm_scale=scale, window=window)
    return out if out.shape[-1] == Dv else out[..., :Dv]


def paged_attention(q, k_pages, v_pages, block_tables, context_lens) -> torch.Tensor:
    """Decode attention through block tables over the shared physical
    KV pool. (B,H,D) -> (B,H,D)."""
    return _paged(q, k_pages, v_pages, block_tables, context_lens)


def shared_prefix_attention(
    q, prefix_k, prefix_v, prefix_lens, *, block_s: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped attention of all requests sharing a prefix against its one
    physical KV copy. Returns (out, lse) for merging."""
    return _shared_prefix(q, prefix_k, prefix_v, prefix_lens, block_s=block_s)


def shared_prefix_decode(
    q,                 # (P, M, H, D) grouped queries
    prefix_k, prefix_v, prefix_lens,       # shared objects (one copy each)
    suffix_k, suffix_v,                    # (P, M, Ss, KV, D) per-request
    suffix_lens,                           # (P, M)
) -> torch.Tensor:
    """Full object-sharing decode: shared-prefix kernel + per-request
    suffix attention, LSE-merged. The physical prefix KV is read once per
    GROUP (not once per request) — the compute analogue of the paper's
    l_n/|P(n)| apportioning. The suffix attention and the merge are plain
    PyTorch, as in the reference, where they lie outside any kernel."""
    out_a, lse_a = _shared_prefix(q, prefix_k, prefix_v, prefix_lens)
    P, M, H, D = q.shape
    qf = q.reshape(P * M, 1, H, D)
    Ss, KV = suffix_k.shape[2], suffix_k.shape[3]
    out_b, lse_b = ref.reference_attention_with_lse(
        qf,
        suffix_k.reshape(P * M, Ss, KV, D),
        suffix_v.reshape(P * M, Ss, KV, D),
        kv_valid_len=suffix_lens.reshape(P * M),
    )
    out_b = out_b.reshape(P, M, H, D)
    lse_b = lse_b.reshape(P, M, H)
    return ref.lse_merge(out_a.float(), lse_a, out_b, lse_b).to(q.dtype)
