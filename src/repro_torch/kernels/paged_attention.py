"""K1, paged decode attention: the data plane of the paper's shared
physical cache.

The host-side object-sharing cache manager (``repro_torch.core.shared_lru``
driving ``repro_torch.cacheblocks``) owns *which* KV pages are resident and
*who* is charged for them; this kernel reads a sequence's logical KV
stream through its **block table**. A physical page can appear in many
tables (a shared prefix) and is stored once.

The CUDA kernel is ``csrc/paged_attention.cu`` (its note says what bounds
it and how it is laid out). :func:`paged_attention` launches it for CUDA
tensors and runs :func:`paged_attention_plain` for CPU tensors; it counts
its launches in ``paged_attention.launches``. :func:`launch_plan` reports
how a call of given sizes launches. The kernel takes any G = H / KV.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)       # the D the kernel is instantiated for


def paged_attention_plain(
    q: torch.Tensor,            # (B, H, D)
    k_pages: torch.Tensor,      # (KV, P, page, D)
    v_pages: torch.Tensor,      # (KV, P, page, D)
    block_tables: torch.Tensor, # (B, pages_per_seq) int32
    context_lens: torch.Tensor, # (B,) int32
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version: the oracle, plus the kernel's
    rule that a sequence with ``context_lens <= 0`` gets zeros."""
    out = ref.reference_paged_attention(
        q, k_pages, v_pages, block_tables, context_lens, sm_scale=sm_scale
    )
    empty = (context_lens.to(out.device) <= 0)[:, None, None]
    return out.masked_fill(empty, 0.0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("paged_attention")
    fn = lib.repro_paged_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6                 # q, k, v, tables, lens, out
            + [ctypes.c_int] * 7                  # B, H, KV, D, P, page, pps
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
        )
    return lib


def launch_plan(B: int, H: int, KV: int, D: int, page: int, ctx: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """How a call with these sizes launches, for a table of
    ``ceil(ctx / page)`` slots: the cluster size (splits of a sequence),
    tokens per ring stage, ring stages, dynamic shared memory, threads per
    block, row passes, stages per split, and how many clusters of that
    size the card holds at once. The f32 kernel reports one split, no ring
    and no cluster count. Loads (and if need be builds) the library."""
    fn = _lib().repro_paged_attention_plan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    out = (ctypes.c_int * 8)()
    pps = max(1, -(-int(ctx) // int(page)))
    if not fn(B, H, KV, D, page, pps, _DTYPES[dtype], ctypes.addressof(out)):
        raise ValueError(f"the kernel does not take B={B} H={H} KV={KV} D={D} page={page}")
    keys = ("cluster", "tokens_per_stage", "stages", "smem_bytes", "threads", "passes",
            "stages_per_split", "clusters_at_once")
    return dict(zip(keys, out))


def _check(q, k_pages, v_pages, block_tables, context_lens) -> None:
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("context_lens", context_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("k_pages, v_pages and q must share one dtype")
    if block_tables.dtype != torch.int32 or context_lens.dtype != torch.int32:
        raise TypeError("block_tables and context_lens must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or block_tables.dim() != 2:
        raise ValueError("expected q (B,H,D), pages (KV,P,page,D), tables (B,pps)")
    B, H, D = q.shape
    KV, P, page, Dk = k_pages.shape
    if v_pages.shape != k_pages.shape or Dk != D:
        raise ValueError(f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if block_tables.shape[0] != B or context_lens.shape != (B,):
        raise ValueError("block_tables (B, pps) and context_lens (B,) must match q's batch")
    if H % KV != 0:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes D in {_HEAD_DIMS}; got D={D}")
    if B * H >= 2**28 or H > 65535:
        # CUDA's grid limits: 2^31 - 1 blocks on x (bf16: up to 8 B H), 65535 on y, z (f32)
        raise ValueError(f"the kernel's grid takes B*H < 2^28 and H <= 65535; got B={B} H={H}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("context_lens", context_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.is_floating_point() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Decode attention through block tables: (B, H, D) -> (B, H, D) in
    q's dtype. CUDA tensors launch the kernel (block table entries read,
    those of the first ``ceil(ctx / page)`` slots, must lie in [0, P)), for
    any G = H / KV; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pages, v_pages, block_tables, context_lens, sm_scale=sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k_pages, v_pages, block_tables, context_lens)
    B, H, D = q.shape
    KV, P, page, _ = k_pages.shape
    if B == 0 or block_tables.shape[1] == 0:
        return torch.zeros_like(q)    # no table slot to read: zeros, without a launch
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
            B, H, KV, D, P, page, block_tables.shape[1],
            float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: cudaError {rc}")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
