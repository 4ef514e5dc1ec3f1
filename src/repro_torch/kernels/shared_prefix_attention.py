"""K2, shared-prefix ("object sharing") attention.

The paper's core idea at kernel granularity: when requests share a cached
object (a common prompt prefix / RAG chunk / few-shot block), its KV is
stored **once** and is read once per group rather than once per
request. The kernel batches all M queries of a prefix group against the
group's single physical prefix KV and emits (out, logsumexp), so the
caller LSE-merges with per-request suffix attention
(:func:`repro_torch.kernels.ops.shared_prefix_decode`).

The CUDA kernel is ``csrc/shared_prefix_attention.cu`` (its note says
what bounds it and how it is laid out). :func:`shared_prefix_attention`
launches it for CUDA tensors and runs :func:`shared_prefix_attention_plain`
for CPU tensors; it counts its launches in
``shared_prefix_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _build, ref

NEG_INF = ref.NEG_INF
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_KEYS, _MAX_D = 128, 256       # K2_MAX_KEYS and 32 * K2_MAX_COLS in the source


def shared_prefix_attention_plain(
    q: torch.Tensor,            # (P, M, H, D) queries grouped by prefix id
    prefix_k: torch.Tensor,     # (P, S, KV, D) one physical copy per prefix
    prefix_v: torch.Tensor,     # (P, S, KV, D)
    prefix_lens: torch.Tensor,  # (P,) int32
    *,
    sm_scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain PyTorch version: the oracle with out in q's
    dtype, plus the kernel's rule that a prefix with ``prefix_lens <= 0``
    gives out = 0 and lse = -1e30."""
    out, lse = ref.reference_shared_prefix_attention(
        q, prefix_k, prefix_v, prefix_lens, sm_scale=sm_scale
    )
    empty = (prefix_lens.to(out.device) <= 0)[:, None, None]
    return (
        out.to(q.dtype).masked_fill(empty[..., None], 0.0),
        lse.masked_fill(empty, NEG_INF),
    )


def _lib() -> ctypes.CDLL:
    lib = _build.load("shared_prefix_attention")
    fn = lib.repro_shared_prefix_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6                 # q, k, v, lens, out, lse
            + [ctypes.c_int] * 7                  # P, M, H, KV, D, S, block_s
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
        )
    return lib


def launch_plan(P: int, M: int, H: int, KV: int, D: int, S: int,
                block_s: int = 128) -> Optional[dict]:
    """How the bf16 kernel launches at these sizes: the cluster size (the
    chunks S is split into), tiles per chunk, pipeline stages, row passes,
    dynamic shared memory and keys per tile. None where the CUDA-core
    kernel takes the call. Loads (and if need be builds) the library."""
    fn = _lib().repro_shared_prefix_attention_plan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    out = (ctypes.c_int * 6)()
    block_s = max(1, min(int(block_s), S, _MAX_KEYS))
    if not fn(P, M, H, KV, D, S, block_s, ctypes.addressof(out)):
        return None
    keys = ("cluster", "tiles_per_chunk", "stages", "passes", "smem_bytes", "keys_per_tile")
    return dict(zip(keys, out))


def _check(q, prefix_k, prefix_v, prefix_lens) -> None:
    dev = q.device
    for name, t in (("prefix_k", prefix_k), ("prefix_v", prefix_v),
                    ("prefix_lens", prefix_lens)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if prefix_k.dtype != q.dtype or prefix_v.dtype != q.dtype:
        raise TypeError("prefix_k, prefix_v and q must share one dtype")
    if prefix_lens.dtype != torch.int32:
        raise TypeError("prefix_lens must be int32")
    if q.dim() != 4 or prefix_k.dim() != 4:
        raise ValueError("expected q (P,M,H,D) and prefix k/v (P,S,KV,D)")
    P, M, H, D = q.shape
    Pk, S, KV, Dk = prefix_k.shape
    if prefix_v.shape != prefix_k.shape or Pk != P or Dk != D:
        raise ValueError(f"prefix k/v {tuple(prefix_k.shape)} do not fit q {tuple(q.shape)}")
    if prefix_lens.shape != (P,):
        raise ValueError("prefix_lens must be (P,)")
    if H % KV != 0:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if D % 32 != 0 or D > _MAX_D:
        raise ValueError(f"the kernel takes D % 32 == 0 and D <= {_MAX_D}; got D={D}")
    for name, t in (("q", q), ("prefix_k", prefix_k), ("prefix_v", prefix_v),
                    ("prefix_lens", prefix_lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.is_floating_point() and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def shared_prefix_attention(
    q: torch.Tensor,
    prefix_k: torch.Tensor,
    prefix_v: torch.Tensor,
    prefix_lens: torch.Tensor,
    *,
    sm_scale: Optional[float] = None,
    block_s: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (P, M, H, D) in q's dtype, lse (P, M, H) f32). CUDA
    tensors launch the kernel, which stages at most ``min(block_s, S, 128)``
    prefix rows at a time; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return shared_prefix_attention_plain(
            q, prefix_k, prefix_v, prefix_lens, sm_scale=sm_scale
        )
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, prefix_k, prefix_v, prefix_lens)
    P, M, H, D = q.shape
    S, KV = prefix_k.shape[1], prefix_k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    block_s = max(1, min(int(block_s), S, _MAX_KEYS))
    out = torch.empty_like(q)
    lse = torch.empty((P, M, H), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_shared_prefix_attention(
            q.data_ptr(), prefix_k.data_ptr(), prefix_v.data_ptr(),
            prefix_lens.data_ptr(), out.data_ptr(), lse.data_ptr(),
            P, M, H, KV, D, S, block_s,
            float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"shared_prefix_attention kernel launch failed: cudaError {rc}")
    shared_prefix_attention.launches += 1
    return out, lse


shared_prefix_attention.launches = 0
