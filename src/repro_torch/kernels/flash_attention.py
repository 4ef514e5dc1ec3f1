"""K3, flash attention: the prefill attention of the dense models.

FA2's forward with GQA (query head h reads kv head h // G): a top-left
causal mask (key s is seen by query t when s <= t, with no S - T offset),
keys at or past S masked, and the output acc / max(l, 1e-30) in q's
dtype, as the reference's Pallas ``_flash_kernel`` computes it.

The CUDA kernel is ``csrc/flash_attention.cu`` (its note says what bounds
it and how it is laid out: bf16 inputs on tensor cores, f32 inputs in f32
FMA). :func:`flash_attention` launches it for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors; it counts its launches in
``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)       # the D the kernel is instantiated for


def kernel_head_dim(d: int) -> int:
    """The smallest head size the kernel is built for that holds ``d``
    columns (:func:`repro_torch.kernels.ops.flash_attention` pads to it)."""
    for D in _HEAD_DIMS:
        if d <= D:
            return D
    raise ValueError(f"the kernel takes D up to {_HEAD_DIMS[-1]}; got D={d}")


def flash_attention_plain(
    q: torch.Tensor,            # (B, T, H, D)
    k: torch.Tensor,            # (B, S, KV, D)
    v: torch.Tensor,            # (B, S, KV, D)
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """The kernel's plain PyTorch version: dense masked softmax in f32,
    top-left causal, out in q's dtype."""
    return ref.reference_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 4                 # q, k, v, out
            + [ctypes.c_int] * 7                  # B, T, S, H, KV, D, causal
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
        )
    return lib


def launch_plan(D: int, dtype: torch.dtype) -> dict:
    """How the kernel launches for head size D and this dtype: threads and
    query rows per block, keys per tile, K/V stages and dynamic shared
    memory. Loads (and if need be builds) the library."""
    fn = _lib().repro_flash_attention_plan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 5)()
    rc = fn(D, _DTYPES[dtype], ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"no flash_attention kernel for D={D}, {dtype}")
    keys = ("threads", "rows_per_block", "keys_per_tile", "stages", "smem_bytes")
    return dict(zip(keys, out))


def _check(q, k, v) -> None:
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("expected q (B,T,H,D) and k/v (B,S,KV,D)")
    B, T, H, D = q.shape
    Bk, S, KV, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if H % KV != 0:
        raise ValueError(f"H={H} is not a multiple of KV={KV}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes D in {_HEAD_DIMS}; got D={D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """(B, T, H, D) x (B, S, KV, D) -> (B, T, H, D) in q's dtype. CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check(q, k, v)
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, S, H, KV, D, int(causal),
            float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
