"""K3, flash attention: the prefill and training attention of the dense
models, and K3-bwd, its backward.

K3 is FA2's forward with GQA (query head h reads kv head h // G): a
top-left causal mask (key s is seen by query t when s <= t, with no S - T
offset), keys at or past S masked, and the output acc / max(l, 1e-30) in
q's dtype, as the reference's Pallas ``_flash_kernel`` computes it; asked
for it, it also writes each row's log-sum-exp (B, H, T) in f32.

The CUDA kernels are ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` (their notes say what bounds them and how
they are laid out: bf16 inputs on tensor cores, f32 inputs in f32 FMA).
Each wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version for CPU tensors: :func:`flash_attention` (and
:func:`flash_attention_fwd`, which adds the lse) counts K3's launches in
``flash_attention.launches``; :func:`flash_attention_bwd` counts
K3-bwd's in ``flash_attention_bwd.launches``. :class:`FlashAttention`
joins the two for autograd, as the reference's custom VJP
(``_flash_grouped``) joins its forward and backward.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)       # the D the kernel is instantiated for
NEG_INF = -1e30
KV_CHUNK = 1024     # keys a step of K3-bwd's plain version (the default of repro_torch.launch.tuning.kv_chunk)


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


def flash_attention_fwd_plain(q, k, v, *, causal: bool = True,
                              sm_scale: Optional[float] = None):
    """The plain version of K3 with its lse: (out in q's dtype, contiguous
    as the kernel's, lse (B, H, T) f32), from one pass of the reference's
    scores. The out is :func:`flash_attention_plain`'s; lse is the
    kernel's m + log(l), -1e30 where there is no key."""
    out, lse = ref.reference_attention(q, k, v, causal=causal, sm_scale=sm_scale,
                                       return_lse=True)
    lse = torch.clamp(lse, min=NEG_INF).permute(0, 2, 1).contiguous()
    return out.contiguous(), lse


def flash_attention_bwd_plain(q, k, v, out, lse, dout, *, causal: bool = True,
                              sm_scale: Optional[float] = None, kv_chunk: int = KV_CHUNK,
                              window: int = 0, q_offset: int = 0):
    """K3-bwd's plain version, the reference's ``_flash_grouped_bwd`` in
    PyTorch: delta = rowsum(dO * O) in f32, then per chunk of ``kv_chunk``
    keys P = exp(scale q k - lse) recomputed from the saved lse (B, H, T),
    dV = P^T dO, dS = P (dO V^T - delta), dQ += scale dS K, dK = scale dS^T
    Q. Returns (dq, dk, dv) in the inputs' dtypes. ``window`` > 0 (keys
    within ``window`` of the query) and ``q_offset`` (the position of q[0])
    serve the models' windowed attention (``models.attention.FlashGrouped``),
    which no kernel runs."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G, Dv = H // KV, v.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, T, KV, G, D) * sm_scale
    dof = dout.float().reshape(B, T, KV, G, Dv)
    delta = (dof * out.float().reshape(B, T, KV, G, Dv)).sum(dim=-1)      # (B,T,KV,G)
    lse_g = lse.float().reshape(B, KV, G, T).permute(0, 3, 1, 2)         # (B,T,KV,G)
    t_pos = q_offset + torch.arange(T, device=q.device)
    dq = torch.zeros((B, T, KV, G, D), dtype=torch.float32, device=q.device)
    dk = torch.empty((B, S, KV, D), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, S, KV, Dv), dtype=torch.float32, device=q.device)
    for lo in range(0, S, kv_chunk):
        hi = min(lo + kv_chunk, S)
        kc, vc = k[:, lo:hi].float(), v[:, lo:hi].float()
        s = torch.einsum("btkgd,bckd->btkgc", qf, kc)
        kv_pos = torch.arange(lo, hi, device=q.device)[None, :]
        seen = torch.ones((T, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            seen = seen & (kv_pos <= t_pos[:, None])
        if window > 0:
            seen = seen & (kv_pos > t_pos[:, None] - window)
        s = s.masked_fill(~seen[None, :, None, None, :], NEG_INF)
        p = torch.exp(s - lse_g[..., None])                                 # recomputed
        dv[:, lo:hi] = torch.einsum("btkgc,btkgv->bckv", p, dof)
        ds = p * (torch.einsum("btkgv,bckv->btkgc", dof, vc) - delta[..., None])
        dq += sm_scale * torch.einsum("btkgc,bckd->btkgd", ds, kc)
        dk[:, lo:hi] = torch.einsum("btkgc,btkgd->bckd", ds, qf)          # qf carries the scale
    return dq.reshape(B, T, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5                 # q, k, v, out, lse (or null)
            + [ctypes.c_int] * 7                  # B, T, S, H, KV, D, causal
            + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]  # scale, dtype, stream
        )
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 10                # q, k, v, o, lse, dout, delta, dq, dk, dv
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


_TENSOR_CORES = {0: "none (f32 FMA)", 2: "wgmma"}


def bwd_launch_plan(D: int, dtype: torch.dtype) -> dict:
    """How K3-bwd launches for head size D and this dtype: the tensor-core
    instruction, and for its dK/dV and dQ kernels the threads a block, the
    rows of the block's own side (keys; queries), the other side's rows a
    step, the stages of the ring, the dynamic shared memory and the output
    columns a block. Loads (and if need be builds) the library."""
    fn = _bwd_lib().repro_flash_attention_bwd_plan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 13)()
    rc = fn(D, _DTYPES[dtype], ctypes.addressof(out))
    if rc != 0:
        raise ValueError(f"no flash_attention_bwd kernel for D={D}, {dtype}")
    keys = ("threads", "own_rows", "step_rows", "stages", "smem_bytes", "columns")
    return {"tensor_cores": _TENSOR_CORES[out[0]],
            "dkdv": dict(zip(keys, out[1:7])), "dq": dict(zip(keys, out[7:13]))}


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


def _device(q: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return True


def _launch_k3(q, k, v, causal: bool, sm_scale: Optional[float], with_lse: bool):
    _check(q, k, v)
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) if with_lse else None
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            B, T, S, H, KV, D, int(causal),
            float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {rc}")
    flash_attention.launches += 1
    return out, lse


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
    if not _device(q):
        return flash_attention_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    return _launch_k3(q, k, v, causal, sm_scale, with_lse=False)[0]


flash_attention.launches = 0


def flash_attention_fwd(q, k, v, *, causal: bool = True, sm_scale: Optional[float] = None):
    """K3 with its lse: (out (B, T, H, D) in q's dtype, lse (B, H, T) f32),
    the residuals of the backward. One K3 launch, counted in
    ``flash_attention.launches``; CPU tensors run the plain version."""
    if not _device(q):
        return flash_attention_fwd_plain(q, k, v, causal=causal, sm_scale=sm_scale)
    return _launch_k3(q, k, v, causal, sm_scale, with_lse=True)


def _check_bwd(q, k, v, out, lse, dout) -> None:
    _check(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not match q")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    B, T, H, _ = q.shape
    if (lse.shape != (B, H, T) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous f32 of shape {(B, H, T)}")


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        sm_scale: Optional[float] = None):
    """K3-bwd: (dq, dk, dv) of K3's output (q's, k's and v's shapes and
    dtype) from the forward's inputs, its output ``out`` and ``lse``
    (B, H, T) f32, and ``dout``, the output's gradient. CUDA tensors launch
    the kernel (counted in ``flash_attention_bwd.launches``); CPU tensors
    run :func:`flash_attention_bwd_plain`."""
    if not _device(q):
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal,
                                         sm_scale=sm_scale)
    _check_bwd(q, k, v, out, lse, dout)
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            dout.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, T, S, H, KV, D, int(causal), float(sm_scale), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {rc}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """K3 under autograd: the forward keeps (q, k, v, out, lse) and the
    backward recomputes P from them, as the reference's ``_flash_grouped``
    custom VJP does. CUDA tensors run K3 (with its lse) and K3-bwd, and
    raise where a kernel cannot run; CPU tensors run both plain versions.
    ``FlashAttention.apply(q, k, v, causal, sm_scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float]):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout.contiguous(),
                                         causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None
