"""The lane engine: R independent shared-LRU caches (lanes), each driven
through its own request trace, one CUDA thread per lane.

It replaces the reference's XLA lane engine (``core/fastsim_jax.py``:
``_drive_impl`` for one lane, ``_drive_batched_impl`` for R lanes with
per-lane sweep points). The step body is ``csrc/lane_engine.cuh``,
written once and built twice: by ``nvcc`` into ``csrc/lane_engine.cu``'s
kernel, and by ``g++`` into ``csrc/lane_engine_host.cpp``, which is this
kernel's plain version (:func:`lane_engine_plain`). No PyTorch call
computes this function and a torch op per micro-op would be no
yardstick, so the plain version is the same serial body on the host.

:func:`lane_engine` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it counts its launches in
``lane_engine.launches``. :func:`load` builds either and loads the
kernel's module without a launch. The state is the dict of
:func:`init_state`, updated in place: the kernel allocates nothing.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

HIST = 1024   # fastsim.HIST_BUCKETS (the last bucket clamps)
# The state tensors in the order of lane_engine.cuh's Field enum.
FIELDS = (
    "nxt", "prv", "hold", "res_since", "tot_time",   # (R, J*N)
    "hcnt", "length", "gnxt", "gprv", "isghost",     # (R, N)
    "head", "tail", "vlen", "hits_p", "reqs_p",      # (R, J)
    "b_lim", "bhat_lim",                             # (R, J) thresholds x M
    "hist",                                          # (R, HIST)
    "sc",                                            # (R, len(SCALARS))
)
# The columns of "sc", in the order of lane_engine.cuh's Scalar enum.
SCALARS = (
    "phys", "ghead", "gtail", "t_start", "n_hit_list", "n_hit_cache",
    "n_miss", "n_sets", "n_prim", "n_rip",
)
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9


def init_state(J: int, N: int, R: int, b_lim, bhat_lim,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """R cold lanes (the layout of the reference's
    ``fastsim_jax._init_state(J, N, batch=R)``, plus each lane's
    thresholds ``b * M`` and ``b_hat * M`` as (R, J) int32 rows)."""
    i32 = dict(dtype=torch.int32, device=device)

    def full(width, val):
        return torch.full((R, width), val, **i32)

    sc = torch.zeros((R, len(SCALARS)), **i32)
    sc[:, SCALARS.index("ghead")] = -1
    sc[:, SCALARS.index("gtail")] = -1
    st = {
        "nxt": full(J * N, -1), "prv": full(J * N, -1), "hold": full(J * N, 0),
        "res_since": full(J * N, -1), "tot_time": full(J * N, 0),
        "hcnt": full(N, 0), "length": full(N, 0), "gnxt": full(N, -1),
        "gprv": full(N, -1), "isghost": full(N, 0),
        "head": full(J, -1), "tail": full(J, -1), "vlen": full(J, 0),
        "hits_p": full(J, 0), "reqs_p": full(J, 0),
        "b_lim": torch.as_tensor(b_lim, **i32).expand(R, J).contiguous(),
        "bhat_lim": torch.as_tensor(bhat_lim, **i32).expand(R, J).contiguous(),
        "hist": full(HIST, 0),
        "sc": sc,
    }
    return st


def _fn(device: torch.device):
    if device.type == "cuda":
        fn = _build.load("lane_engine").repro_lane_engine
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES + [ctypes.c_void_p]
    else:
        fn = _build.load_host("lane_engine").repro_lane_engine_host
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES
    return fn


def load(device: torch.device) -> None:
    """Build the lane engine for ``device`` and, on a CUDA device, load the
    kernel's module, so that the first launch pays neither (no launch)."""
    _fn(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            rc = _build.load("lane_engine").repro_lane_engine_load()
        if rc != 0:
            raise RuntimeError(f"lane engine module failed to load: cudaError {rc}")


def field_table(st: Dict[str, torch.Tensor]) -> ctypes.Array:
    """The pointer table the C entry points take (stable while the state
    is updated in place; a runner builds it once)."""
    return (ctypes.c_uint64 * len(FIELDS))(*(st[f].data_ptr() for f in FIELDS))


def _check(st, P, O, lengths, share, idx0: int) -> tuple:
    dev = P.device
    R, m = P.shape
    J = st["head"].shape[1]
    N = st["length"].shape[1]
    want = {"nxt": J * N, "prv": J * N, "hold": J * N, "res_since": J * N,
            "tot_time": J * N, "hcnt": N, "length": N, "gnxt": N, "gprv": N,
            "isghost": N, "head": J, "tail": J, "vlen": J, "hits_p": J, "reqs_p": J,
            "b_lim": J, "bhat_lim": J, "hist": HIST, "sc": len(SCALARS)}
    for name, t in [(f, st[f]) for f in FIELDS] + [("P", P), ("O", O), ("lengths", lengths),
                                                    ("share", share)]:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, P on {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, width in want.items():
        if tuple(st[name].shape) != (R, width):
            raise ValueError(f"state {name} has shape {tuple(st[name].shape)}, not {(R, width)}")
    if O.shape != P.shape or lengths.shape != (N,) or share.shape != (J + 2,):
        raise ValueError("P, O (R, m), lengths (N,) and share (J + 2,) do not fit the state")
    if not (0 <= idx0 and idx0 + m < 2**31):
        raise ValueError("request indices must stay in int32")
    return R, J, N, m


def _call(fn, st, table, P, O, lengths, share, idx0, B, warmup, ripple_from, ghost, *extra):
    R, J, N, m = _check(st, P, O, lengths, share, idx0)
    return fn(ctypes.addressof(table), P.data_ptr(), O.data_ptr(), lengths.data_ptr(),
              share.data_ptr(), R, J, N, m, int(idx0), int(B), int(warmup),
              int(ripple_from), int(bool(ghost)), *extra)


def lane_engine_plain(st, P, O, *, idx0: int, lengths, share, B: int, warmup: int,
                      ripple_from: int, ghost: bool, table=None) -> None:
    """The kernel's plain version: the same step body built by g++, run
    on the host over CPU tensors, lane after lane."""
    if P.device.type != "cpu":
        raise ValueError(f"the plain version runs on CPU tensors, not {P.device}")
    table = field_table(st) if table is None else table
    rc = _call(_fn(P.device), st, table, P, O, lengths, share, idx0, B, warmup,
               ripple_from, ghost)
    if rc != 0:
        raise RuntimeError(f"lane engine host build refused its arguments (rc {rc})")


def lane_engine(st, P, O, *, idx0: int, lengths, share, B: int, warmup: int,
                ripple_from: int, ghost: bool, table=None) -> None:
    """Advance every lane by one chunk: lane r runs requests
    ``(P[r, j], O[r, j])`` at absolute indices ``idx0 + j``, updating
    ``st`` in place. ``P`` and ``O`` are (R, m) int32 with proxies in
    [0, J) and objects in [0, N) (the caller checks them). CUDA tensors
    launch the kernel on the current stream (no synchronisation); CPU
    tensors run :func:`lane_engine_plain`; m = 0 does nothing. ``table``
    is :func:`field_table` of ``st``, if the caller keeps one."""
    if P.dim() == 2 and P.shape[1] == 0:
        _check(st, P, O, lengths, share, idx0)
        return
    if P.device.type == "cpu":
        lane_engine_plain(st, P, O, idx0=idx0, lengths=lengths, share=share, B=B,
                          warmup=warmup, ripple_from=ripple_from, ghost=ghost, table=table)
        return
    if P.device.type != "cuda":
        raise ValueError(f"unsupported device {P.device}")
    table = field_table(st) if table is None else table
    fn = _fn(P.device)
    with torch.cuda.device(P.device):
        rc = _call(fn, st, table, P, O, lengths, share, idx0, B, warmup, ripple_from, ghost,
                   torch.cuda.current_stream(P.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lane engine kernel launch failed: cudaError {rc}")
    lane_engine.launches += 1


lane_engine.launches = 0
