"""Int8 error-feedback gradient compression (the reference's
``repro.training.compression``).

Large-scale DP all-reduce traffic can be quantized 4x (fp32->int8, or 2x
vs bf16) if the quantization error is carried forward ("error feedback" /
EF-SGD): the residual from step t is added to the gradient at step t+1
before quantizing, so the *time-averaged* update is unbiased.

Mechanics per tensor: g' = g + residual; scale = max|g'| / 127;
q = round(g'/scale) int8; decompressed d = q * scale; residual' = g' - d.
``torch.round`` rounds half to even, as ``jnp.round`` does.

With one process the all-reduce is absent, so quantizing "before the
all-reduce" is quantize -> dequantize on the local gradient: byte-exact
with what an int8 collective would carry.

On a mesh (``data_parallel.py``) the gradients and residuals are the
moments' local shards; ``splits`` (a ``data_parallel.Splits``) gives each
leaf's whole size (for ``min_size``), its scale from ``max|g'|`` over the
whole tensor (an all-reduce MAX over the mesh dims it is split on) and
the error metric's sums over the whole tensor: one scale a tensor, as the
reference takes it, not one a shard.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8
    min_size: int = 4096   # don't quantize tiny tensors (norm scales etc.)


def compression_init(params) -> Any:
    return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device), params)


def quantize(g: torch.Tensor, res: torch.Tensor, bits: int,
             amax: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dequantized g + res, the new residual); the scale from ``amax``
    where given (the whole tensor's max|g + res| for a shard), else from
    this tensor's."""
    gf = g.float() + res
    qmax = float(2 ** (bits - 1) - 1)
    if amax is None:
        amax = torch.max(torch.abs(gf))
    scale = torch.clamp(amax / qmax, min=1e-30)
    q = torch.clamp(torch.round(gf / scale), -qmax, qmax)
    deq = q * scale
    return deq, gf - deq


def compress_grads(grads, residuals, cfg: CompressionConfig, splits: Optional[Any] = None
                   ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    flat_g, flat_r = leaves(grads), leaves(residuals)
    numels = splits.numels if splits is not None else [g.numel() for g in flat_g]
    big = [n >= cfg.min_size for n in numels]
    on = [i for i, b in enumerate(big) if b]
    amax = [None] * len(flat_g)
    if splits is not None and on:
        local = splits.max([torch.max(torch.abs(flat_g[i].float() + flat_r[i])) for i in on],
                           which=on)
        for i, m in zip(on, local):
            amax[i] = m
    out_g, out_r, nums, dens = [], [], [], []
    for g, r, b, m in zip(flat_g, flat_r, big, amax):
        if not b:
            out_g.append(g)
            out_r.append(r)
            continue
        d, nr = quantize(g, r, cfg.bits, m)
        out_g.append(d.to(g.dtype))
        out_r.append(nr)
        nums.append(torch.sum(torch.square(nr)))
        dens.append(torch.sum(torch.square(d)))
    if splits is not None and on:
        both = splits.sum(nums + dens, which=on + on)
        nums, dens = both[:len(on)], both[len(on):]
    err_num = err_den = 0.0
    for n, d in zip(nums, dens):
        err_num = err_num + n
        err_den = err_den + d
    rel = torch.sqrt(torch.as_tensor(err_num) / torch.clamp(torch.as_tensor(err_den), min=1e-30))
    return unflatten(grads, out_g), unflatten(residuals, out_r), {"compress_rel_err": rel}
