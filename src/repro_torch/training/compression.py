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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from .tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class CompressionConfig:
    bits: int = 8
    min_size: int = 4096   # don't quantize tiny tensors (norm scales etc.)


def compression_init(params) -> Any:
    return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32, device=a.device), params)


def quantize(g: torch.Tensor, res: torch.Tensor, bits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dequantized g + res, the new residual)."""
    gf = g.float() + res
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.clamp(torch.max(torch.abs(gf)) / qmax, min=1e-30)
    q = torch.clamp(torch.round(gf / scale), -qmax, qmax)
    deq = q * scale
    return deq, gf - deq


def compress_grads(grads, residuals, cfg: CompressionConfig
                   ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    out_g, out_r = [], []
    err_num = err_den = 0.0
    for g, r in zip(leaves(grads), leaves(residuals)):
        if g.numel() < cfg.min_size:
            out_g.append(g)
            out_r.append(r)
            continue
        d, nr = quantize(g, r, cfg.bits)
        out_g.append(d.to(g.dtype))
        out_r.append(nr)
        err_num = err_num + torch.sum(torch.square(nr))
        err_den = err_den + torch.sum(torch.square(d))
    rel = torch.sqrt(torch.as_tensor(err_num) / torch.clamp(torch.as_tensor(err_den), min=1e-30))
    return unflatten(grads, out_g), unflatten(residuals, out_r), {"compress_rel_err": rel}
