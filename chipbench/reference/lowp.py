"""The controls: the reference in the precision one step below what a
configuration states, the step that would tempt a later change.

* Serving states bf16 weights and compute: the control computes every
  product with both operands rounded to fp8 (e4m3, one scale a tensor).
* Training states f32 masters under bf16 compute: the control holds its
  masters, moments and compute in bf16.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 under one per-tensor scale, back in its dtype."""
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    s = amax / FP8_MAX
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)
