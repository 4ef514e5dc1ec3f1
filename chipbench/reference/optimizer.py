"""AdamW as the traffic mix states it: the gradient clipped by its global
norm, a linear warm-up then a cosine decay to ``min_lr_frac``, bias
corrections, decoupled weight decay on every leaf. Plain PyTorch on a
{path: tensor} map."""

from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(o: dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1),
                   0.0), 1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * prog))
    return o["lr"] * warm * (o["min_lr_frac"] + (1.0 - o["min_lr_frac"]) * cos)


def global_norm(grads: Dict[str, torch.Tensor]) -> float:
    return math.sqrt(sum(float(torch.sum(g.double() ** 2)) for g in grads.values()))


def adamw_step(params, grads, mu, nu, o: dict, step: int) -> None:
    """Step ``step`` (from 1), in place on ``params``, ``mu`` and ``nu``."""
    scale = min(o["grad_clip"] / max(global_norm(grads), 1e-12), 1.0)
    lr = lr_at(o, step)
    b1c, b2c = 1.0 - o["b1"] ** step, 1.0 - o["b2"] ** step
    with torch.no_grad():
        for n, p in params.items():
            g = grads[n].to(mu[n].dtype) * scale
            mu[n].mul_(o["b1"]).add_(g * (1 - o["b1"]))
            nu[n].mul_(o["b2"]).add_(g * g * (1 - o["b2"]))
            upd = (mu[n] / b1c) / (torch.sqrt(nu[n] / b2c) + o["eps"]) + o["weight_decay"] * p
            p.sub_((lr * upd).to(p.dtype))
