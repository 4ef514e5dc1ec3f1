"""AdamW + cosine schedule + global-norm clipping, hand-rolled with the
reference's math (``repro.training.optimizer``: the clip scale, the bias
corrections, ``wd * p`` inside the update). State is a tree mirroring the
parameters: ``{"mu", "nu", "step"}``.

Unlike the reference, which returns new trees, :func:`adamw_update`
updates the parameters and the moments in place and returns the same
tensors (as the reference's launcher donates the state): a full-size
qwen3-1.7b state is 27.6 GB in f32 with its gradients, and a second copy
buys nothing. Not ``torch.optim.AdamW``: its update is rounded
differently, and the tests hold this one to the reference.

On a mesh (``data_parallel.py``) the update runs on the moments' local
shards unchanged; ``splits`` (a ``data_parallel.Splits``) makes the
global norm the whole gradient's, so the clip scale is the reference's
and the same on every rank.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .tree import leaves, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def adamw_init(params) -> Dict[str, Any]:
    zeros = lambda p: tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32), p)  # noqa: E731
    device = leaves(params)[0].device
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree, splits: Optional[Any] = None) -> torch.Tensor:
    """The L2 norm of every leaf together. With ``splits``, the leaves are
    local shards: each leaf's sum of squares is summed over the mesh dims
    it is split on (a replicated leaf counted once) before the total."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if splits is not None:
        sums = splits.sum(sums)
    return torch.sqrt(sum(sums))


def adamw_update(params, grads, state, cfg: AdamWConfig, splits: Optional[Any] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, in place on ``params`` (f32 masters) and the moments
    of ``state``; grads of any float dtype. Returns (params, new state,
    {"grad_norm", "lr"}) without a host synchronisation. On a mesh, every
    tree holds the moments' local shards and ``splits`` says where each
    leaf is split (:func:`global_norm`)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, splits)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    lr = cosine_lr(cfg, step)
    stepf = step.float()
    b1c = 1.0 - torch.pow(cfg.b1, stepf)
    b2c = 1.0 - torch.pow(cfg.b2, stepf)
    with torch.no_grad():
        for p, g, mu, nu in zip(leaves(params), leaves(grads), leaves(state["mu"]),
                                leaves(state["nu"])):
            g = g.float() * scale
            mu.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            nu.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
            delta = (mu / b1c) / (torch.sqrt(nu / b2c) + cfg.eps) + cfg.weight_decay * p
            p.sub_((lr * delta).to(p.dtype))
    new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
