"""The train step for any model of the zoo (the reference's
``repro.training.train_step``).

Mixed precision: the parameters are f32 masters; a ``compute_dtype`` cast
copy feeds the forward and backward, and the gradients come back in f32
through the cast (``torch.autograd.grad`` on the masters). Optional
gradient accumulation over ``microbatches`` (summed in f32) and int8
error-feedback gradient compression (``compression.py``) slot in here.

State is a dict ``{"params", "opt", "compress"?}`` of tensors, as in the
reference. The step updates it in place and returns it (the reference's
launcher donates its state to the jitted step): a caller that wants the
old state keeps a copy. A state whose leaves are DTensors replicated over
a mesh (``elastic.reshard_state``) steps data-parallel: each rank passes
its own rows of the global batch (``data_parallel.py``).

Two profiler ranges name the step's parts for ``torch.profiler``:
``train_step.forward`` (the loss) and ``train_step.optimizer`` (the
update); the backward runs on autograd's own thread, outside both.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch
from torch.profiler import record_function

from repro_torch.models import shardctx

from .compression import CompressionConfig, compress_grads, compression_init
from .data_parallel import DataParallel, state_mesh
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = field(default_factory=AdamWConfig)
    microbatches: int = 1            # gradient accumulation factor
    compute_dtype: Any = torch.bfloat16
    compression: Optional[CompressionConfig] = None


def _cast_tree(tree, dtype):
    return tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, tree)


def make_loss_fn(model, train_cfg: TrainConfig) -> Callable:
    def loss_fn(params, batch):
        return model.loss(_cast_tree(params, train_cfg.compute_dtype), batch)

    return loss_fn


def make_grad_fn(model, train_cfg: TrainConfig) -> Callable:
    """Returns ``grad_fn(params, batch) -> (loss, metrics, grads)``: the
    loss of the cast copy and the f32 gradients of the masters, averaged
    over ``microbatches`` (summed in f32) where there are several."""
    loss_fn = make_loss_fn(model, train_cfg)

    def one(params, batch):
        with torch.enable_grad():
            inputs = [p.detach().requires_grad_() for p in leaves(params)]
            with record_function("train_step.forward"):
                loss, metrics = loss_fn(unflatten(params, inputs), batch)
            grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        # a parameter the loss does not reach (an image projector without
        # images) gets a zero gradient, as jax.grad gives it
        flat = [torch.zeros_like(p) if g is None else g.float() for p, g in zip(inputs, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, unflatten(params, flat)

    def grad_fn(params, batch):
        n = train_cfg.microbatches
        if n <= 1:
            return one(params, batch)
        acc, loss_sum = None, 0.0
        for i in range(n):
            mb = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)]
                  for k, v in batch.items()}
            loss, _, grads = one(params, mb)
            acc = grads if acc is None else tree_map(torch.add, acc, grads)
            loss_sum = loss_sum + loss
        loss = loss_sum * (1.0 / n)
        return loss, {"loss": loss}, tree_map(lambda g: g * (1.0 / n), acc)

    return grad_fn


def make_train_step(model, train_cfg: TrainConfig) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``: ``batch`` a
    dict of tensors with the global batch leading on every leaf, or, for a
    state on a mesh, this rank's rows of it; metrics are 0-d tensors
    (``float()`` synchronises), on a mesh with ``"collectives"``, the
    step's all-reduces and all-gathers."""
    compute_grads = make_grad_fn(model, train_cfg)
    groups = {}                     # a mesh's DataParallel (its groups are made once)

    def train_step(state, batch):
        mesh = state_mesh(state)
        if mesh is None:
            return step(state, batch, None)
        dp = groups.get(id(mesh))
        if dp is None:
            dp = groups[id(mesh)] = DataParallel(mesh)
        dp.calls = 0
        with torch.no_grad():
            local = tree_map(lambda t: t.to_local(), state)
        with shardctx.added({"data_parallel": dp, "moe_chunks": dp.size}):
            new, metrics = step(local, dp.microbatch_rows(batch, train_cfg.microbatches), dp)
        with torch.no_grad():       # leaves the step made anew: the opt step, residuals
            for old, t in zip(leaves(local), leaves(new)):
                if t is not old:
                    old.copy_(t)
        return state, {**metrics, "collectives": torch.tensor(dp.calls)}

    def step(state, batch, dp: Optional[DataParallel]):
        params = state["params"]
        loss, metrics, grads = compute_grads(params, batch)
        if dp is not None:
            dp.mean_grads_(grads)
        if train_cfg.compression is not None:
            grads, comp_state, comp_metrics = compress_grads(grads, state["compress"],
                                                             train_cfg.compression)
            metrics = {**metrics, **comp_metrics}
        with record_function("train_step.optimizer"):
            params, opt, opt_metrics = adamw_update(params, grads, state["opt"],
                                                    train_cfg.optimizer)
        new_state = {"params": params, "opt": opt}
        if train_cfg.compression is not None:
            new_state["compress"] = comp_state
        out = {"loss": loss, **{k: v for k, v in metrics.items() if v.ndim == 0}, **opt_metrics}
        return new_state, out

    return train_step


def init_train_state(model, gen: torch.Generator, train_cfg: TrainConfig):
    """Parameters drawn from ``gen`` on its device, zero AdamW moments and,
    with compression, zero residuals."""
    params = model.init(gen)
    state = {"params": params, "opt": adamw_init(params)}
    if train_cfg.compression is not None:
        state["compress"] = compression_init(params)
    return state
