"""The train step's data parallelism over a mesh (the reference gets it
from ``jax.jit`` of its pure step on a state placed by ``reshard_state``).

Every parameter and moment is a DTensor replicated over the mesh; each
rank holds its own contiguous rows of the global batch (rank ``di`` of
``dsz``: rows [di B/dsz, (di+1) B/dsz)). The step computes what the
reference's one program computes on the global batch:

* the loss is the global batch's: the masked cross-entropy sums its
  numerator and its token count over the data group, and the MoE aux loss
  takes f_e and m_e over the global batch (``models`` read the
  :class:`DataParallel` that the step installs in ``models.shardctx``
  under ``"data_parallel"``; m_e carries a gradient, so its sum is an
  autograd function whose backward sums the gradients: every rank holds
  the same loss, so each rank's gradient comes out ``dsz`` times its own
  rows' share);
* MoE capacity is per chunk of the reference's per-device capacity: the
  step installs ``moe_chunks = dsz``, so chunk r is rank r's rows and its
  capacity is the global C // dsz;
* microbatch i is the global rows [i B/n, (i+1) B/n), each split over the
  ranks (:meth:`DataParallel.microbatch_rows`);
* the gradients are averaged over the data group (one all-reduce a leaf)
  before compression and the global-norm clip, and every rank applies
  the same update to its local tensors in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import data_place, gather_cat

from .elastic import is_dtensor
from .tree import flatten_with_paths, leaves


class _AllSum(torch.autograd.Function):
    """The sum over the data group on every rank; its transpose sums the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return dp.sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.sum_(g.clone()), None


class DataParallel:
    """The data group of a mesh for the train step: its size, this rank's
    index, and the collectives the step and the models call, counted in
    ``calls``."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.group, self.size, self.index, self.ranks = data_place(mesh)
        self.calls = 0

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data group, in place (no gradient)."""
        self.calls += 1
        dist.all_reduce(x, group=self.group)
        return x

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data group, differentiable."""
        return _AllSum.apply(x, self)

    def mean_grads_(self, grads) -> None:
        """Every gradient leaf averaged over the data group, in place."""
        with torch.no_grad():
            for g in leaves(grads):
                self.sum_(g).div_(self.size)

    def microbatch_rows(self, batch: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
        """This rank's rows of each of ``n`` global microbatches, in order:
        microbatch i (global rows [i B/n, (i+1) B/n)) split over the ranks.
        A batch of token ids is a few KB, so it is all-gathered over the
        data group and cut; with one microbatch, or one rank, the rank's
        own rows are its part."""
        if n <= 1 or self.size == 1:
            return batch
        out = {}
        for key in sorted(batch):                 # the same order on every rank
            v = batch[key]
            bl = v.shape[0]
            if bl % n:
                raise ValueError(f"{bl} rows a rank do not split into {n} microbatches")
            self.calls += 1
            full = gather_cat(v, self.group, self.ranks)
            m, s = full.shape[0] // n, bl // n
            out[key] = torch.cat([full[i * m + self.index * s:i * m + (self.index + 1) * s]
                                  for i in range(n)])
        return {k: out[k] for k in batch}


def state_mesh(state: Any) -> Optional[Any]:
    """The mesh of a state whose every leaf is a DTensor replicated over
    it; None for a state of plain tensors. Any other placement, a mixed
    state or two meshes raise, naming the leaf: nothing is gathered
    quietly."""
    pairs = flatten_with_paths(state)
    if not any(is_dtensor(t) for _, t in pairs):
        return None
    mesh = None
    for path, t in pairs:
        if not is_dtensor(t):
            raise ValueError(f"{path} is a plain tensor in a state on a mesh")
        if not all(p.is_replicate() for p in t.placements):
            raise ValueError(f"{path} is placed {tuple(t.placements)}: the data-parallel step "
                             f"takes parameters and moments replicated over the mesh")
        if mesh is None:
            mesh = t.device_mesh
        elif t.device_mesh != mesh:
            raise ValueError(f"{path} is on another mesh than the state's first leaf")
    return mesh
