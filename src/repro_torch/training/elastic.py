"""Fault tolerance: straggler flagging, failure simulation and moving a
train state between devices (the reference's ``repro.training.elastic``;
the monitor and the injector are host copies).

* :class:`StragglerMonitor` — per-step deadline from a running latency
  percentile; a step exceeding it is flagged.
* :class:`FailureInjector` — deterministic fault schedule (seeded) that
  raises at chosen steps; the train loop recovers by restoring the last
  committed checkpoint.
* :func:`reshard_state` — the elastic-scaling primitive: the state placed
  anew, one device or mesh placement per leaf (``place_tree``); a state
  on a mesh is gathered first, so it moves to a mesh of more or fewer
  devices, or back to one device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Sharding

from .tree import _children, _is_node, flatten_with_paths, unflatten


@dataclass
class StragglerMonitor:
    """Flag steps slower than pXX * factor of the recent window."""

    window: int = 50
    percentile: float = 90.0
    factor: float = 3.0
    min_samples: int = 10
    _lat: List[float] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        lat = self._lat
        is_straggler = False
        if len(lat) >= self.min_samples:
            deadline = np.percentile(lat[-self.window:], self.percentile)
            is_straggler = seconds > self.factor * deadline
            if is_straggler:
                self.stragglers.append(step)
        lat.append(seconds)
        if len(lat) > 4 * self.window:
            del lat[: 2 * self.window]
        return is_straggler


class FailureInjector:
    """Deterministic failure schedule for recovery testing."""

    def __init__(self, fail_steps: Optional[List[int]] = None,
                 rate: float = 0.0, seed: int = 0) -> None:
        self.fail_steps = set(fail_steps or [])
        self.rate = rate
        self._rng = np.random.default_rng(seed)
        self._tripped = set()

    def maybe_fail(self, step: int) -> None:
        trip = step in self.fail_steps and step not in self._tripped
        if not trip and self.rate > 0:
            trip = bool(self._rng.random() < self.rate)
        if trip:
            self._tripped.add(step)
            raise SimulatedNodeFailure(f"injected failure at step {step}")


class SimulatedNodeFailure(RuntimeError):
    pass


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def specs_for(state: Any, shardings: Any) -> List[Any]:
    """One placement per leaf of ``state``, in leaf order: ``shardings`` is
    a single spec (a :class:`~repro_torch.launch.mesh.Sharding`, a device,
    a device name or None for the card) for every leaf, or a tree that
    matches ``state`` down to its specs (``treedef.flatten_up_to`` in the
    reference: a spec where ``state`` has a subtree places all of it).
    A tree that does not match raises, naming the path."""
    out: List[Any] = []

    def walk(spec, sub, path):
        if not _is_node(spec):
            out.extend([spec] * len(flatten_with_paths(sub)))
            return
        if not _is_node(sub) or type(spec) is not type(sub) or (
                sorted(spec) != sorted(sub) if isinstance(spec, dict) else len(spec) != len(sub)):
            raise ValueError(f"shardings at {path or 'the root'} do not match the state's "
                             f"structure")
        for (key, s), (_, t) in zip(_children(spec), _children(sub)):
            walk(s, t, path + key)

    walk(shardings, state, "")
    return out


def sharding_of(t) -> Sharding:
    """A DTensor's mesh and placements as a :class:`Sharding`; raises for
    a placement a spec cannot give (a pending reduction)."""
    names = t.device_mesh.mesh_dim_names
    dims: List[list] = [[] for _ in range(t.ndim)]
    for name, pl in zip(names, t.placements):
        if pl.is_shard():
            dims[pl.dim].append(name)
        elif not pl.is_replicate():
            raise ValueError(f"placement {pl} on mesh axis {name!r} has no spec")
    if not any(dims):
        return Sharding(t.device_mesh)
    return Sharding(t.device_mesh, tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                                         for a in dims))


def place_leaf(t, spec, path: str = ""):
    """``t`` (a tensor, or a DTensor, which is gathered first: collective)
    placed by ``spec``: distributed over a mesh by a ``Sharding``, else
    moved to the device."""
    if is_dtensor(t):
        t = t.full_tensor()
    if isinstance(spec, Sharding):
        return spec.distribute(t.detach(), path)
    return t.to(resolve_device(spec))


def reshard_state(state: Any, shardings: Any = None) -> Any:
    """The state placed by ``shardings`` (:func:`specs_for`: one spec for
    every leaf, or a tree of them). Every rank of a mesh calls it, in the
    same leaf order: gathering a DTensor and distributing a tensor are
    collective. The reference goes through the host; here a leaf that is
    already gathered on the mesh's device may share its storage with the
    result."""
    pairs = flatten_with_paths(state)
    specs = specs_for(state, shardings)
    check_specs(pairs, specs)
    return unflatten(state, [place_leaf(t, s, path) for (path, t), s in zip(pairs, specs)])


def check_specs(pairs, specs) -> None:
    """Raises, naming the leaf, where a ``Sharding`` does not fit its
    (path, tensor): checked for every leaf before any collective runs."""
    for (path, t), spec in zip(pairs, specs):
        if isinstance(spec, Sharding):
            spec.placements(tuple(t.shape), path)
