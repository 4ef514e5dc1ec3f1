"""Fault tolerance: straggler flagging, failure simulation and moving a
train state between devices (the reference's ``repro.training.elastic``;
the monitor and the injector are host copies).

* :class:`StragglerMonitor` — per-step deadline from a running latency
  percentile; a step exceeding it is flagged.
* :class:`FailureInjector` — deterministic fault schedule (seeded) that
  raises at chosen steps; the train loop recovers by restoring the last
  committed checkpoint.
* :func:`reshard_state` — the state's tensors on another device. Sharding
  over a mesh waits for the port's ``launch`` slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device

from .tree import tree_map


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


def reshard_state(state: Any, device: DeviceLike = None) -> Any:
    """The state's tensors on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), state)
