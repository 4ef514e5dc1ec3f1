"""Reducing Ripple Evictions (RRE) — paper Section IV-D (host copy of
``repro.core.rre``; nothing here touches the device).

Two composable mechanisms:

1. **Slack thresholds**: operate each proxy with a primary allocation
   ``b_i`` and a ripple allocation ``b_hat_i`` with
   ``b_i <= b_hat_i <= b_i*``. A request by proxy ``i`` trims list ``i``
   to ``b_i`` (primary evictions) immediately, but *other* lists are only
   trimmed beyond ``b_hat`` — inflation is absorbed by the slack instead
   of cascading. (Implemented natively by
   ``SharedLRUCache(ripple_allocations=...)``.)

2. **Delayed batch evictions**: every ``batch_interval`` sets, trim every
   list back to its primary allocation in one batch (amortizing cascades
   that would otherwise interleave with request processing).

``benchmarks/bench_rre.py`` quantifies the ripple reduction and the
memory give-back ``sum(b_hat - b)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from .metrics import RippleStats
from .shared_lru import EvictionEvent, RequestStats, SharedLRUCache


@dataclass
class RREConfig:
    """slack_frac: b_hat = b * (1 + slack_frac); batch_interval: sets
    between batch trims (0 disables batching)."""

    slack_frac: float = 0.25
    batch_interval: int = 0

    def ripple_allocations(self, b: Sequence[int]) -> List[int]:
        return [int(np.ceil(x * (1.0 + self.slack_frac))) for x in b]


class RRECache:
    """A :class:`SharedLRUCache` operated under an RRE policy.

    The physical capacity must cover the slack: the memory "given back"
    to reduce ripples is ``sum(b_hat - b)`` (Section IV-D's trade).
    """

    def __init__(
        self,
        allocations: Sequence[int],
        physical_capacity: Optional[int] = None,
        *,
        config: RREConfig = RREConfig(),
        ghost_retention: bool = True,
    ) -> None:
        self.config = config
        b_hat = config.ripple_allocations(allocations)
        if physical_capacity is None:
            physical_capacity = sum(b_hat)
        if physical_capacity < sum(b_hat):
            raise ValueError(
                "physical capacity must cover the RRE slack: "
                f"B={physical_capacity} < sum(b_hat)={sum(b_hat)}"
            )
        self.cache = SharedLRUCache(
            allocations,
            physical_capacity,
            ghost_retention=ghost_retention,
            ripple_allocations=b_hat,
        )
        self._sets_since_batch = 0
        self.batch_events: List[EvictionEvent] = []

    @property
    def J(self) -> int:
        return self.cache.J

    @property
    def memory_giveback(self) -> int:
        """sum(b_hat - b): the slack paid for ripple reduction."""
        return sum(self.cache.b_hat) - sum(self.cache.b)

    def _maybe_batch(self) -> List[EvictionEvent]:
        if self.config.batch_interval <= 0:
            return []
        self._sets_since_batch += 1
        if self._sets_since_batch >= self.config.batch_interval:
            self._sets_since_batch = 0
            ev = self.cache.enforce()
            self.batch_events.extend(ev)
            return ev
        return []

    def get(self, i: int, key: object) -> RequestStats:
        return self.cache.get(i, key)

    def set(self, i: int, key: object, length: int) -> RequestStats:
        st = self.cache.set(i, key, length)
        self._maybe_batch()
        return st

    def get_autofetch(self, i: int, key: object, length: int) -> RequestStats:
        st = self.cache.get_autofetch(i, key, length)
        self._maybe_batch()
        return st


def compare_ripple(
    proxies: np.ndarray,
    objects: np.ndarray,
    lengths: np.ndarray,
    allocations: Sequence[int],
    config: RREConfig,
    *,
    physical_capacity: Optional[int] = None,
) -> dict:
    """Run the same trace through the base system and the RRE system;
    return ripple statistics for both (the Section IV-D evaluation)."""
    base = SharedLRUCache(
        allocations,
        physical_capacity
        if physical_capacity is not None
        else sum(config.ripple_allocations(allocations)),
    )
    rre = RRECache(allocations, physical_capacity, config=config)

    out = {}
    for name, cache in (("base", base), ("rre", rre)):
        ripple = RippleStats()
        for i, k in zip(proxies.tolist(), objects.tolist()):
            st = cache.get(i, k)
            if st.result.value == "miss":
                st = cache.set(i, k, int(lengths[k]))
                ripple.record(st)
        out[name] = ripple
    # Batch-mode evictions are accounted separately (they are the point:
    # they happen off the request path).
    out["rre_batch_evictions"] = len(rre.batch_events)
    out["memory_giveback"] = rre.memory_giveback
    return out
