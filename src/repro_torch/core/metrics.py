"""Measurement utilities: hit-probability estimation, ripple histograms,
and the set-latency statistics used by the paper's Tables I/III/V and
Figure 2.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .shared_lru import GetResult, RequestStats


class HitRecorder:
    """Per-(proxy, object) hit/request counters.

    ``hit_prob(i, k)`` estimates the stationary probability that a request
    by proxy ``i`` for object ``k`` is a *hit on its own LRU-list* — the
    quantity tabulated in the paper's Tables I-III.
    """

    def __init__(self, n_proxies: int, n_objects: int) -> None:
        self.req = np.zeros((n_proxies, n_objects), dtype=np.int64)
        self.hit = np.zeros((n_proxies, n_objects), dtype=np.int64)

    def record(self, proxy: int, obj: int, result: GetResult) -> None:
        self.req[proxy, obj] += 1
        if result is GetResult.HIT_LIST:
            self.hit[proxy, obj] += 1

    def hit_prob(self, proxy: int, obj: int) -> float:
        r = self.req[proxy, obj]
        return float(self.hit[proxy, obj] / r) if r else float("nan")

    def hit_prob_matrix(self) -> np.ndarray:
        """(J, N) hit probabilities; NaN where an object was never
        requested by a proxy (matching :meth:`hit_prob`), with no
        divide-by-zero RuntimeWarning."""
        with np.errstate(invalid="ignore"):
            return np.where(
                self.req > 0, self.hit / np.maximum(self.req, 1), np.nan
            )

    def overall_hit_rate(self, proxy: Optional[int] = None) -> float:
        if proxy is None:
            return float(self.hit.sum() / max(self.req.sum(), 1))
        return float(self.hit[proxy].sum() / max(self.req[proxy].sum(), 1))


class OccupancyRecorder:
    """Variance-reduced hit-probability estimation via residence times.

    Under the IRM, request epochs are independent of the cache state, so
    (PASTA) the stationary hit probability ``h_{i,k}`` equals the
    long-run *fraction of time* object ``k`` spends in LRU-list ``i``.
    Tracking exact residence intervals removes all sampling noise beyond
    the trajectory itself — at rank 1000 this is orders of magnitude
    tighter than counting realized hits (the paper's Tables I/III report
    3 significant digits at h ~ 1e-3, which plain hit counting would need
    ~1e9 requests to resolve).

    Attach with ``recorder.attach_to(cache)``; advance ``recorder.now``
    once per simulated request; call ``finalize`` before reading.
    """

    def __init__(self, n_proxies: int, n_objects: int) -> None:
        self.resident_since = np.full((n_proxies, n_objects), -1, dtype=np.int64)
        self.total_time = np.zeros((n_proxies, n_objects), dtype=np.int64)
        self.now = 0
        self.t_start = 0

    def attach_to(self, cache) -> "OccupancyRecorder":
        cache.event_hook = self.hook
        return self

    def hook(self, event: str, proxy: int, key: object) -> None:
        if not isinstance(key, (int, np.integer)) or key >= self.resident_since.shape[1]:
            return
        if event == "attach":
            self.resident_since[proxy, key] = self.now
        elif event == "detach":
            since = self.resident_since[proxy, key]
            if since >= 0:
                self.total_time[proxy, key] += self.now - max(since, self.t_start)
                self.resident_since[proxy, key] = -1

    def reset_window(self) -> None:
        """Start measuring from the current instant (post-warmup)."""
        self.total_time[:] = 0
        self.t_start = self.now

    def finalize(self) -> None:
        """Close all open residence intervals at ``now``."""
        open_mask = self.resident_since >= 0
        since = np.maximum(self.resident_since, self.t_start)
        self.total_time[open_mask] += self.now - since[open_mask]
        self.resident_since[open_mask] = self.now

    def occupancy(self) -> np.ndarray:
        """(J, N) time-average occupancy == IRM hit probabilities."""
        horizon = max(self.now - self.t_start, 1)
        return self.total_time / horizon


@dataclass
class RippleStats:
    """Histogram of evictions per set/insert (paper Fig. 2) plus the
    ripple/primary split used by the RRE evaluation (Section IV-D)."""

    evictions_per_set: Counter = field(default_factory=Counter)
    n_sets: int = 0
    n_primary: int = 0
    n_ripple: int = 0

    def record(self, stats: RequestStats) -> None:
        self.n_sets += 1
        self.evictions_per_set[stats.n_evictions] += 1
        self.n_ripple += stats.n_ripple
        self.n_primary += stats.n_evictions - stats.n_ripple

    def histogram(self, max_bucket: Optional[int] = None) -> Dict[int, int]:
        if max_bucket is None:
            max_bucket = max(self.evictions_per_set, default=0)
        return {k: self.evictions_per_set.get(k, 0) for k in range(max_bucket + 1)}

    @property
    def frac_multi_eviction(self) -> float:
        """Fraction of sets with >1 eviction — the paper reports 16 % for
        its 9-proxy heterogeneous workload."""
        if self.n_sets == 0:
            return 0.0
        multi = sum(c for k, c in self.evictions_per_set.items() if k > 1)
        return multi / self.n_sets

    @property
    def mean_evictions(self) -> float:
        if self.n_sets == 0:
            return 0.0
        return sum(k * c for k, c in self.evictions_per_set.items()) / self.n_sets


class LatencyRecorder:
    """Wall-clock execution-time stats for cache commands (Table V)."""

    def __init__(self) -> None:
        self.samples_us: Dict[str, List[float]] = {}

    def time(self, op: str):
        rec = self

        class _Ctx:
            __slots__ = ("t0",)

            def __enter__(self):
                self.t0 = time.perf_counter_ns()
                return self

            def __exit__(self, *exc):
                dt_us = (time.perf_counter_ns() - self.t0) / 1e3
                rec.samples_us.setdefault(op, []).append(dt_us)
                return False

        return _Ctx()

    def summary(self, op: str) -> Tuple[float, float, int]:
        """(mean_us, std_us, n) for an operation type."""
        xs = np.asarray(self.samples_us.get(op, []), dtype=np.float64)
        if xs.size == 0:
            return (float("nan"), float("nan"), 0)
        return (float(xs.mean()), float(xs.std()), int(xs.size))

    def cdf(self, op: str) -> Tuple[np.ndarray, np.ndarray]:
        xs = np.sort(np.asarray(self.samples_us.get(op, []), dtype=np.float64))
        return xs, np.arange(1, xs.size + 1) / max(xs.size, 1)


def table_rows(
    hit_matrix: np.ndarray,
    object_ranks: Sequence[int] = (1, 10, 100, 1000),
) -> List[List[float]]:
    """Format a Tables I/II/III-style block: one row per proxy with hit
    probabilities at the requested (1-based) object ranks."""
    rows = []
    for i in range(hit_matrix.shape[0]):
        rows.append([hit_matrix[i, k - 1] for k in object_ranks])
    return rows
