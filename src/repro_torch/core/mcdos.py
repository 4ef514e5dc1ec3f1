"""MCD-OS: MemCacheD with Object Sharing — the paper's Section VI
prototype, re-implemented as the control-plane server of this framework
(host copy of ``repro.core.mcdos``; nothing here touches the device).

Semantics follow the paper's Table IV exactly:

=====================================  =========================================
request                                behaviour
=====================================  =========================================
get(k), hit in LRU i                   promote k to head of LRU i
get(k), miss in LRU i, hit in cache    insert at head of LRU i; deflate other
                                       holders (+ eviction loop)
get(k), miss everywhere                return MISS; the client fetches from the
                                       database and issues set(k, v)
set(k, v), k not cached                store; virtual length = actual length;
                                       insert at head of LRU i (+ loop)
set(k, v), k cached                    update value (inflate/deflate all
                                       holders); promote/insert to head of LRU i
=====================================  =========================================

Like MCD-OS (and unlike the abstract Section III model), an LRU-list miss
that is a physical-cache hit is served from cache without an artificial
delay — the miss penalty model is attached by the serving engine, not
here. ``consistent_route`` reproduces MCD's client-side consistent
hashing for clustered deployments (placement is untouched by sharing):
it routes against the :class:`~repro_torch.core.cluster.HashRing` virtual-node
ring, so growing or shrinking the server count remaps only ~1/K of the
key space instead of reshuffling almost every key the way the naive
``hash(key) % n`` rule does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .baselines import PooledLRU
from .cluster import default_ring, key_position
from .metrics import HitRecorder, LatencyRecorder, RippleStats
from .shared_lru import GetResult, RequestStats, SharedLRUCache
from .slru import SegmentedSharedLRUCache


def consistent_route(key: object, n_servers: int, vnodes: int = 64) -> int:
    """MCD-style consistent key -> server routing.

    Looks the key's 64-bit position up on the canonical ``vnodes``-per-
    server hash ring (:func:`~repro_torch.core.cluster.default_ring`): stable
    run-to-run, balanced across servers, and minimally disruptive under
    membership change — routing against ``n_servers - 1`` moves only the
    keys owned by the removed server's arcs (~``1/n_servers`` of them).
    """
    if n_servers < 1:
        raise ValueError("n_servers must be >= 1")
    return default_ring(int(n_servers), int(vnodes)).route_pos(
        key_position(key)
    )


@dataclass
class ServerStats:
    hits: HitRecorder
    ripple: RippleStats
    latency: LatencyRecorder


class MCDOSServer:
    """One MCD-OS cache server: J proxy thread-pools over a shared cache.

    ``slru=True`` selects the Segmented-LRU variant (paper Section VII);
    the default flat LRU with a single slabclass matches the paper's
    evaluation setup (Section VI-B).
    """

    def __init__(
        self,
        allocations: Sequence[int],
        physical_capacity: Optional[int] = None,
        *,
        n_objects_hint: int = 1,
        slru: bool = False,
        ghost_retention: bool = True,
        ripple_allocations: Optional[Sequence[int]] = None,
    ) -> None:
        cls = SegmentedSharedLRUCache if slru else SharedLRUCache
        self.cache = cls(
            allocations,
            physical_capacity,
            ghost_retention=ghost_retention,
            ripple_allocations=ripple_allocations,
        )
        self.stats = ServerStats(
            hits=HitRecorder(len(allocations), n_objects_hint),
            ripple=RippleStats(),
            latency=LatencyRecorder(),
        )

    @property
    def J(self) -> int:
        return self.cache.J

    def _check_proxy(self, proxy: int) -> None:
        if not 0 <= int(proxy) < self.J:
            raise ValueError(
                f"proxy id {proxy} out of range for J={self.J} proxies"
            )

    # -- wire protocol -----------------------------------------------------
    def get(self, proxy: int, key: object) -> RequestStats:
        self._check_proxy(proxy)
        with self.stats.latency.time("get"):
            st = self.cache.get(proxy, key)
        if isinstance(key, (int, np.integer)) and key < self.stats.hits.req.shape[1]:
            self.stats.hits.record(proxy, int(key), st.result)
        return st

    def set(self, proxy: int, key: object, length: int) -> RequestStats:
        self._check_proxy(proxy)
        if length <= 0:
            raise ValueError(f"object length must be positive (got {length})")
        with self.stats.latency.time("set"):
            st = self.cache.set(proxy, key, length)
        self.stats.ripple.record(st)
        return st

    def process_command(
        self, proxy: int, cmd: str, key: object, length: Optional[int] = None
    ) -> RequestStats:
        """

        The native-MCD ``process_command`` analogue, enhanced with object
        sharing (paper Section VI-B)."""
        if cmd == "get":
            return self.get(proxy, key)
        if cmd == "set":
            if length is None:
                raise ValueError("set requires a length")
            return self.set(proxy, key, length)
        raise ValueError(f"unsupported command {cmd!r}")


class MCDServer:
    """Plain MCD baseline: one pooled LRU of size sum(b_i), single
    eviction per set — the Section VI-C comparison system."""

    def __init__(
        self, total_capacity: int, n_proxies: int, *, n_objects_hint: int = 1
    ) -> None:
        self.cache = PooledLRU(total_capacity)
        self.stats = ServerStats(
            hits=HitRecorder(n_proxies, n_objects_hint),
            ripple=RippleStats(),
            latency=LatencyRecorder(),
        )

    def get(self, proxy: int, key: object) -> RequestStats:
        with self.stats.latency.time("get"):
            st = self.cache.get(proxy, key)
        if isinstance(key, (int, np.integer)) and key < self.stats.hits.req.shape[1]:
            self.stats.hits.record(proxy, int(key), st.result)
        return st

    def set(self, proxy: int, key: object, length: int) -> RequestStats:
        with self.stats.latency.time("set"):
            st = self.cache.set(proxy, key, length)
        self.stats.ripple.record(st)
        return st


def run_trace(
    server,
    proxies: np.ndarray,
    objects: np.ndarray,
    lengths: np.ndarray,
    *,
    warmup: int = 0,
) -> ServerStats:
    """Drive a server with a merged IRM trace using MCD client semantics:
    every get miss is followed by a database fetch + ``set``.

    ``warmup`` requests are executed but excluded from hit statistics
    (the paper discards cold misses the same way).
    """
    hits = server.stats.hits
    for idx in range(len(proxies)):
        if idx == warmup and warmup > 0:
            hits.req[:] = 0
            hits.hit[:] = 0
            server.stats.ripple = RippleStats()
            server.stats.latency = LatencyRecorder()
        i = int(proxies[idx])
        k = int(objects[idx])
        st = server.get(i, k)
        if st.result is GetResult.MISS:
            server.set(i, k, int(lengths[k]))
    return server.stats
