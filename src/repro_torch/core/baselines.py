"""Baseline caching systems the paper compares against.

* :class:`SimpleLRU` — one classical LRU with capacity ``b`` charging the
  *full* object length. J of these side by side = the paper's "not-shared"
  system (Table III, Prop. 3.1 comparison).
* :class:`NotSharedSystem` — convenience wrapper for J independent
  :class:`SimpleLRU` caches (static partitioning).
* :class:`PooledLRU` — one LRU of capacity ``sum(b_i)`` serving all
  proxies' merged request stream — plain MCD in Section VI-C's overhead
  comparison (single eviction per set).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Sequence

from .shared_lru import EvictionEvent, GetResult, RequestStats


class SimpleLRU:
    """Classical LRU over variable-length objects (full-length charging)."""

    def __init__(self, capacity: int) -> None:
        self.capacity = int(capacity)
        self.items: OrderedDict = OrderedDict()  # key -> length, head = end
        self.used = 0
        self.n_get = 0
        self.n_hit = 0

    def __contains__(self, key: object) -> bool:
        return key in self.items

    def keys(self):
        return self.items.keys()

    def get(self, key: object) -> bool:
        self.n_get += 1
        if key in self.items:
            self.n_hit += 1
            self.items.move_to_end(key)
            return True
        return False

    def set(self, key: object, length: int) -> List[object]:
        """Insert/update; returns evicted keys."""
        length = int(length)
        if key in self.items:
            self.used += length - self.items[key]
            self.items[key] = length
            self.items.move_to_end(key)
        else:
            self.items[key] = length
            self.used += length
        evicted: List[object] = []
        while self.used > self.capacity and self.items:
            k, l = self.items.popitem(last=False)  # tail
            self.used -= l
            evicted.append(k)
        return evicted

    def get_autofetch(self, key: object, length: int) -> RequestStats:
        if self.get(key):
            return RequestStats(GetResult.HIT_LIST)
        evicted = self.set(key, length)
        events = [
            EvictionEvent(proxy=0, key=k, trigger_proxy=0, ripple=False,
                          physical=True)
            for k in evicted
        ]
        return RequestStats(GetResult.MISS, events)


class NotSharedSystem:
    """J independent LRUs with allocations b_i — the paper's not-shared
    baseline (Table III). Physical cache = disjoint union of the caches."""

    def __init__(self, allocations: Sequence[int]) -> None:
        self.J = len(allocations)
        self.caches = [SimpleLRU(b) for b in allocations]

    def get(self, i: int, key: object) -> RequestStats:
        if self.caches[i].get(key):
            return RequestStats(GetResult.HIT_LIST)
        return RequestStats(GetResult.MISS)

    def get_autofetch(self, i: int, key: object, length: int) -> RequestStats:
        st = self.caches[i].get_autofetch(key, length)
        for ev in st.evictions:  # re-label with the owning proxy
            ev.proxy = i
            ev.trigger_proxy = i
        return st

    def set(self, i: int, key: object, length: int) -> RequestStats:
        evicted = self.caches[i].set(key, length)
        events = [
            EvictionEvent(proxy=i, key=k, trigger_proxy=i, ripple=False,
                          physical=True)
            for k in evicted
        ]
        return RequestStats(GetResult.MISS, events)

    def in_list(self, i: int, key: object) -> bool:
        return key in self.caches[i]

    def list_keys(self, i: int) -> List[object]:
        return list(self.caches[i].keys())


class PooledLRU:
    """One LRU for the merged stream (plain MCD with a single LRU-list).

    The proxy argument is accepted and ignored so the same driver code can
    run against all three systems.
    """

    def __init__(self, capacity: int) -> None:
        self.cache = SimpleLRU(capacity)

    @property
    def J(self) -> int:  # pragma: no cover
        return 1

    def get(self, i: int, key: object) -> RequestStats:
        if self.cache.get(key):
            return RequestStats(GetResult.HIT_LIST)
        return RequestStats(GetResult.MISS)

    def get_autofetch(self, i: int, key: object, length: int) -> RequestStats:
        return self.cache.get_autofetch(key, length)

    def set(self, i: int, key: object, length: int) -> RequestStats:
        evicted = self.cache.set(key, length)
        events = [
            EvictionEvent(proxy=0, key=k, trigger_proxy=0, ripple=False,
                          physical=True)
            for k in evicted
        ]
        return RequestStats(GetResult.MISS, events)
