"""Object-sharing multi-LRU cache (the paper's Section III, faithfully).

J proxies each own a *virtual* LRU-list over one *physical* cache. An
object ``n`` of length ``l_n`` held by the proxy set ``P(n)`` charges each
holder only ``l_n / |P(n)|``. Miss-inserts deflate other holders' shares;
LRU-list evictions inflate them, potentially cascading ("ripple
evictions"). The operator eviction loop is exactly the paper's:

    1) find the LRU-list with the largest overflow (length - allocation)
    2) stop if that overflow is not positive
    3) evict that list's lowest-rank (tail) object
    4) reassess all list lengths
    5) repeat

Physical eviction requires consensus (``P(n) -> empty``); orphaned objects
may be retained as lowest-priority "ghosts" while physical room remains.

Exact arithmetic
----------------
Shares are ``l_n / p`` for ``p in {1..J}``. To keep virtual lengths exact
under millions of inflate/deflate events we store all lengths scaled by
``M = lcm(1..J)`` as integers: ``share_scaled = l_n * (M // p)``. No float
drift, no epsilon thresholds.

This module is host-side control-plane code by design (as in the paper's
MCD-OS prototype, and as in production serving stacks where the block
manager runs on CPU). The device-side counterpart is
``repro_torch.cacheblocks.block_pool``.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence


class GetResult(Enum):
    """Outcome of a ``get`` as seen by the proxy (paper Section III)."""

    HIT_LIST = "hit_list"        # hit on the proxy's own LRU-list
    HIT_CACHE = "hit_cache"      # LRU-list miss but physical-cache hit
    MISS = "miss"                # not physically cached: fetch from database


@dataclass
class EvictionEvent:
    """One LRU-list eviction produced by the operator loop."""

    proxy: int                   # list the object was evicted from
    key: object
    trigger_proxy: int           # proxy whose request started the loop
    ripple: bool                 # True if proxy != trigger_proxy ("ripple")
    physical: bool               # True if the object left the physical cache


@dataclass
class RequestStats:
    """Per-request outcome summary (drives Fig. 2 / Table V style stats)."""

    result: GetResult
    evictions: List[EvictionEvent] = field(default_factory=list)

    @property
    def n_evictions(self) -> int:
        return len(self.evictions)

    @property
    def n_ripple(self) -> int:
        return sum(1 for e in self.evictions if e.ripple)


def _lcm_1_to(j: int) -> int:
    out = 1
    for p in range(2, j + 1):
        out = out * p // math.gcd(out, p)
    return out


class SharedLRUCache:
    """The paper's object-sharing caching system (Section III).

    Parameters
    ----------
    allocations:
        ``b_i`` per proxy, in the same (integer) memory units as object
        lengths.
    physical_capacity:
        ``B``. Must satisfy ``sum(b_i) <= B`` (paper eq. (11)). ``None``
        means "exactly sum(b_i)" (no ghost headroom).
    ghost_retention:
        Keep consensus-evicted objects physically resident (lowest
        priority) while room remains — Section III's "the physical cache
        may store an object if it has room".
    ripple_allocations:
        Optional ``b_hat_i >= b_i`` per proxy for Ripple-Eviction
        Reduction (Section IV-D): during an eviction loop triggered by
        proxy ``i``, list ``i`` is trimmed to ``b_i`` (primary evictions)
        but *other* lists are only trimmed beyond ``b_hat_j`` (ripple
        evictions). Defaults to ``b`` (the paper's base system).
    """

    def __init__(
        self,
        allocations: Sequence[int],
        physical_capacity: Optional[int] = None,
        *,
        ghost_retention: bool = True,
        ripple_allocations: Optional[Sequence[int]] = None,
    ) -> None:
        self.J = len(allocations)
        if self.J < 1:
            raise ValueError("need at least one proxy")
        self._scale = _lcm_1_to(max(self.J, 1))
        self.b = [int(x) for x in allocations]
        if any(x < 0 for x in self.b):
            raise ValueError("allocations must be nonnegative")
        self.b_scaled = [x * self._scale for x in self.b]
        if ripple_allocations is None:
            ripple_allocations = list(self.b)
        self.b_hat = [int(x) for x in ripple_allocations]
        if len(self.b_hat) != self.J:
            raise ValueError("ripple_allocations must have one entry per proxy")
        if any(bh < bi for bh, bi in zip(self.b_hat, self.b)):
            raise ValueError("ripple_allocations must satisfy b_hat >= b")
        self.b_hat_scaled = [x * self._scale for x in self.b_hat]
        if physical_capacity is None:
            physical_capacity = sum(self.b)
        self.B = int(physical_capacity)
        if self.B < sum(self.b):
            raise ValueError(
                f"physical capacity B={self.B} < sum of allocations "
                f"{sum(self.b)} (paper eq. (11) requires sum b_i <= B)"
            )
        self.ghost_retention = bool(ghost_retention)

        # Per-proxy LRU-list: OrderedDict, head = *last* entry, tail = first.
        self.lists: List[OrderedDict] = [OrderedDict() for _ in range(self.J)]
        # P(n): key -> set of holder proxies (empty set never stored here).
        self.holders: Dict[object, set] = {}
        # l_n for every physically-resident object (holders or ghost).
        self.length: Dict[object, int] = {}
        # Ghosts: physically resident, no holders; OrderedDict = LRU order.
        self.ghosts: OrderedDict = OrderedDict()
        # Scaled virtual list lengths: vlen_scaled[i] = sum l_n*M/|P(n)|.
        self.vlen_scaled: List[int] = [0] * self.J
        # Physical bytes used (unscaled).
        self.phys_used: int = 0

        # Counters.
        self.n_get = 0
        self.n_set = 0
        self.n_hit_list = 0
        self.n_hit_cache = 0
        self.n_miss = 0

        # Optional membership-change hook: called as hook(event, i, key)
        # with event in {"attach", "detach"} right after the change. Used
        # by metrics.OccupancyRecorder for variance-free hit-probability
        # estimation (PASTA: under IRM, hit prob == occupancy fraction).
        self.event_hook: Optional[Callable[[str, int, object], None]] = None
        # Called with the key right before an object physically leaves
        # the cache — the device block pool frees its pages here.
        self.physical_evict_hook: Optional[Callable[[object], None]] = None

    # ------------------------------------------------------------------
    # Introspection helpers (used heavily by tests & metrics)
    # ------------------------------------------------------------------
    def vlen(self, i: int) -> float:
        """Current virtual length of LRU-list ``i`` (exact rational as float)."""
        return self.vlen_scaled[i] / self._scale

    def share_of(self, key: object) -> float:
        """Current per-holder share of ``key`` (0 if not held)."""
        h = self.holders.get(key)
        if not h:
            return 0.0
        return self.length[key] / len(h)

    def in_list(self, i: int, key: object) -> bool:
        return key in self.lists[i]

    def in_physical(self, key: object) -> bool:
        return key in self.length

    def list_keys(self, i: int) -> List[object]:
        """Keys of list ``i`` from tail (LRU) to head (MRU)."""
        return list(self.lists[i].keys())

    # ------------------------------------------------------------------
    # List-structure hooks. The flat-LRU base keeps one OrderedDict per
    # proxy (head = end). ``repro.core.slru.SegmentedSharedLRUCache``
    # overrides these to implement MCD's HOT/WARM/COLD S-LRU while
    # reusing all object-sharing + ripple-eviction logic unchanged.
    # ------------------------------------------------------------------
    def _list_insert_head(self, i: int, key: object) -> None:
        self.lists[i][key] = None

    def _list_remove(self, i: int, key: object) -> None:
        del self.lists[i][key]

    def _list_promote(self, i: int, key: object) -> None:
        self.lists[i].move_to_end(key)

    def _list_victim(self, i: int) -> object:
        """Lowest-rank (next-to-evict) key of list ``i``."""
        return next(iter(self.lists[i]))

    def check_invariants(self) -> None:
        """Assert the structural invariants of Section III. O(total objects)."""
        recomputed = [0] * self.J
        for key, hs in self.holders.items():
            assert hs, f"empty holder set stored for {key!r}"
            p = len(hs)
            share = self.length[key] * (self._scale // p)
            for i in hs:
                assert key in self.lists[i], (key, i)
                recomputed[i] += share
        for i in range(self.J):
            assert recomputed[i] == self.vlen_scaled[i], (
                f"list {i}: recomputed {recomputed[i]} != "
                f"tracked {self.vlen_scaled[i]}"
            )
            for key in self.lists[i]:
                assert i in self.holders.get(key, set()), (key, i)
            # After any completed operation no list exceeds its ripple
            # allocation (== b when RRE is off).
            assert self.vlen_scaled[i] <= self.b_hat_scaled[i], (
                f"list {i} over allocation: {self.vlen(i)} > {self.b_hat[i]}"
            )
        assert self.phys_used == sum(self.length.values())
        assert self.phys_used <= self.B
        for g in self.ghosts:
            assert g in self.length and g not in self.holders

    # ------------------------------------------------------------------
    # Core mutations
    # ------------------------------------------------------------------
    def _promote(self, i: int, key: object) -> None:
        self._list_promote(i, key)  # head = end

    def _attach(self, i: int, key: object) -> None:
        """Insert ``key`` at the head of list ``i`` and re-apportion shares.

        Adding ``i`` to P(n) deflates every other holder (never triggers
        evictions on them) and charges ``l/|P(n)|`` to ``i``.
        """
        assert not self.in_list(i, key)
        hs = self.holders.get(key)
        l = self.length[key]
        if hs:
            p_old = len(hs)
            p_new = p_old + 1
            delta = l * (self._scale // p_new) - l * (self._scale // p_old)
            for j in hs:
                self.vlen_scaled[j] += delta  # deflation: delta < 0
            hs.add(i)
            self.vlen_scaled[i] += l * (self._scale // p_new)
        else:
            self.holders[key] = {i}
            self.vlen_scaled[i] += l * self._scale
            if key in self.ghosts:  # resurrected ghost
                del self.ghosts[key]
        self._list_insert_head(i, key)
        if self.event_hook is not None:
            self.event_hook("attach", i, key)

    def _detach(self, i: int, key: object) -> bool:
        """Remove ``key`` from list ``i``; inflate remaining holders.

        Returns True if the object reached holder consensus (P(n) empty).
        """
        self._list_remove(i, key)
        if self.event_hook is not None:
            self.event_hook("detach", i, key)
        hs = self.holders[key]
        l = self.length[key]
        p_old = len(hs)
        hs.discard(i)
        self.vlen_scaled[i] -= l * (self._scale // p_old)
        if hs:
            p_new = p_old - 1
            delta = l * (self._scale // p_new) - l * (self._scale // p_old)
            for j in hs:
                self.vlen_scaled[j] += delta  # inflation: delta > 0
            return False
        del self.holders[key]
        return True

    def _physical_evict(self, key: object) -> None:
        if self.physical_evict_hook is not None:
            self.physical_evict_hook(key)
        self.ghosts.pop(key, None)
        self.phys_used -= self.length.pop(key)

    def _consensus(self, key: object) -> bool:
        """Handle P(n) -> empty: ghost-retain or physically evict.

        Returns True if the object physically left the cache.
        """
        if self.ghost_retention:
            self.ghosts[key] = None
            return False
        self._physical_evict(key)
        return True

    def _make_physical_room(self, need: int, exclude: object = None) -> None:
        """Evict ghosts (LRU order) to make ``need`` bytes fit if possible.

        A transient overshoot beyond ``B`` is permitted *between* the
        store and the eviction loop of one ``set`` (the bookkeeping
        mirrors MCD-OS, which links the item before trimming LRUs); it is
        reconciled by :meth:`_reconcile_physical` immediately after the
        loop, which always succeeds because held bytes <= sum(b_i) <= B.

        ``exclude`` protects the object a ``set`` is currently updating:
        evicting it mid-update would corrupt the length accounting.
        """
        while self.phys_used + need > self.B and self.ghosts:
            victims = iter(self.ghosts)
            victim = next(victims)
            if victim == exclude:
                victim = next(victims, None)
                if victim is None:
                    return
            self._physical_evict(victim)

    def _reconcile_physical(self) -> None:
        while self.phys_used > self.B and self.ghosts:
            self._physical_evict(next(iter(self.ghosts)))
        assert self.phys_used <= self.B, (
            "physical cache overfull after eviction loop — violates "
            "sum(b_i) <= B invariant"
        )

    def _eviction_loop(self, trigger: int) -> List[EvictionEvent]:
        """The paper's operator loop, with RRE thresholds (Section IV-D).

        The triggering list is trimmed to ``b_trigger`` (primary
        evictions); every other list only beyond ``b_hat`` (ripple
        evictions). With ``ripple_allocations`` unset, ``b_hat == b`` and
        this is exactly the base loop of Section III.
        """
        events: List[EvictionEvent] = []
        while True:
            worst, worst_over = -1, 0
            for i in range(self.J):
                limit = self.b_scaled[i] if i == trigger else self.b_hat_scaled[i]
                over = self.vlen_scaled[i] - limit
                if over > worst_over:
                    worst, worst_over = i, over
            if worst < 0:
                return events
            victim = self._list_victim(worst)  # tail = lowest rank
            consensus = self._detach(worst, victim)
            phys = self._consensus(victim) if consensus else False
            events.append(
                EvictionEvent(
                    proxy=worst,
                    key=victim,
                    trigger_proxy=trigger,
                    ripple=(worst != trigger),
                    physical=phys,
                )
            )

    def enforce(self, trigger: Optional[int] = None) -> List[EvictionEvent]:
        """Run the eviction loop outside of a request (delayed batch mode:
        trim every list to its *primary* allocation ``b``)."""
        events: List[EvictionEvent] = []
        while True:
            worst, worst_over = -1, 0
            for i in range(self.J):
                over = self.vlen_scaled[i] - self.b_scaled[i]
                if over > worst_over:
                    worst, worst_over = i, over
            if worst < 0:
                return events
            victim = self._list_victim(worst)
            consensus = self._detach(worst, victim)
            phys = self._consensus(victim) if consensus else False
            events.append(
                EvictionEvent(
                    proxy=worst,
                    key=victim,
                    trigger_proxy=trigger if trigger is not None else worst,
                    ripple=(trigger is not None and worst != trigger),
                    physical=phys,
                )
            )

    # ------------------------------------------------------------------
    # Public API (paper Table IV semantics)
    # ------------------------------------------------------------------
    def get(self, i: int, key: object) -> RequestStats:
        """Proxy ``i`` issues ``get(key)``.

        * hit in LRU-list i  -> promote, nothing else (HIT_LIST);
        * miss in list i but physically cached -> insert at head of list
          i, deflate other holders, run the eviction loop (HIT_CACHE);
        * miss everywhere -> MISS: the caller (client) is expected to
          fetch from the database and issue ``set`` (MCD-OS semantics) —
          or use :meth:`get_autofetch` for the Section-III abstract model.
        """
        self.n_get += 1
        if key in self.lists[i]:
            self.n_hit_list += 1
            self._promote(i, key)
            return RequestStats(GetResult.HIT_LIST)
        if key in self.length:
            self.n_hit_cache += 1
            self._attach(i, key)
            events = self._eviction_loop(trigger=i)
            return RequestStats(GetResult.HIT_CACHE, events)
        self.n_miss += 1
        return RequestStats(GetResult.MISS)

    def set(self, i: int, key: object, length: int) -> RequestStats:
        """Proxy ``i`` issues ``set(key, value)`` (Table IV).

        New key: store physically, charge full length to list i.
        Existing key: update value (length may change), promote/insert to
        head of list i, re-apportion shares of all holders.
        """
        self.n_set += 1
        length = int(length)
        if length <= 0:
            raise ValueError("object length must be a positive integer")
        if key not in self.length:
            self._make_physical_room(length)
            self.length[key] = length
            self.phys_used += length
            self._attach(i, key)
            events = self._eviction_loop(trigger=i)
            self._reconcile_physical()
            return RequestStats(GetResult.MISS, events)

        old_len = self.length[key]
        if length != old_len:
            # Update in place: adjust every holder's share; physical usage.
            if length > old_len:
                self._make_physical_room(length - old_len, exclude=key)
            self.phys_used += length - old_len
            self.length[key] = length
            hs = self.holders.get(key)
            if hs:
                p = len(hs)
                delta = (length - old_len) * (self._scale // p)
                for j in hs:
                    self.vlen_scaled[j] += delta
        if key in self.lists[i]:
            self._promote(i, key)
        else:
            self._attach(i, key)
        events = self._eviction_loop(trigger=i)
        self._reconcile_physical()
        return RequestStats(
            GetResult.HIT_LIST if key in self.lists[i] else GetResult.MISS,
            events,
        )

    def get_autofetch(self, i: int, key: object, length: int) -> RequestStats:
        """Section-III abstract model: a miss is immediately followed by a
        database fetch + store (the simulator's one-call convenience)."""
        st = self.get(i, key)
        if st.result is GetResult.MISS:
            st2 = self.set(i, key, length)
            return RequestStats(GetResult.MISS, st2.evictions)
        return st

    # ------------------------------------------------------------------
    def __repr__(self) -> str:  # pragma: no cover
        lists = ", ".join(
            f"L{i}:{len(self.lists[i])}obj/{self.vlen(i):.1f}u" for i in range(self.J)
        )
        return (
            f"SharedLRUCache(J={self.J}, B={self.B}, used={self.phys_used}, "
            f"ghosts={len(self.ghosts)}, {lists})"
        )
