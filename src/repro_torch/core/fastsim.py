"""Array-based fast simulation engine for the shared-LRU system.

This module is the Monte-Carlo workhorse behind Tables I/III, Fig. 2,
Table V and the RRE/S-LRU studies. It implements exactly the semantics of
:class:`repro_torch.core.shared_lru.SharedLRUCache` (the executable reference
spec — kept, and proven equivalent event-for-event by
``tests/test_fastsim.py``) but in a struct-of-arrays (SoA) layout with no
per-object Python objects, dict churn, or hook dispatch.

SoA layout
----------
All J LRU-lists are intrusive doubly-linked lists threaded through
preallocated flat ``(J*N,)`` int vectors over the object ids ``0..N-1``:

* ``nxt[i*N + k]`` / ``prv[i*N + k]`` — neighbour of object ``k`` in list
  ``i`` toward the head (MRU) / tail (LRU); ``-1`` terminates.
* ``head[i]`` / ``tail[i]`` — MRU / LRU object of list ``i`` (``-1`` =
  empty).
* ``hmask[k]`` — the holder set P(k) as a bitmask over proxies;
  ``hmask[k] >> i & 1`` doubles as the "k in list i" membership test and
  ``hmask[k].bit_count()`` is |P(k)|.
* ``length[k]`` — l_k for physically-resident objects (0 = not cached),
  ``phys_used`` their sum.
* ``vlen_scaled[i]`` — virtual list lengths in the reference engine's
  exact lcm-scaled integer arithmetic (``M = lcm(1..J)``; a holder's
  share of ``k`` is ``length[k] * (M // |P(k)|)``). No float drift.
* ``gnxt / gprv / ghead / gtail / isghost`` — one more intrusive linked
  list holding consensus-evicted "ghosts" in LRU order.
* ``res_since / tot_time`` — per ``(i, k)`` residence-interval
  accumulators: the PASTA occupancy estimator of
  :class:`repro_torch.core.metrics.OccupancyRecorder` computed inline (under
  the IRM, hit probability == time-average occupancy).

The canonical state lives in plain CPython ``list``s of ints (int64
range; materialize numpy views via :meth:`FastSharedLRU.arrays`).
CPython scalar indexing on lists is ~5x faster than on numpy arrays,
which is where the throughput comes from: the batch driver
:func:`simulate_trace` flattens every ``get``/``set``/attach/detach/
eviction-loop into one allocation-free interpreter loop over these
vectors, and only the (J, N) estimator outputs are numpy.

Streaming + sparse occupancy (Section VI-C scale)
-------------------------------------------------
The whole-trace drivers do NOT allocate the dense ``(J, N)``
per-(proxy, object) vectors above: the Python and C drive loops index
list pointers and occupancy accumulators through a sparse touched-set
(``slot[k] * J + i``) where objects earn a slot on first entry into any
list, so engine state scales with the touched catalogue and untouched
objects contribute exactly zero occupancy. :func:`simulate_chunks`
feeds the request stream chunk by chunk (``Workload.iter_chunks`` /
:func:`~repro_torch.core.irm.sample_trace_chunks`) with engine state resident
across chunks in every backend — the trace is never materialized — and
returns occupancy as a :class:`SparseOccupancy` (indices, values) pair.
Chunked + sparse runs are bit-identical to one-shot dense runs
(``tests/test_streaming.py``); the CUDA lane engine
(:mod:`repro_torch.core.fastsim_cuda`) carries dense int32 state between
chunks (fixed-shape buffers) but produces the same outputs.

Which engine to use
-------------------
* ``SharedLRUCache`` / ``SegmentedSharedLRUCache`` — the readable
  reference spec: per-request stats objects, hooks for external
  recorders, arbitrary hashable keys. Use for unit tests, small traces,
  and anything needing the hook API.
* ``FastSharedLRU`` (this module) — integer keys ``0..N-1``, same
  per-operation API (`get`/`set`/`get_autofetch`/`enforce`), ~an order
  of magnitude faster; use :func:`simulate_trace` for whole-trace
  Monte-Carlo runs (``benchmarks/bench_simthroughput.py`` tracks the
  speedup; >=10x on the Table-I workload).

Variants: ``SimParams(variant="slru")`` runs the memcached HOT/WARM/COLD
segmented lists of :mod:`repro_torch.core.slru`; ``variant="noshare"`` runs J
independent full-length-charging LRUs (the Table-III baseline);
``variant="pooled"`` runs one collective LRU of the combined size with
per-proxy hit accounting (the no-isolation upper envelope, cf. Dehghan
et al.'s pooled sharing); ``ripple_allocations`` + ``batch_interval``
cover the Section IV-D RRE mechanisms.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.device import DeviceLike

from .irm import IRMTrace
from .shared_lru import GetResult, _lcm_1_to

NIL = -1

# Evictions-per-set histogram buckets, shared by every backend (the last
# bucket clamps). Identical clamping keeps evictions_per_set
# bit-identical across the Python, C, and CUDA drivers.
HIST_BUCKETS = 1024

# Eviction event tuple: (proxy, key, ripple, physical) — the array
# engine's allocation-light analogue of shared_lru.EvictionEvent.
EventTuple = Tuple[int, int, bool, bool]


class FastSharedLRU:
    """Array-backed object-sharing cache over integer keys ``0..N-1``.

    Mirrors :class:`repro_torch.core.shared_lru.SharedLRUCache` operation for
    operation (same eviction order, same ghost handling, same RRE
    thresholds); ``get``/``set`` return ``(GetResult, [(proxy, key,
    ripple, physical), ...])`` instead of ``RequestStats``.
    """

    def __init__(
        self,
        n_objects: int,
        allocations: Sequence[int],
        physical_capacity: Optional[int] = None,
        *,
        ghost_retention: bool = True,
        ripple_allocations: Optional[Sequence[int]] = None,
    ) -> None:
        self.J = len(allocations)
        if self.J < 1:
            raise ValueError("need at least one proxy")
        if self.J > 62:
            raise ValueError("holder bitmask supports at most 62 proxies")
        self.N = int(n_objects)
        if self.N < 1:
            raise ValueError("need at least one object")
        self._scale = _lcm_1_to(self.J)
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

        J, N = self.J, self.N
        # share[p] = M // p: scaled per-holder multiplier for |P(k)| = p.
        self.share = [0] + [self._scale // p for p in range(1, J + 1)]
        self.nxt = [NIL] * (J * N)
        self.prv = [NIL] * (J * N)
        self.head = [NIL] * J
        self.tail = [NIL] * J
        self.hmask = [0] * N
        self.length = [0] * N
        self.vlen_scaled = [0] * J
        self.phys_used = 0
        self.gnxt = [NIL] * N
        self.gprv = [NIL] * N
        self.ghead = NIL
        self.gtail = NIL
        self.isghost = [False] * N
        self.n_ghosts = 0

        # Inline PASTA occupancy accumulators (OccupancyRecorder semantics).
        self.res_since = [-1] * (J * N)
        self.tot_time = [0] * (J * N)
        self.now = 0
        self.t_start = 0

        self.n_get = 0
        self.n_set = 0
        self.n_hit_list = 0
        self.n_hit_cache = 0
        self.n_miss = 0

    # ------------------------------------------------------------------
    # Introspection (API-compatible with the reference engine)
    # ------------------------------------------------------------------
    def vlen(self, i: int) -> float:
        return self.vlen_scaled[i] / self._scale

    def share_of(self, k: int) -> float:
        p = self.hmask[k].bit_count()
        return self.length[k] / p if p else 0.0

    def in_list(self, i: int, k: int) -> bool:
        return bool(self.hmask[k] >> i & 1)

    def in_physical(self, k: int) -> bool:
        return self.length[k] > 0

    def list_keys(self, i: int) -> List[int]:
        """Keys of list ``i`` from tail (LRU) to head (MRU)."""
        out, base = [], i * self.N
        k = self.tail[i]
        while k != NIL:
            out.append(k)
            k = self.nxt[base + k]
        return out

    def ghost_keys(self) -> List[int]:
        """Ghosts from oldest (next-to-evict) to newest."""
        out, g = [], self.ghead
        while g != NIL:
            out.append(g)
            g = self.gnxt[g]
        return out

    def arrays(self) -> dict:
        """Materialize the SoA state as named int64 numpy arrays."""
        J, N = self.J, self.N
        return {
            "prev": np.asarray(self.prv, dtype=np.int64).reshape(J, N),
            "next": np.asarray(self.nxt, dtype=np.int64).reshape(J, N),
            "head": np.asarray(self.head, dtype=np.int64),
            "tail": np.asarray(self.tail, dtype=np.int64),
            "holders": np.asarray(self.hmask, dtype=np.int64),
            "length": np.asarray(self.length, dtype=np.int64),
            "vlen_scaled": np.asarray(self.vlen_scaled, dtype=np.int64),
        }

    # ------------------------------------------------------------------
    # List-structure ops (overridden by the segmented variant)
    # ------------------------------------------------------------------
    def _list_insert_head(self, i: int, k: int) -> None:
        base = i * self.N
        h = self.head[i]
        if h == NIL:
            self.tail[i] = k
        else:
            self.nxt[base + h] = k
        self.prv[base + k] = h
        self.nxt[base + k] = NIL
        self.head[i] = k

    def _list_remove(self, i: int, k: int) -> None:
        base = i * self.N
        ik = base + k
        p, nx = self.prv[ik], self.nxt[ik]
        if p == NIL:
            self.tail[i] = nx
        else:
            self.nxt[base + p] = nx
        if nx == NIL:
            self.head[i] = p
        else:
            self.prv[base + nx] = p

    def _list_promote(self, i: int, k: int) -> None:
        if self.head[i] != k:
            self._list_remove(i, k)
            self._list_insert_head(i, k)

    def _list_victim(self, i: int) -> int:
        return self.tail[i]

    # ------------------------------------------------------------------
    # Sharing mutations (exact mirrors of the reference engine)
    # ------------------------------------------------------------------
    def _occ_attach(self, ik: int) -> None:
        self.res_since[ik] = self.now

    def _occ_detach(self, ik: int) -> None:
        since = self.res_since[ik]
        if since >= 0:
            self.tot_time[ik] += self.now - (
                since if since > self.t_start else self.t_start
            )
            self.res_since[ik] = -1

    def _ghost_unlink(self, k: int) -> None:
        p, nx = self.gprv[k], self.gnxt[k]
        if p == NIL:
            self.ghead = nx
        else:
            self.gnxt[p] = nx
        if nx == NIL:
            self.gtail = p
        else:
            self.gprv[nx] = p
        self.isghost[k] = False
        self.n_ghosts -= 1

    def _attach(self, i: int, k: int) -> None:
        l = self.length[k]
        m = self.hmask[k]
        if m:
            p_old = m.bit_count()
            delta = l * self.share[p_old + 1] - l * self.share[p_old]
            mm = m
            while mm:
                j = (mm & -mm).bit_length() - 1
                self.vlen_scaled[j] += delta  # deflation: delta < 0
                mm &= mm - 1
            self.hmask[k] = m | (1 << i)
            self.vlen_scaled[i] += l * self.share[p_old + 1]
        else:
            self.hmask[k] = 1 << i
            self.vlen_scaled[i] += l * self._scale
            if self.isghost[k]:  # resurrected ghost
                self._ghost_unlink(k)
        self._list_insert_head(i, k)
        self._occ_attach(i * self.N + k)

    def _detach(self, i: int, k: int) -> bool:
        self._list_remove(i, k)
        self._occ_detach(i * self.N + k)
        m = self.hmask[k]
        l = self.length[k]
        p_old = m.bit_count()
        m &= ~(1 << i)
        self.hmask[k] = m
        self.vlen_scaled[i] -= l * self.share[p_old]
        if m:
            delta = l * self.share[p_old - 1] - l * self.share[p_old]
            mm = m
            while mm:
                j = (mm & -mm).bit_length() - 1
                self.vlen_scaled[j] += delta  # inflation: delta > 0
                mm &= mm - 1
            return False
        return True

    def _physical_evict(self, k: int) -> None:
        if self.isghost[k]:
            self._ghost_unlink(k)
        self.phys_used -= self.length[k]
        self.length[k] = 0

    def _consensus(self, k: int) -> bool:
        if self.ghost_retention:
            if self.gtail == NIL:
                self.ghead = k
            else:
                self.gnxt[self.gtail] = k
            self.gprv[k] = self.gtail
            self.gnxt[k] = NIL
            self.gtail = k
            self.isghost[k] = True
            self.n_ghosts += 1
            return False
        self._physical_evict(k)
        return True

    def _make_physical_room(self, need: int, exclude: int = NIL) -> None:
        while self.phys_used + need > self.B and self.ghead != NIL:
            victim = self.ghead
            if victim == exclude:
                victim = self.gnxt[victim]
                if victim == NIL:
                    return
            self._physical_evict(victim)

    def _reconcile_physical(self) -> None:
        while self.phys_used > self.B and self.ghead != NIL:
            self._physical_evict(self.ghead)
        assert self.phys_used <= self.B, (
            "physical cache overfull after eviction loop — violates "
            "sum(b_i) <= B invariant"
        )

    def _eviction_loop(self, trigger: int) -> List[EventTuple]:
        events: List[EventTuple] = []
        vlen = self.vlen_scaled
        while True:
            worst, worst_over = -1, 0
            for i in range(self.J):
                limit = self.b_scaled[i] if i == trigger else self.b_hat_scaled[i]
                over = vlen[i] - limit
                if over > worst_over:
                    worst, worst_over = i, over
            if worst < 0:
                return events
            v = self._list_victim(worst)
            consensus = self._detach(worst, v)
            phys = self._consensus(v) if consensus else False
            events.append((worst, v, worst != trigger, phys))

    def enforce(self, trigger: Optional[int] = None) -> List[EventTuple]:
        """Trim every list to its *primary* allocation (RRE batch mode)."""
        events: List[EventTuple] = []
        vlen = self.vlen_scaled
        while True:
            worst, worst_over = -1, 0
            for i in range(self.J):
                over = vlen[i] - self.b_scaled[i]
                if over > worst_over:
                    worst, worst_over = i, over
            if worst < 0:
                return events
            v = self._list_victim(worst)
            consensus = self._detach(worst, v)
            phys = self._consensus(v) if consensus else False
            events.append(
                (worst, v, trigger is not None and worst != trigger, phys)
            )

    # ------------------------------------------------------------------
    # Public per-operation API (paper Table IV semantics)
    # ------------------------------------------------------------------
    def get(self, i: int, k: int) -> Tuple[GetResult, List[EventTuple]]:
        self.n_get += 1
        if self.hmask[k] >> i & 1:
            self.n_hit_list += 1
            self._list_promote(i, k)
            return (GetResult.HIT_LIST, [])
        if self.length[k] > 0:
            self.n_hit_cache += 1
            self._attach(i, k)
            return (GetResult.HIT_CACHE, self._eviction_loop(i))
        self.n_miss += 1
        return (GetResult.MISS, [])

    def set(self, i: int, k: int, length: int) -> Tuple[GetResult, List[EventTuple]]:
        self.n_set += 1
        length = int(length)
        if length <= 0:
            raise ValueError("object length must be a positive integer")
        if self.length[k] == 0:
            self._make_physical_room(length)
            self.length[k] = length
            self.phys_used += length
            self._attach(i, k)
            events = self._eviction_loop(i)
            self._reconcile_physical()
            return (GetResult.MISS, events)

        old_len = self.length[k]
        if length != old_len:
            if length > old_len:
                self._make_physical_room(length - old_len, exclude=k)
            self.phys_used += length - old_len
            self.length[k] = length
            m = self.hmask[k]
            if m:
                delta = (length - old_len) * self.share[m.bit_count()]
                while m:
                    j = (m & -m).bit_length() - 1
                    self.vlen_scaled[j] += delta
                    m &= m - 1
        if self.hmask[k] >> i & 1:
            self._list_promote(i, k)
        else:
            self._attach(i, k)
        events = self._eviction_loop(i)
        self._reconcile_physical()
        return (
            GetResult.HIT_LIST if self.hmask[k] >> i & 1 else GetResult.MISS,
            events,
        )

    def get_autofetch(
        self, i: int, k: int, length: int
    ) -> Tuple[GetResult, List[EventTuple]]:
        res, events = self.get(i, k)
        if res is GetResult.MISS:
            _, events = self.set(i, k, length)
            return (GetResult.MISS, events)
        return (res, events)

    # ------------------------------------------------------------------
    # Occupancy-recorder controls (OccupancyRecorder semantics, inline)
    # ------------------------------------------------------------------
    def reset_window(self) -> None:
        self.tot_time = [0] * (self.J * self.N)
        self.t_start = self.now

    def finalize(self) -> None:
        now = self.now
        res_since, tot_time, t_start = self.res_since, self.tot_time, self.t_start
        for ik in range(self.J * self.N):
            since = res_since[ik]
            if since >= 0:
                tot_time[ik] += now - (since if since > t_start else t_start)
                res_since[ik] = now

    def occupancy(self) -> np.ndarray:
        horizon = max(self.now - self.t_start, 1)
        return (
            np.asarray(self.tot_time, dtype=np.int64).reshape(self.J, self.N)
            / horizon
        )

    # ------------------------------------------------------------------
    def check_invariants(self) -> None:
        """Structural + accounting invariants. O(J*N)."""
        J, N = self.J, self.N
        recomputed = [0] * J
        listed = [set() for _ in range(J)]
        for i in range(J):
            base = i * N
            k, prev_k, count = self.tail[i], NIL, 0
            while k != NIL:
                assert self.prv[base + k] == prev_k, (i, k)
                assert self.hmask[k] >> i & 1, f"{k} linked in {i} but not holder"
                listed[i].add(k)
                prev_k, k = k, self.nxt[base + k]
                count += 1
                assert count <= N, f"cycle in list {i}"
            assert self.head[i] == prev_k, i
        for k in range(N):
            m = self.hmask[k]
            if m:
                assert self.length[k] > 0, f"held object {k} not resident"
                assert not self.isghost[k], k
                p = m.bit_count()
                share = self.length[k] * (self._scale // p)
                mm = m
                while mm:
                    j = (mm & -mm).bit_length() - 1
                    assert k in listed[j], (k, j)
                    recomputed[j] += share
                    mm &= mm - 1
        for i in range(J):
            assert recomputed[i] == self.vlen_scaled[i], (
                f"list {i}: recomputed {recomputed[i]} != "
                f"tracked {self.vlen_scaled[i]}"
            )
            assert self.vlen_scaled[i] <= self.b_hat_scaled[i], (
                f"list {i} over allocation: {self.vlen(i)} > {self.b_hat[i]}"
            )
        assert self.phys_used == sum(self.length)
        assert self.phys_used <= self.B
        ghosts = self.ghost_keys()
        assert len(ghosts) == self.n_ghosts
        for g in ghosts:
            assert self.isghost[g] and self.length[g] > 0 and self.hmask[g] == 0
        assert sum(self.isghost) == self.n_ghosts


HOT, WARM, COLD = 0, 1, 2


class FastSegmentedSharedLRU(FastSharedLRU):
    """Array-backed S-LRU variant (memcached HOT/WARM/COLD, paper §VII).

    Mirrors :class:`repro_torch.core.slru.SegmentedSharedLRUCache`: the three
    segments of each proxy are intrusive linked lists threaded through
    the same ``nxt``/``prv`` vectors (an object sits in exactly one
    segment per proxy), with per-(proxy, segment) heads/tails/counts and
    flat ``seg_of`` / ``hits`` / ``active`` metadata vectors.
    """

    def __init__(
        self,
        n_objects: int,
        allocations: Sequence[int],
        physical_capacity: Optional[int] = None,
        *,
        hot_frac: float = 0.32,
        warm_frac: float = 0.32,
        **kw,
    ) -> None:
        if not (0.0 < hot_frac < 1.0 and 0.0 < warm_frac < 1.0):
            raise ValueError("segment fractions must be in (0, 1)")
        if hot_frac + warm_frac >= 1.0:
            raise ValueError("hot_frac + warm_frac must be < 1")
        super().__init__(n_objects, allocations, physical_capacity, **kw)
        self.hot_frac = hot_frac
        self.warm_frac = warm_frac
        J, N = self.J, self.N
        self.shead = [NIL] * (J * 3)
        self.stail = [NIL] * (J * 3)
        self.scnt = [0] * (J * 3)
        self.seg_of = [NIL] * (J * N)
        self.hits = [0] * (J * N)
        self.active = [False] * (J * N)

    # -- segment primitives -------------------------------------------------
    def _seg_insert_head(self, i: int, s: int, k: int) -> None:
        base, sb = i * self.N, i * 3 + s
        h = self.shead[sb]
        if h == NIL:
            self.stail[sb] = k
        else:
            self.nxt[base + h] = k
        self.prv[base + k] = h
        self.nxt[base + k] = NIL
        self.shead[sb] = k
        self.scnt[sb] += 1
        self.seg_of[base + k] = s

    def _seg_remove(self, i: int, s: int, k: int) -> None:
        base, sb = i * self.N, i * 3 + s
        ik = base + k
        p, nx = self.prv[ik], self.nxt[ik]
        if p == NIL:
            self.stail[sb] = nx
        else:
            self.nxt[base + p] = nx
        if nx == NIL:
            self.shead[sb] = p
        else:
            self.prv[base + nx] = p
        self.scnt[sb] -= 1

    def _age(self, i: int) -> None:
        sb = i * 3
        base = i * self.N
        total = self.scnt[sb] + self.scnt[sb + 1] + self.scnt[sb + 2]
        if total == 0:
            return
        hot_cap = max(1, int(self.hot_frac * total))
        warm_cap = max(1, int(self.warm_frac * total))
        while self.scnt[sb + HOT] > hot_cap:
            k = self.stail[sb + HOT]  # oldest HOT
            self._seg_remove(i, HOT, k)
            dest = WARM if self.hits[base + k] >= 2 else COLD
            self._seg_insert_head(i, dest, k)
        while self.scnt[sb + WARM] > warm_cap:
            k = self.stail[sb + WARM]  # oldest WARM
            self._seg_remove(i, WARM, k)
            if self.active[base + k]:
                self.active[base + k] = False
                self._seg_insert_head(i, WARM, k)  # one FIFO re-queue
            else:
                self._seg_insert_head(i, COLD, k)

    # -- list-structure hook overrides --------------------------------------
    def _list_insert_head(self, i: int, k: int) -> None:
        self._seg_insert_head(i, HOT, k)
        self.hits[i * self.N + k] = 1
        self._age(i)

    def _list_remove(self, i: int, k: int) -> None:
        ik = i * self.N + k
        self._seg_remove(i, self.seg_of[ik], k)
        self.seg_of[ik] = NIL
        self.hits[ik] = 0
        self.active[ik] = False

    def _list_promote(self, i: int, k: int) -> None:
        ik = i * self.N + k
        self.hits[ik] += 1
        seg = self.seg_of[ik]
        if seg == HOT:
            if self.shead[i * 3 + HOT] != k:
                self._seg_remove(i, HOT, k)
                self._seg_insert_head(i, HOT, k)
        elif seg == WARM:
            self.active[ik] = True  # FIFO: mark touched, no reorder
        else:  # COLD hit -> promote to WARM head
            self._seg_remove(i, COLD, k)
            self._seg_insert_head(i, WARM, k)
            self._age(i)

    def _list_victim(self, i: int) -> int:
        sb = i * 3
        for s in (COLD, WARM, HOT):
            if self.scnt[sb + s]:
                return self.stail[sb + s]
        raise RuntimeError(f"victim requested from empty list {i}")

    # -- introspection overrides --------------------------------------------
    def list_keys(self, i: int) -> List[int]:
        """Tail-to-head across COLD, WARM, HOT (eviction order)."""
        out, base = [], i * self.N
        for s in (COLD, WARM, HOT):
            k = self.stail[i * 3 + s]
            while k != NIL:
                out.append(k)
                k = self.nxt[base + k]
        return out

    def segment_of(self, i: int, k: int) -> str:
        return ("HOT", "WARM", "COLD")[self.seg_of[i * self.N + k]]

    def check_invariants(self) -> None:  # pragma: no cover - debug aid
        # Segment counts must tile each proxy's membership; reuse the
        # base accounting checks via a temporary flat reconstruction.
        for i in range(self.J):
            keys = self.list_keys(i)
            assert len(keys) == len(set(keys))
            assert len(keys) == sum(self.scnt[i * 3 : i * 3 + 3])
            for k in keys:
                assert self.hmask[k] >> i & 1
        recomputed = [0] * self.J
        for k in range(self.N):
            m = self.hmask[k]
            if m:
                p = m.bit_count()
                share = self.length[k] * (self._scale // p)
                while m:
                    j = (m & -m).bit_length() - 1
                    recomputed[j] += share
                    m &= m - 1
        assert recomputed == self.vlen_scaled
        assert self.phys_used == sum(self.length) and self.phys_used <= self.B


# ---------------------------------------------------------------------------
# Batch simulation API
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SimParams:
    """Configuration of one Monte-Carlo run of the shared-LRU system."""

    allocations: Tuple[int, ...]
    physical_capacity: Optional[int] = None
    ghost_retention: bool = True
    ripple_allocations: Optional[Tuple[int, ...]] = None  # RRE b_hat
    variant: str = "lru"  # "lru" | "slru" | "noshare" | "pooled"
    hot_frac: float = 0.32
    warm_frac: float = 0.32
    batch_interval: int = 0  # sets between RRE batch trims (0 = off)

    def make_engine(self, n_objects: int) -> FastSharedLRU:
        if self.variant == "slru":
            return FastSegmentedSharedLRU(
                n_objects,
                list(self.allocations),
                self.physical_capacity,
                hot_frac=self.hot_frac,
                warm_frac=self.warm_frac,
                ghost_retention=self.ghost_retention,
                ripple_allocations=(
                    list(self.ripple_allocations)
                    if self.ripple_allocations is not None
                    else None
                ),
            )
        if self.variant in ("lru", "noshare"):
            return FastSharedLRU(
                n_objects,
                list(self.allocations),
                self.physical_capacity,
                ghost_retention=self.ghost_retention,
                ripple_allocations=(
                    list(self.ripple_allocations)
                    if self.ripple_allocations is not None
                    else None
                ),
            )
        if self.variant == "pooled":
            raise ValueError(
                "variant='pooled' has no per-operation engine; use "
                "simulate_trace (whole-trace driver) instead"
            )
        raise ValueError(f"unknown variant {self.variant!r}")


@dataclass(frozen=True)
class SparseOccupancy:
    """Touched-set occupancy: ``(indices, values)`` over ``n_objects``.

    The streaming estimator's output representation: ``indices`` holds
    the (sorted, unique) ids of objects with nonzero time-average
    occupancy in at least one list, ``values[i, t]`` the occupancy of
    object ``indices[t]`` in list ``i``. Every object not listed has
    exactly zero occupancy — densifying scatters ``values`` into a
    zero ``(J, N)`` matrix, bit-identical to the dense accumulator
    output of the one-shot path (enforced by ``tests/test_streaming``).
    """

    n_objects: int
    indices: np.ndarray  # (T,) int64, sorted ascending
    values: np.ndarray   # (J, T) float64

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.values.shape[0], self.n_objects)

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    def densify(self) -> np.ndarray:
        """Materialize the full ``(J, N)`` matrix (small N only)."""
        out = np.zeros(
            (self.values.shape[0], self.n_objects), dtype=np.float64
        )
        out[:, self.indices] = self.values
        return out

    def lookup(self, proxy: int, objs) -> np.ndarray:
        """Occupancy of ``objs`` in list ``proxy`` (0 for untouched)."""
        objs = np.atleast_1d(np.asarray(objs, dtype=np.int64))
        out = np.zeros(objs.shape, dtype=np.float64)
        if self.indices.size:
            pos = np.searchsorted(self.indices, objs)
            pos = np.clip(pos, 0, self.indices.size - 1)
            hit = self.indices[pos] == objs
            out[hit] = self.values[proxy, pos[hit]]
        return out


@dataclass
class SimResult:
    """Outputs of :func:`simulate_trace` / :func:`simulate_chunks`."""

    # (J, N) time-average occupancy == IRM hit prob; a SparseOccupancy
    # (indices, values) pair when the run was sparse/streaming.
    occupancy: "np.ndarray | SparseOccupancy"
    n_requests: int
    warmup: int
    n_hit_list: int
    n_hit_cache: int
    n_miss: int
    hits_by_proxy: np.ndarray  # (J,) post-warmup HIT_LIST counts
    reqs_by_proxy: np.ndarray  # (J,) post-warmup request counts
    evictions_per_set: np.ndarray  # histogram: index = evictions in one set
    n_sets_recorded: int
    n_primary: int
    n_ripple: int
    n_batch_evictions: int  # RRE delayed-batch evictions (off request path)
    final_vlen: np.ndarray  # (J,) virtual list lengths at end of trace
    elapsed_s: float
    engine: str = "?"  # backend that actually ran: c | flat | generic | cuda

    @property
    def requests_per_sec(self) -> float:
        return self.n_requests / self.elapsed_s if self.elapsed_s > 0 else float("inf")

    @property
    def occupancy_is_sparse(self) -> bool:
        return isinstance(self.occupancy, SparseOccupancy)

    def dense_occupancy(self) -> np.ndarray:
        """The full ``(J, N)`` occupancy matrix, whatever the run mode
        produced (materializes — use only when N is small)."""
        if isinstance(self.occupancy, SparseOccupancy):
            return self.occupancy.densify()
        return self.occupancy

    @property
    def hit_rate_by_proxy(self) -> np.ndarray:
        """Post-warmup realized hit rate per proxy; NaN for proxies that
        issued no post-warmup requests (short runs with skewed rates)."""
        reqs = self.reqs_by_proxy
        with np.errstate(invalid="ignore"):
            return np.where(
                reqs > 0, self.hits_by_proxy / np.maximum(reqs, 1), np.nan
            )

    @property
    def frac_multi_eviction(self) -> float:
        if self.n_sets_recorded == 0:
            return 0.0
        return float(self.evictions_per_set[2:].sum() / self.n_sets_recorded)

    @property
    def mean_evictions(self) -> float:
        if self.n_sets_recorded == 0:
            return 0.0
        ks = np.arange(len(self.evictions_per_set))
        return float((ks * self.evictions_per_set).sum() / self.n_sets_recorded)

    def histogram(self) -> dict:
        """Fig.-2-style dict {evictions_per_set: count}."""
        return {int(k): int(c) for k, c in enumerate(self.evictions_per_set)}


def default_warmup(n_requests: int, allocations: Sequence[int]) -> int:
    """The Table-I warmup heuristic used across the benchmarks."""
    return max(n_requests // 15, 10 * sum(allocations))


def simulate_trace(
    params: SimParams,
    trace: IRMTrace,
    n_objects: int,
    *,
    lengths: Optional[np.ndarray] = None,
    warmup: Optional[int] = None,
    ripple_from: Optional[int] = None,
    engine: str = "auto",
    sparse: bool = False,
    device: DeviceLike = None,
) -> SimResult:
    """Drive a whole IRM trace through the array engine in one call.

    MCD client semantics per request: ``get(i, k)``; on MISS, fetch and
    ``set(i, k, l_k)``. Residence-time occupancy is accumulated inline
    (window reset at ``warmup``), ripple statistics from ``ripple_from``
    (default: ``warmup``) onward.

    ``engine="auto"`` is :func:`pick_engine`'s choice: the CUDA lane
    engine (:mod:`repro_torch.core.fastsim_cuda`) on ``device`` for the
    flat shared LRU without delayed batching inside the lane engine's
    int32 envelope; elsewhere a host engine — the native C loop
    (:mod:`repro_torch.core.fastsim_c`, compiled on demand with the
    system compiler) for the flat shared-LRU and not-shared variants,
    the allocation-free inlined Python loop when no C compiler is
    around, and the generic per-operation loop for the segmented
    variant. ``engine="c"`` / ``"flat"`` / ``"generic"`` / ``"cuda"``
    force a specific backend (the equivalence tests diff them against
    each other). The lane engine runs on ``device``: ``None`` is the
    CUDA card (raises without one), ``"cpu"`` runs the same step body
    built for the host. A failed build or launch raises; nothing gives
    way to a host engine.

    ``sparse=True`` returns occupancy as a :class:`SparseOccupancy`
    (indices, values) pair instead of the dense ``(J, N)`` matrix; the
    densified result is bit-identical. This is a single-chunk call of
    :func:`simulate_chunks` — use that directly to stream a trace that
    should never be materialized in full.
    """
    return simulate_chunks(
        params,
        (trace,),
        n_objects,
        len(trace),
        lengths=lengths,
        warmup=warmup,
        ripple_from=ripple_from,
        engine=engine,
        sparse=sparse,
        device=device,
    )


def simulate_chunks(
    params: SimParams,
    chunks,
    n_objects: int,
    n_requests: int,
    *,
    lengths: Optional[np.ndarray] = None,
    warmup: Optional[int] = None,
    ripple_from: Optional[int] = None,
    engine: str = "auto",
    sparse: bool = True,
    device: DeviceLike = None,
) -> SimResult:
    """Drive a *streamed* request trace through the array engine.

    ``chunks`` is any iterable of :class:`~repro_torch.core.irm.IRMTrace`
    pieces (e.g. ``Workload.iter_chunks`` or
    :func:`~repro_torch.core.irm.sample_trace_chunks`) whose concatenation is
    the full trace of ``n_requests`` requests; it is consumed lazily, so
    peak memory is O(chunk + engine state) — the Section VI-C scaling
    path for huge catalogues. Engine state stays resident between chunks
    in every backend (the C backend via its incremental ``drive_chunk``
    entry point, the CUDA lane engine via carried device state), and the per-(proxy,
    object) accumulators of the flat shared-LRU drivers are a sparse
    touched-set: only objects that ever enter a list get slots, so state
    scales with the touched catalogue, not ``J * N``. Results are
    bit-identical to :func:`simulate_trace` on the one-shot trace
    regardless of chunk boundaries (enforced by ``tests/test_streaming``).

    ``n_requests`` must equal the total chunk length (it fixes the
    default warmup before the stream is consumed). With ``sparse=True``
    (default) occupancy comes back as :class:`SparseOccupancy`.
    ``engine="auto"`` resolves as in :func:`simulate_trace`; ``device``
    is read only by the lane engine.
    """
    if engine not in ("auto", "c", "flat", "generic", "cuda"):
        raise ValueError(
            f"unknown engine {engine!r}; options: auto, c, flat, generic, cuda"
        )
    _validate_params(params)
    allowed = _ENGINES_BY_VARIANT[params.variant]
    if engine != "auto" and engine not in allowed:
        raise ValueError(
            f"engine {engine!r} does not support variant {params.variant!r}; "
            f"options: auto, {', '.join(allowed)}"
        )
    n = int(n_requests)
    N = int(n_objects)
    if warmup is None:
        warmup = default_warmup(n, params.allocations)
    warmup = min(warmup, n)
    if ripple_from is None:
        ripple_from = warmup
    if lengths is None:
        lengths_a = np.ones(N, dtype=np.int64)
    else:
        lengths_a = np.ascontiguousarray(np.asarray(lengths), dtype=np.int64)
        if lengths_a.ndim != 1 or len(lengths_a) != N:
            raise ValueError("lengths must have one entry per object")
        if (lengths_a <= 0).any():
            raise ValueError("object lengths must be positive")

    J = len(params.allocations)
    engine = pick_engine(engine, params, n, N, lengths_a)
    driver, engine_name, vlen_scale = make_chunk_driver(
        params, N, lengths_a, warmup, ripple_from, engine=engine, n_requests=n,
        device=device,
    )

    consumed = 0
    for chunk in chunks:
        driver.feed(chunk.proxies, chunk.objects)
        consumed += len(chunk.proxies)
    if consumed != n:
        raise ValueError(
            f"chunk stream supplied {consumed} requests but n_requests={n}"
        )
    out = driver.finish(n)
    return _assemble(
        out, driver.elapsed, n, warmup, J, N, vlen_scale, engine_name, sparse
    )


def make_chunk_driver(
    params: SimParams,
    n_objects: int,
    lengths: np.ndarray,
    warmup: int,
    ripple_from: int,
    *,
    engine: str = "auto",
    n_requests: int = 0,
    device: DeviceLike = None,
):
    """Construct a chunk-fed drive loop for one cache instance.

    This is the backend dispatch of :func:`simulate_chunks`, exposed so
    multi-instance callers (the :mod:`repro_torch.core.cluster` fault-injection
    simulator drives one driver per node) can own the feed schedule.
    Returns ``(driver, engine_name, vlen_scale)``; the driver honours the
    ``feed(proxies, objects)`` / ``finish(n_total)`` protocol with state
    resident between feeds, and ``n_requests`` (total stream length, when
    known up front) only gates the int32-envelope check of the CUDA
    backend, which runs on ``device`` (``None``: the card). Here
    ``engine="auto"`` is the host engines only (the cluster's nodes, whose
    forked workers must never touch CUDA); :func:`simulate_chunks`
    resolves "auto" with :func:`pick_engine` before it gets here.
    """
    N = int(n_objects)
    lengths_a = np.ascontiguousarray(np.asarray(lengths), dtype=np.int64)
    scale = _lcm_1_to(len(params.allocations))
    driver = None
    engine_name = "?"
    vlen_scale = scale

    if params.variant == "noshare":
        vlen_scale = 1
        if engine in ("auto", "c"):
            driver = _make_c_noshare(params, N, lengths_a, warmup)
            engine_name = "c"
            if driver is None and engine == "c":
                raise RuntimeError(
                    "engine='c' requested but the C backend is unavailable"
                )
        if driver is None:
            driver = _NoshareDriver(params, N, lengths_a, warmup)
            engine_name = "flat"
    elif params.variant == "pooled":
        vlen_scale = 1
        driver = _PooledDriver(params, N, lengths_a, warmup)
        engine_name = "flat"
    elif params.variant == "slru":
        driver = _GenericDriver(params, N, lengths_a, warmup, ripple_from)
        engine_name = "generic"
    else:  # flat shared LRU
        if engine in ("auto", "c"):
            driver = _make_c_flat(params, N, lengths_a, warmup, ripple_from, scale)
            engine_name = "c"
            if driver is None and engine == "c":
                raise RuntimeError(
                    "engine='c' requested but the C backend is unavailable"
                )
        if driver is None and engine == "cuda":
            if params.batch_interval != 0 or not _xla_applicable(
                int(n_requests), N, lengths_a, params
            ):
                raise RuntimeError(
                    "engine='cuda' requested but the lane engine is not applicable "
                    "(batch_interval > 0, or int32 range exceeded)"
                )
            driver = _make_cuda(
                params, N, lengths_a, warmup, ripple_from, scale, device
            )
            engine_name = "cuda"
        if driver is None and engine == "generic":
            driver = _GenericDriver(params, N, lengths_a, warmup, ripple_from)
            engine_name = "generic"
        if driver is None:
            driver = _FlatDriver(params, N, lengths_a, warmup, ripple_from)
            engine_name = "flat"
    return driver, engine_name, vlen_scale


def pick_engine(
    engine: str,
    params: SimParams,
    n_requests: int,
    n_objects: int,
    lengths: np.ndarray,
) -> str:
    """What ``engine="auto"`` runs for one Monte-Carlo run: ``"cuda"`` (the
    lane engine, on the run's device) for the flat shared LRU without
    delayed batching inside :func:`_xla_applicable`'s envelope, else
    ``"auto"`` (the host engines). A forced engine comes back as it is."""
    if (
        engine == "auto"
        and params.variant == "lru"
        and params.batch_interval == 0
        and _xla_applicable(n_requests, n_objects, lengths, params)
    ):
        return "cuda"
    return engine


# Backends that can honour a forced-engine request, per variant.
_ENGINES_BY_VARIANT = {
    "lru": ("c", "flat", "generic", "cuda"),
    "slru": ("generic",),
    "noshare": ("c", "flat"),
    "pooled": ("flat",),
}


def _validate_params(params: SimParams) -> None:
    """The engine constructors' guards, without allocating J*N state —
    every backend (including the C fast path, which never builds a
    Python engine) must reject the same invalid configurations."""
    if params.variant not in _ENGINES_BY_VARIANT:
        raise ValueError(f"unknown variant {params.variant!r}")
    J = len(params.allocations)
    if J < 1:
        raise ValueError("need at least one proxy")
    b = [int(x) for x in params.allocations]
    if any(x < 0 for x in b):
        raise ValueError("allocations must be nonnegative")
    if params.variant in ("noshare", "pooled"):
        return  # no sharing state: b_hat unused (pooled B defaults to sum b)
    if J > 62:
        raise ValueError("holder bitmask supports at most 62 proxies")
    if params.ripple_allocations is not None:
        b_hat = [int(x) for x in params.ripple_allocations]
        if len(b_hat) != J:
            raise ValueError("ripple_allocations must have one entry per proxy")
        if any(bh < bi for bh, bi in zip(b_hat, b)):
            raise ValueError("ripple_allocations must satisfy b_hat >= b")
    if params.physical_capacity is not None and int(
        params.physical_capacity
    ) < sum(b):
        raise ValueError(
            f"physical capacity B={params.physical_capacity} < sum of "
            f"allocations {sum(b)} (paper eq. (11) requires sum b_i <= B)"
        )
    if params.variant == "slru":
        if not (0.0 < params.hot_frac < 1.0 and 0.0 < params.warm_frac < 1.0):
            raise ValueError("segment fractions must be in (0, 1)")
        if params.hot_frac + params.warm_frac >= 1.0:
            raise ValueError("hot_frac + warm_frac must be < 1")


def _make_c_flat(params, n_objects, lengths, warmup, ripple_from, scale):
    try:
        from . import fastsim_c

        return fastsim_c.make_flat_runner(
            params, n_objects, lengths, warmup, ripple_from, scale
        )
    except Exception:
        return None


def _make_c_noshare(params, n_objects, lengths, warmup):
    try:
        from . import fastsim_c

        return fastsim_c.make_noshare_runner(
            params.allocations, n_objects, lengths, warmup
        )
    except Exception:
        return None


def _make_cuda(params, n_objects, lengths, warmup, ripple_from, scale, device):
    """The lane engine's chunk runner; a failed build or launch raises."""
    from . import fastsim_cuda

    return fastsim_cuda.CudaChunkRunner(
        params, n_objects, lengths, warmup, ripple_from, scale, device=device
    )


def _xla_applicable(
    n: int,
    n_objects: int,
    lengths: np.ndarray,
    params: SimParams,
    bhat_rows: Optional[np.ndarray] = None,
) -> bool:
    """int32-exactness envelope of the lane engine (its state is int32).
    ``bhat_rows`` are per-lane ripple allocations (sweep lanes), in place
    of ``params``' own."""
    J = len(params.allocations)
    scale = _lcm_1_to(J)
    # vlen is bounded by the *ripple* allocation (plus one transient
    # attach), so b_hat — not b — sets the envelope.
    if bhat_rows is None:
        bhat_rows = (
            params.ripple_allocations
            if params.ripple_allocations is not None
            else params.allocations
        )
    bhat_max = int(np.max(bhat_rows)) if np.size(bhat_rows) else 0
    return (
        n < 2**31
        and J * n_objects < 2**31
        and int(np.max(lengths)) * scale * (J + 1) < 2**31
        and bhat_max * scale < 2**30
    )


def _assemble(
    out: dict,
    elapsed: float,
    n: int,
    warmup: int,
    J: int,
    N: int,
    scale: int,
    engine: str,
    sparse: bool,
) -> SimResult:
    """Build a SimResult from a backend's raw output dict.

    Slot-sparse backends report accumulators as ``tot_time_slots`` (slot
    major, ``(T*J,)``) + ``slot_keys``; dense backends report
    ``tot_time`` as a flat ``(J*N,)`` vector. Either way the occupancy
    comes out dense or as a canonical :class:`SparseOccupancy` (sorted
    indices, zero columns dropped) per ``sparse``.
    """
    horizon = max(int(out["horizon"]), 1)
    if "slot_keys" in out:
        keys = np.asarray(out["slot_keys"], dtype=np.int64)
        vals = np.asarray(out["tot_time_slots"], dtype=np.int64).reshape(-1, J).T
        if sparse:
            order = np.argsort(keys, kind="stable")
            keys, vals = keys[order], vals[:, order]
            nz = vals.any(axis=0) if vals.size else np.zeros(0, dtype=bool)
            occ = SparseOccupancy(N, keys[nz], vals[:, nz] / horizon)
        else:
            dense = np.zeros((J, N), dtype=np.int64)
            dense[:, keys] = vals
            occ = dense / horizon
    else:
        tt = np.asarray(out["tot_time"], dtype=np.int64).reshape(J, N)
        if sparse:
            idxs = np.flatnonzero(tt.any(axis=0))
            occ = SparseOccupancy(N, idxs, tt[:, idxs] / horizon)
        else:
            occ = tt / horizon
    return SimResult(
        occupancy=occ,
        n_requests=n,
        warmup=warmup,
        n_hit_list=int(out["n_hit_list"]),
        n_hit_cache=int(out["n_hit_cache"]),
        n_miss=int(out["n_miss"]),
        hits_by_proxy=np.asarray(out["hits_p"], dtype=np.int64),
        reqs_by_proxy=np.asarray(out["reqs_p"], dtype=np.int64),
        evictions_per_set=_ripple_finish(
            np.asarray(out["hist"], dtype=np.int64).tolist()
        ),
        n_sets_recorded=int(out["n_sets"]),
        n_primary=int(out["n_prim"]),
        n_ripple=int(out["n_rip"]),
        n_batch_evictions=int(out.get("n_batch", 0)),
        final_vlen=np.asarray(out["vlen"], dtype=np.int64) / scale,
        elapsed_s=elapsed,
        engine=engine,
    )


def _ripple_finish(hist: List[int]) -> np.ndarray:
    last = 0
    for idx, c in enumerate(hist):
        if c:
            last = idx
    return np.asarray(hist[: last + 1], dtype=np.int64)


# ---------------------------------------------------------------------------
# Chunk-fed drivers (Python backends)
# ---------------------------------------------------------------------------
class _FlatDriver:
    """Chunk-fed, slot-sparse pure-Python drive loop (flat shared LRU).

    One fully-inlined interpreter loop per chunk, no per-request
    allocation: get / set / attach / detach / eviction-loop / ghost
    handling / occupancy accumulation all operate directly on flat
    CPython lists. This is the Python twin of the C ``drive_chunk``
    kernel: the per-(proxy, object) vectors (list pointers + occupancy
    accumulators) are indexed ``slot[k] * J + i`` through the sparse
    touched-set map, so memory scales with the touched catalogue, not
    ``J * N``. Equivalence with the per-operation path (and with the
    reference ``SharedLRUCache``) is enforced by ``tests/test_fastsim``
    and ``tests/test_streaming``.
    """

    def __init__(
        self,
        params: SimParams,
        n_objects: int,
        lengths: np.ndarray,
        warmup: int,
        ripple_from: int,
    ) -> None:
        J = len(params.allocations)
        N = int(n_objects)
        self.J, self.N = J, N
        scale = _lcm_1_to(J)
        self.scale = scale
        b = [int(x) for x in params.allocations]
        b_hat = (
            [int(x) for x in params.ripple_allocations]
            if params.ripple_allocations is not None
            else list(b)
        )
        self.b_scaled = [x * scale for x in b]
        self.bhat_scaled = [x * scale for x in b_hat]
        self.B = int(
            params.physical_capacity
            if params.physical_capacity is not None
            else sum(b)
        )
        self.ghost_retention = bool(params.ghost_retention)
        self.batch_interval = int(params.batch_interval)
        self.warmup = int(warmup)
        self.ripple_from = int(ripple_from)
        self.share = [0] + [scale // p for p in range(1, J + 1)] + [0]
        self.lengths = [int(x) for x in lengths]

        # Dense per-object state (N-sized).
        self.head = [NIL] * J
        self.tail = [NIL] * J
        self.hmask = [0] * N
        self.length = [0] * N
        self.vlen = [0] * J
        self.gnxt = [NIL] * N
        self.gprv = [NIL] * N
        self.isghost = [False] * N
        self.ghead = NIL
        self.gtail = NIL
        self.n_ghosts = 0
        self.phys_used = 0
        # Sparse touched-set state (grows by J entries per new slot).
        self.slot = [NIL] * N
        self.slot_key: List[int] = []
        self.nxt: List[int] = []
        self.prv: List[int] = []
        self.res_since: List[int] = []
        self.tot_time: List[int] = []
        self.t_start = 0

        self.n_hit_list = self.n_hit_cache = self.n_miss = 0
        self.hits_by_proxy = [0] * J
        self.reqs_by_proxy = [0] * J
        self.hist = [0] * HIST_BUCKETS
        self.n_sets_rec = self.n_primary = self.n_ripple = self.n_batch = 0
        self.sets_since_batch = 0
        self.idx = 0
        self.elapsed = 0.0

    def feed(self, proxies, objects) -> None:
        P = np.asarray(proxies).tolist()
        O = np.asarray(objects).tolist()
        J = self.J
        scale = self.scale
        share = self.share
        b_scaled = self.b_scaled
        bhat_scaled = self.bhat_scaled
        B = self.B
        ghost_retention = self.ghost_retention
        batch_interval = self.batch_interval
        warmup = self.warmup
        ripple_from = self.ripple_from
        lengths = self.lengths
        rng_J = range(J)

        head, tail = self.head, self.tail
        hmask, length = self.hmask, self.length
        vlen = self.vlen
        gnxt, gprv, isghost = self.gnxt, self.gprv, self.isghost
        ghead, gtail = self.ghead, self.gtail
        n_ghosts, phys_used = self.n_ghosts, self.phys_used
        slot, slot_key = self.slot, self.slot_key
        nxt, prv = self.nxt, self.prv
        res_since, tot_time = self.res_since, self.tot_time
        t_start = self.t_start

        n_hit_list, n_hit_cache, n_miss = (
            self.n_hit_list, self.n_hit_cache, self.n_miss
        )
        hits_by_proxy, reqs_by_proxy = self.hits_by_proxy, self.reqs_by_proxy
        hist = self.hist
        hist_cap = HIST_BUCKETS - 1
        n_sets_rec, n_primary = self.n_sets_rec, self.n_primary
        n_ripple, n_batch = self.n_ripple, self.n_batch
        sets_since_batch = self.sets_since_batch
        idx0 = self.idx
        n = len(P)

        t0 = time.perf_counter()
        for off in range(n):
            idx = idx0 + off
            if idx == warmup:
                tot_time = [0] * len(tot_time)
                t_start = idx
            i = P[off]
            k = O[off]
            if hmask[k] >> i & 1:
                # ---- HIT_LIST: promote to head of list i ----------------
                n_hit_list += 1
                if head[i] != k:
                    ik = slot[k] * J + i
                    p = prv[ik]
                    nx = nxt[ik]
                    if p == NIL:
                        tail[i] = nx
                    else:
                        nxt[slot[p] * J + i] = nx
                    prv[slot[nx] * J + i] = p  # nx != NIL: k is not the head
                    h = head[i]
                    nxt[slot[h] * J + i] = k
                    prv[ik] = h
                    nxt[ik] = NIL
                    head[i] = k
                if idx >= warmup:
                    reqs_by_proxy[i] += 1
                    hits_by_proxy[i] += 1
                continue

            l = length[k]
            if l > 0:
                # ---- HIT_CACHE: attach to list i (slot exists) ----------
                n_hit_cache += 1
                m = hmask[k]
                if m:
                    p_old = m.bit_count()
                    delta = l * share[p_old + 1] - l * share[p_old]
                    mm = m
                    while mm:
                        j = (mm & -mm).bit_length() - 1
                        vlen[j] += delta
                        mm &= mm - 1
                    hmask[k] = m | (1 << i)
                    vlen[i] += l * share[p_old + 1]
                else:
                    # resurrected ghost
                    hmask[k] = 1 << i
                    vlen[i] += l * scale
                    gp = gprv[k]
                    gn = gnxt[k]
                    if gp == NIL:
                        ghead = gn
                    else:
                        gnxt[gp] = gn
                    if gn == NIL:
                        gtail = gp
                    else:
                        gprv[gn] = gp
                    isghost[k] = False
                    n_ghosts -= 1
                is_set = False
            else:
                # ---- MISS -> fetch + set(k, l_k) ------------------------
                n_miss += 1
                if slot[k] < 0:
                    slot[k] = len(slot_key)
                    slot_key.append(k)
                    nxt.extend([NIL] * J)
                    prv.extend([NIL] * J)
                    res_since.extend([-1] * J)
                    tot_time.extend([0] * J)
                l = lengths[k]
                while phys_used + l > B and ghead != NIL:
                    g = ghead
                    ghead = gnxt[g]
                    if ghead == NIL:
                        gtail = NIL
                    else:
                        gprv[ghead] = NIL
                    isghost[g] = False
                    n_ghosts -= 1
                    phys_used -= length[g]
                    length[g] = 0
                length[k] = l
                phys_used += l
                hmask[k] = 1 << i
                vlen[i] += l * scale
                is_set = True

            # link k at head of list i (+ occupancy attach)
            ik = slot[k] * J + i
            h = head[i]
            if h == NIL:
                tail[i] = k
            else:
                nxt[slot[h] * J + i] = k
            prv[ik] = h
            nxt[ik] = NIL
            head[i] = k
            res_since[ik] = idx

            # ---- eviction loop (RRE thresholds; trigger = i) ------------
            n_evictions = 0
            n_rip = 0
            while True:
                worst = -1
                worst_over = 0
                for j in rng_J:
                    over = vlen[j] - (b_scaled[j] if j == i else bhat_scaled[j])
                    if over > worst_over:
                        worst = j
                        worst_over = over
                if worst < 0:
                    break
                v = tail[worst]
                wv = slot[v] * J + worst
                # unlink victim from tail of list `worst`
                nv = nxt[wv]
                tail[worst] = nv
                if nv == NIL:
                    head[worst] = NIL
                else:
                    prv[slot[nv] * J + worst] = NIL
                # occupancy detach
                since = res_since[wv]
                if since >= 0:
                    tot_time[wv] += idx - (since if since > t_start else t_start)
                    res_since[wv] = -1
                # share re-apportionment
                m = hmask[v]
                lv = length[v]
                p_old = m.bit_count()
                m &= ~(1 << worst)
                hmask[v] = m
                vlen[worst] -= lv * share[p_old]
                if m:
                    delta = lv * share[p_old - 1] - lv * share[p_old]
                    while m:
                        j = (m & -m).bit_length() - 1
                        vlen[j] += delta
                        m &= m - 1
                elif ghost_retention:
                    if gtail == NIL:
                        ghead = v
                    else:
                        gnxt[gtail] = v
                    gprv[v] = gtail
                    gnxt[v] = NIL
                    gtail = v
                    isghost[v] = True
                    n_ghosts += 1
                else:
                    phys_used -= lv
                    length[v] = 0
                n_evictions += 1
                if worst != i:
                    n_rip += 1

            if is_set:
                # reconcile physical occupancy (transient overshoot)
                while phys_used > B and ghead != NIL:
                    g = ghead
                    ghead = gnxt[g]
                    if ghead == NIL:
                        gtail = NIL
                    else:
                        gprv[ghead] = NIL
                    isghost[g] = False
                    n_ghosts -= 1
                    phys_used -= length[g]
                    length[g] = 0
                if batch_interval > 0:
                    sets_since_batch += 1
                    if sets_since_batch >= batch_interval:
                        sets_since_batch = 0
                        # delayed batch trim: rare -> sync state, use method
                        self.ghead, self.gtail = ghead, gtail
                        self.n_ghosts, self.phys_used = n_ghosts, phys_used
                        self.t_start, self.tot_time = t_start, tot_time
                        n_batch += self._batch_trim(idx)
                        ghead, gtail = self.ghead, self.gtail
                        n_ghosts, phys_used = self.n_ghosts, self.phys_used
                if idx >= ripple_from:
                    n_sets_rec += 1
                    hist[n_evictions if n_evictions < hist_cap else hist_cap] += 1
                    n_ripple += n_rip
                    n_primary += n_evictions - n_rip

            if idx >= warmup:
                reqs_by_proxy[i] += 1
        self.elapsed += time.perf_counter() - t0

        # write scalars (and rebound lists) back for the next chunk
        self.ghead, self.gtail, self.n_ghosts = ghead, gtail, n_ghosts
        self.phys_used = phys_used
        self.tot_time, self.t_start = tot_time, t_start
        self.n_hit_list, self.n_hit_cache, self.n_miss = (
            n_hit_list, n_hit_cache, n_miss
        )
        self.n_sets_rec, self.n_primary = n_sets_rec, n_primary
        self.n_ripple, self.n_batch = n_ripple, n_batch
        self.sets_since_batch = sets_since_batch
        self.idx = idx0 + n

    def _batch_trim(self, now: int) -> int:
        """RRE delayed batch trim: evict down to *primary* allocations
        (the array twin of ``FastSharedLRU.enforce``). Returns the
        eviction count; ripple/physical flags are not recorded (batch
        evictions happen off the request path)."""
        J = self.J
        share = self.share
        b_scaled = self.b_scaled
        vlen = self.vlen
        head, tail = self.head, self.tail
        nxt, prv, slot = self.nxt, self.prv, self.slot
        hmask, length = self.hmask, self.length
        gnxt, gprv, isghost = self.gnxt, self.gprv, self.isghost
        res_since, tot_time = self.res_since, self.tot_time
        t_start = self.t_start
        ghead, gtail = self.ghead, self.gtail
        n_ghosts, phys_used = self.n_ghosts, self.phys_used
        ghost_retention = self.ghost_retention
        n_ev = 0
        while True:
            worst = -1
            worst_over = 0
            for j in range(J):
                over = vlen[j] - b_scaled[j]
                if over > worst_over:
                    worst = j
                    worst_over = over
            if worst < 0:
                break
            v = tail[worst]
            wv = slot[v] * J + worst
            nv = nxt[wv]
            tail[worst] = nv
            if nv == NIL:
                head[worst] = NIL
            else:
                prv[slot[nv] * J + worst] = NIL
            since = res_since[wv]
            if since >= 0:
                tot_time[wv] += now - (since if since > t_start else t_start)
                res_since[wv] = -1
            m = hmask[v]
            lv = length[v]
            p_old = m.bit_count()
            m &= ~(1 << worst)
            hmask[v] = m
            vlen[worst] -= lv * share[p_old]
            if m:
                delta = lv * share[p_old - 1] - lv * share[p_old]
                while m:
                    j = (m & -m).bit_length() - 1
                    vlen[j] += delta
                    m &= m - 1
            elif ghost_retention:
                if gtail == NIL:
                    ghead = v
                else:
                    gnxt[gtail] = v
                gprv[v] = gtail
                gnxt[v] = NIL
                gtail = v
                isghost[v] = True
                n_ghosts += 1
            else:
                phys_used -= lv
                length[v] = 0
            n_ev += 1
        self.ghead, self.gtail = ghead, gtail
        self.n_ghosts, self.phys_used = n_ghosts, phys_used
        return n_ev

    def counters(self) -> dict:
        """Cumulative hit/miss/ripple counters, readable between ``feed``
        calls (whole-stream totals; the per-proxy arrays are post-warmup
        and the ripple fields post-``ripple_from``)."""
        return {
            "n_hit_list": int(self.n_hit_list),
            "n_hit_cache": int(self.n_hit_cache),
            "n_miss": int(self.n_miss),
            "hits_by_proxy": np.asarray(self.hits_by_proxy, dtype=np.int64),
            "reqs_by_proxy": np.asarray(self.reqs_by_proxy, dtype=np.int64),
            "hist": np.asarray(self.hist, dtype=np.int64),
            "n_sets": int(self.n_sets_rec),
            "n_prim": int(self.n_primary),
            "n_rip": int(self.n_ripple),
            "n_batch": int(self.n_batch),
        }

    def finish(self, n_total: int) -> dict:
        rs = np.asarray(self.res_since, dtype=np.int64)
        tt = np.asarray(self.tot_time, dtype=np.int64)
        open_m = rs >= 0
        tt[open_m] += n_total - np.maximum(rs[open_m], self.t_start)
        return {
            "tot_time_slots": tt,
            "slot_keys": np.asarray(self.slot_key, dtype=np.int64),
            "horizon": max(n_total - self.t_start, 1),
            "vlen": np.asarray(self.vlen, dtype=np.int64),
            "n_hit_list": self.n_hit_list,
            "n_hit_cache": self.n_hit_cache,
            "n_miss": self.n_miss,
            "hits_p": np.asarray(self.hits_by_proxy, dtype=np.int64),
            "reqs_p": np.asarray(self.reqs_by_proxy, dtype=np.int64),
            "hist": np.asarray(self.hist, dtype=np.int64),
            "n_sets": self.n_sets_rec,
            "n_prim": self.n_primary,
            "n_rip": self.n_ripple,
            "n_batch": self.n_batch,
        }


class _GenericDriver:
    """Chunk-fed per-operation driver: works for every engine variant
    (the only backend for the segmented S-LRU lists, whose per-(proxy,
    object) state stays dense — segment metadata has no touched-set)."""

    def __init__(
        self,
        params: SimParams,
        n_objects: int,
        lengths: np.ndarray,
        warmup: int,
        ripple_from: int,
    ) -> None:
        self.eng = params.make_engine(n_objects)
        self.batch_interval = int(params.batch_interval)
        self.warmup = int(warmup)
        self.ripple_from = int(ripple_from)
        self.lengths = [int(x) for x in lengths]
        J = self.eng.J
        self.hits_by_proxy = [0] * J
        self.reqs_by_proxy = [0] * J
        self.hist = [0] * HIST_BUCKETS
        self.n_sets_rec = self.n_primary = self.n_ripple = self.n_batch = 0
        self.sets_since_batch = 0
        self.idx = 0
        self.elapsed = 0.0

    def feed(self, proxies, objects) -> None:
        P = np.asarray(proxies).tolist()
        O = np.asarray(objects).tolist()
        eng = self.eng
        lengths = self.lengths
        warmup, ripple_from = self.warmup, self.ripple_from
        batch_interval = self.batch_interval
        hits_by_proxy, reqs_by_proxy = self.hits_by_proxy, self.reqs_by_proxy
        hist = self.hist
        n_sets_rec, n_primary = self.n_sets_rec, self.n_primary
        n_ripple, n_batch = self.n_ripple, self.n_batch
        sets_since_batch = self.sets_since_batch
        idx0 = self.idx
        n = len(P)

        t0 = time.perf_counter()
        for off in range(n):
            idx = idx0 + off
            eng.now = idx
            if idx == warmup:
                eng.reset_window()
            i, k = P[off], O[off]
            res, events = eng.get(i, k)
            if res is GetResult.MISS:
                _, events = eng.set(i, k, lengths[k])
                if batch_interval > 0:
                    sets_since_batch += 1
                    if sets_since_batch >= batch_interval:
                        sets_since_batch = 0
                        n_batch += len(eng.enforce())
                if idx >= ripple_from:
                    n_sets_rec += 1
                    ne = len(events)
                    hist[ne if ne < HIST_BUCKETS else HIST_BUCKETS - 1] += 1
                    nr = sum(1 for e in events if e[2])
                    n_ripple += nr
                    n_primary += ne - nr
            if idx >= warmup:
                reqs_by_proxy[i] += 1
                if res is GetResult.HIT_LIST:
                    hits_by_proxy[i] += 1
        self.elapsed += time.perf_counter() - t0

        self.n_sets_rec, self.n_primary = n_sets_rec, n_primary
        self.n_ripple, self.n_batch = n_ripple, n_batch
        self.sets_since_batch = sets_since_batch
        self.idx = idx0 + n

    def finish(self, n_total: int) -> dict:
        eng = self.eng
        eng.now = n_total
        eng.finalize()
        return {
            "tot_time": np.asarray(eng.tot_time, dtype=np.int64),
            "horizon": max(n_total - eng.t_start, 1),
            "vlen": np.asarray(eng.vlen_scaled, dtype=np.int64),
            "n_hit_list": eng.n_hit_list,
            "n_hit_cache": eng.n_hit_cache,
            "n_miss": eng.n_miss,
            "hits_p": np.asarray(self.hits_by_proxy, dtype=np.int64),
            "reqs_p": np.asarray(self.reqs_by_proxy, dtype=np.int64),
            "hist": np.asarray(self.hist, dtype=np.int64),
            "n_sets": self.n_sets_rec,
            "n_prim": self.n_primary,
            "n_rip": self.n_ripple,
            "n_batch": self.n_batch,
        }


class _NoshareDriver:
    """Chunk-fed J-independent-LRUs loop (Table-III baseline).

    Mirrors :class:`repro_torch.core.baselines.NotSharedSystem` driven with
    ``get_autofetch``: hit -> promote; miss -> insert at head, then evict
    from this list's own tail while it exceeds its allocation.
    """

    def __init__(
        self, params: SimParams, n_objects: int, lengths: np.ndarray, warmup: int
    ) -> None:
        b = [int(x) for x in params.allocations]
        J, N = len(b), int(n_objects)
        self.J, self.N, self.b = J, N, b
        self.warmup = int(warmup)
        self.lengths = [int(x) for x in lengths]
        self.nxt = [NIL] * (J * N)
        self.prv = [NIL] * (J * N)
        self.head = [NIL] * J
        self.tail = [NIL] * J
        self.inlist = [False] * (J * N)
        self.used = [0] * J
        self.res_since = [-1] * (J * N)
        self.tot_time = [0] * (J * N)
        self.t_start = 0
        self.n_hit = self.n_miss = 0
        self.hits_by_proxy = [0] * J
        self.reqs_by_proxy = [0] * J
        self.idx = 0
        self.elapsed = 0.0

    def feed(self, proxies, objects) -> None:
        P = np.asarray(proxies).tolist()
        O = np.asarray(objects).tolist()
        J, N = self.J, self.N
        b = self.b
        warmup = self.warmup
        lengths = self.lengths
        nxt, prv = self.nxt, self.prv
        head, tail = self.head, self.tail
        inlist, used = self.inlist, self.used
        res_since, tot_time = self.res_since, self.tot_time
        t_start = self.t_start
        n_hit, n_miss = self.n_hit, self.n_miss
        hits_by_proxy, reqs_by_proxy = self.hits_by_proxy, self.reqs_by_proxy
        idx0 = self.idx
        n = len(P)

        t0 = time.perf_counter()
        for off in range(n):
            idx = idx0 + off
            if idx == warmup:
                tot_time = [0] * (J * N)
                t_start = idx
            i = P[off]
            k = O[off]
            base = i * N
            ik = base + k
            if inlist[ik]:
                n_hit += 1
                if head[i] != k:
                    p = prv[ik]
                    nx = nxt[ik]
                    if p == NIL:
                        tail[i] = nx
                    else:
                        nxt[base + p] = nx
                    prv[base + nx] = p
                    h = head[i]
                    nxt[base + h] = k
                    prv[ik] = h
                    nxt[ik] = NIL
                    head[i] = k
                if idx >= warmup:
                    reqs_by_proxy[i] += 1
                    hits_by_proxy[i] += 1
                continue
            n_miss += 1
            inlist[ik] = True
            used[i] += lengths[k]
            h = head[i]
            if h == NIL:
                tail[i] = k
            else:
                nxt[base + h] = k
            prv[ik] = h
            nxt[ik] = NIL
            head[i] = k
            res_since[ik] = idx
            cap = b[i]
            while used[i] > cap:
                v = tail[i]
                iv = base + v
                nv = nxt[iv]
                tail[i] = nv
                if nv == NIL:
                    head[i] = NIL
                else:
                    prv[base + nv] = NIL
                inlist[iv] = False
                used[i] -= lengths[v]
                since = res_since[iv]
                if since >= 0:
                    tot_time[iv] += idx - (since if since > t_start else t_start)
                    res_since[iv] = -1
            if idx >= warmup:
                reqs_by_proxy[i] += 1
        self.elapsed += time.perf_counter() - t0

        self.tot_time, self.t_start = tot_time, t_start
        self.n_hit, self.n_miss = n_hit, n_miss
        self.idx = idx0 + n

    def finish(self, n_total: int) -> dict:
        rs = np.asarray(self.res_since, dtype=np.int64)
        tt = np.asarray(self.tot_time, dtype=np.int64)
        open_m = rs >= 0
        tt[open_m] += n_total - np.maximum(rs[open_m], self.t_start)
        return {
            "tot_time": tt,
            "horizon": max(n_total - self.t_start, 1),
            "vlen": np.asarray(self.used, dtype=np.int64),
            "n_hit_list": self.n_hit,
            "n_hit_cache": 0,
            "n_miss": self.n_miss,
            "hits_p": np.asarray(self.hits_by_proxy, dtype=np.int64),
            "reqs_p": np.asarray(self.reqs_by_proxy, dtype=np.int64),
            "hist": np.zeros(1, dtype=np.int64),
            "n_sets": 0,
            "n_prim": 0,
            "n_rip": 0,
            "n_batch": 0,
        }


class _PooledDriver:
    """Chunk-fed collective-LRU loop (no isolation, no sharing
    accounting): capacity ``physical_capacity`` (default ``sum(b)``),
    hits/requests attributed to the issuing proxy. This is the
    no-partitioning envelope the paper's multi-list system sits between
    (cf. the pooled MCD baseline of Table V). Per-object occupancy is
    the same for every proxy — the (J, N) occupancy matrix repeats one
    row; ``final_vlen`` reports the pooled units in use for every proxy.
    """

    def __init__(
        self, params: SimParams, n_objects: int, lengths: np.ndarray, warmup: int
    ) -> None:
        J = len(params.allocations)
        N = int(n_objects)
        self.J, self.N = J, N
        self.B = int(
            params.physical_capacity
            if params.physical_capacity is not None
            else sum(params.allocations)
        )
        if self.B < 1:
            raise ValueError("pooled variant needs positive capacity")
        self.warmup = int(warmup)
        self.lengths = [int(x) for x in lengths]
        self.nxt = [NIL] * N
        self.prv = [NIL] * N
        self.head = NIL
        self.tail = NIL
        self.inlist = [False] * N
        self.used = 0
        self.res_since = [-1] * N
        self.tot_time = [0] * N
        self.t_start = 0
        self.n_hit = self.n_miss = 0
        self.hits_by_proxy = [0] * J
        self.reqs_by_proxy = [0] * J
        self.idx = 0
        self.elapsed = 0.0

    def feed(self, proxies, objects) -> None:
        P = np.asarray(proxies).tolist()
        O = np.asarray(objects).tolist()
        N = self.N
        B = self.B
        warmup = self.warmup
        lengths = self.lengths
        nxt, prv = self.nxt, self.prv
        head, tail = self.head, self.tail
        inlist = self.inlist
        used = self.used
        res_since, tot_time = self.res_since, self.tot_time
        t_start = self.t_start
        n_hit, n_miss = self.n_hit, self.n_miss
        hits_by_proxy, reqs_by_proxy = self.hits_by_proxy, self.reqs_by_proxy
        idx0 = self.idx
        n = len(P)

        t0 = time.perf_counter()
        for off in range(n):
            idx = idx0 + off
            if idx == warmup:
                tot_time = [0] * N
                t_start = idx
            i = P[off]
            k = O[off]
            if inlist[k]:
                n_hit += 1
                if head != k:
                    p = prv[k]
                    nx = nxt[k]
                    if p == NIL:
                        tail = nx
                    else:
                        nxt[p] = nx
                    prv[nx] = p
                    nxt[head] = k
                    prv[k] = head
                    nxt[k] = NIL
                    head = k
                if idx >= warmup:
                    reqs_by_proxy[i] += 1
                    hits_by_proxy[i] += 1
                continue
            n_miss += 1
            inlist[k] = True
            used += lengths[k]
            if head == NIL:
                tail = k
            else:
                nxt[head] = k
            prv[k] = head
            nxt[k] = NIL
            head = k
            res_since[k] = idx
            while used > B:
                v = tail
                nv = nxt[v]
                tail = nv
                if nv == NIL:
                    head = NIL
                else:
                    prv[nv] = NIL
                inlist[v] = False
                used -= lengths[v]
                since = res_since[v]
                if since >= 0:
                    tot_time[v] += idx - (since if since > t_start else t_start)
                    res_since[v] = -1
            if idx >= warmup:
                reqs_by_proxy[i] += 1
        self.elapsed += time.perf_counter() - t0

        self.head, self.tail = head, tail
        self.used = used
        self.tot_time, self.t_start = tot_time, t_start
        self.n_hit, self.n_miss = n_hit, n_miss
        self.idx = idx0 + n

    def finish(self, n_total: int) -> dict:
        rs = np.asarray(self.res_since, dtype=np.int64)
        tt = np.asarray(self.tot_time, dtype=np.int64)
        open_m = rs >= 0
        tt[open_m] += n_total - np.maximum(rs[open_m], self.t_start)
        return {
            # every proxy sees the same pooled occupancy row
            "tot_time": np.tile(tt, self.J),
            "horizon": max(n_total - self.t_start, 1),
            "vlen": np.full(self.J, self.used, dtype=np.int64),
            "n_hit_list": self.n_hit,
            "n_hit_cache": 0,
            "n_miss": self.n_miss,
            "hits_p": np.asarray(self.hits_by_proxy, dtype=np.int64),
            "reqs_p": np.asarray(self.reqs_by_proxy, dtype=np.int64),
            "hist": np.zeros(1, dtype=np.int64),
            "n_sets": 0,
            "n_prim": 0,
            "n_rip": 0,
            "n_batch": 0,
        }
