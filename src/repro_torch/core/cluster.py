"""Fault-tolerant MCD-OS cluster: consistent-hash routing, node churn,
and graceful degradation.

The paper's prototype (Section VI) is a single always-up shared-cache
server; its deployment target — an edge datacenter fronting mobile
proxies — is a *cluster* of such servers behind MCD's client-side
consistent hashing. This module closes that gap:

* :class:`HashRing` — a consistent-hash ring with virtual nodes. Every
  node contributes ``vnodes`` pseudo-random positions on a 64-bit ring
  and a key is owned by the successor position; adding or removing a
  node only moves the keys in that node's arcs (~1/K of the key space),
  unlike modulo-of-hash routing which reshuffles almost everything.
* :class:`FaultSpec` — a declarative, seeded fault-injection schedule:
  scheduled and random ``fail`` / ``recover`` / ``add`` / ``remove``
  events at trace-fraction times (fractions, not request indices, so
  :meth:`repro_torch.scenario.Scenario.scaled` leaves the schedule valid).
* :func:`simulate_cluster` — K independent MCD-OS nodes, each a full
  shared cache with per-proxy LRU lists driven by its own
  :func:`repro_torch.core.fastsim.make_chunk_driver` engine (nodes are
  independent given the route, so the simulation stays embarrassingly
  parallel), behind the ring and a failover client:

  - ``fail`` marks a node down but keeps it on the ring: requests walk
    to the next distinct live node, spending one retry per down node
    contacted, and count as misses once the ``retry_budget`` is
    exhausted (graceful degradation, never an error);
  - ``recover`` brings the node back *warm* — its cache content
    survived the outage (a memcached restart with ghost lists intact),
    which is what makes the post-recovery window short;
  - ``add`` / ``remove`` reshard the ring; remapped keys become cold
    misses on their new owner unless ``warm_remapped`` pushes the old
    owner's resident copies across (ghost-list warm-up), in which case
    the synthetic warming traffic is subtracted from every reported
    counter.

The result aggregates per-node engines into one cluster-level
:class:`~repro_torch.core.fastsim.SimResult` (weighted by each node's share
of every object's post-warmup demand, so a single-node cluster with no
faults is bit-identical to :func:`~repro_torch.core.fastsim.simulate_trace`)
plus a JSON-safe stats payload (:class:`ClusterStats`): per-phase hit
rates (pre-fault / during / post-recovery), a windowed hit-rate series,
per-event remap fractions, retry/degraded counts, and the recovery
time-to-baseline.

Because nodes are independent given the route, the per-node feeding
pass is embarrassingly parallel. ``executor="parallel"`` fans it out
over a process pool (:class:`ClusterExecutor`): the routing pass, the
warm-up orchestration and the counter merge stay in the parent, worker
processes own disjoint node subsets and receive the same per-segment
feed schedule the sequential path runs, so the result — every counter,
every telemetry field — is bit-identical to ``executor="sequential"``
(the reference; ``tests/test_cluster_parallel.py`` proves it).
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import time
import traceback
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .fastsim import (
    SimParams,
    SimResult,
    SparseOccupancy,
    _assemble,
    _ripple_finish,
    make_chunk_driver,
)
from .irm import IRMTrace

DEFAULT_VNODES = 64
FAULT_ACTIONS = ("fail", "recover", "add", "remove")
EXECUTORS = ("sequential", "parallel")

_MASK64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# 64-bit ring positions
# ---------------------------------------------------------------------------
def _mix64_int(x: int) -> int:
    """splitmix64 finalizer — the scalar twin of :func:`_mix64_array`."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _mix64_array(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64, copy=True)
    x += np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def key_position(key: object) -> int:
    """Ring position of one key: splitmix64 for integer object ids (the
    vectorizable trace path), md5 for anything else (MCD string keys)."""
    if isinstance(key, (int, np.integer)):
        return _mix64_int(int(key))
    digest = hashlib.md5(repr(key).encode()).digest()
    return int.from_bytes(digest[:8], "little")


def key_positions(object_ids: np.ndarray) -> np.ndarray:
    """Vectorized :func:`key_position` for integer object-id arrays."""
    return _mix64_array(np.asarray(object_ids, dtype=np.uint64))


# ---------------------------------------------------------------------------
# Consistent-hash ring with virtual nodes
# ---------------------------------------------------------------------------
class HashRing:
    """Consistent-hash ring: each node owns ``vnodes`` pseudo-random
    positions; a key belongs to the first vnode position >= its own
    (wrapping at the top). Node positions depend only on ``(node,
    vnode)``, so two rings over overlapping node sets agree everywhere
    except the arcs of the differing nodes — the minimal-disruption
    property membership churn relies on."""

    __slots__ = ("nodes", "vnodes", "positions", "owners")

    def __init__(self, nodes: Sequence[int], vnodes: int = DEFAULT_VNODES):
        node_list = sorted(int(x) for x in nodes)
        if not node_list:
            raise ValueError("hash ring needs at least one node")
        if len(set(node_list)) != len(node_list):
            raise ValueError("duplicate node ids on the ring")
        if any(x < 0 for x in node_list):
            raise ValueError("node ids must be nonnegative")
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.nodes: Tuple[int, ...] = tuple(node_list)
        self.vnodes = int(vnodes)
        pos_parts = []
        owner_parts = []
        for node in self.nodes:
            base = np.uint64((int(node) << 32) & _MASK64)
            vs = base + np.arange(vnodes, dtype=np.uint64)
            pos_parts.append(_mix64_array(vs))
            owner_parts.append(np.full(vnodes, node, dtype=np.int64))
        pos = np.concatenate(pos_parts)
        owner = np.concatenate(owner_parts)
        # stable total order even under (astronomically unlikely) 64-bit
        # position collisions: break ties by owner id
        order = np.lexsort((owner, pos))
        self.positions = pos[order]
        self.owners = owner[order]

    def __len__(self) -> int:
        return len(self.nodes)

    def with_node(self, node: int) -> "HashRing":
        if int(node) in self.nodes:
            raise ValueError(f"node {node} already on the ring")
        return HashRing(self.nodes + (int(node),), self.vnodes)

    def without_node(self, node: int) -> "HashRing":
        if int(node) not in self.nodes:
            raise ValueError(f"node {node} not on the ring")
        if len(self.nodes) == 1:
            raise ValueError("cannot remove the last ring node")
        rest = tuple(x for x in self.nodes if x != int(node))
        return HashRing(rest, self.vnodes)

    def slot_of(self, key_pos: np.ndarray) -> np.ndarray:
        """Index of the owning vnode for each 64-bit key position."""
        i = np.searchsorted(self.positions, np.asarray(key_pos, dtype=np.uint64))
        return np.where(i == len(self.positions), 0, i)

    def owner_of(self, key_pos: np.ndarray) -> np.ndarray:
        """Owning node id for each 64-bit key position."""
        return self.owners[self.slot_of(key_pos)]

    def route_pos(self, pos: int) -> int:
        """Scalar owner lookup by ring position."""
        i = int(np.searchsorted(self.positions, np.uint64(pos & _MASK64)))
        if i == len(self.positions):
            i = 0
        return int(self.owners[i])

    def route(self, key: object) -> int:
        """Owning node of one key (any hashable; ints use splitmix64)."""
        return self.route_pos(key_position(key))


@lru_cache(maxsize=128)
def default_ring(n_nodes: int, vnodes: int = DEFAULT_VNODES) -> HashRing:
    """The canonical ring over nodes ``0..n_nodes-1`` (cached) — what
    the MCD-OS router ``consistent_route`` (``core/mcdos.py``, not
    ported yet) routes against. Ring ``n-1`` is ring ``n`` minus node ``n-1``'s vnodes, so shrinking the
    server count remaps only that node's arcs."""
    return HashRing(range(int(n_nodes)), vnodes)


def _failover_tables_walk(
    ring: HashRing, down: frozenset, retry_budget: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Reference O(M^2) failover walk — the executable specification.

    For each vnode slot, walk the ring visiting *distinct* nodes in
    order: the first one is the key's primary owner, each down node
    contacted costs one retry, and the client gives up (degraded mode,
    target ``-1``) after the primary plus ``retry_budget`` distinct
    nodes all failed. Returns ``(target, retries)`` per slot.

    Kept as the oracle for :func:`_failover_tables`; the fast path is
    tested element-for-element against this walk.
    """
    owners = ring.owners
    M = len(owners)
    target = np.empty(M, dtype=np.int64)
    retries = np.zeros(M, dtype=np.int64)
    if not down:
        target[:] = owners
        return target, retries
    max_attempts = 1 + int(retry_budget)
    for s in range(M):
        tried: List[int] = []
        tgt = -1
        for j in range(M):
            o = int(owners[(s + j) % M])
            if o in tried:
                continue
            if o not in down:
                tgt = o
                break
            tried.append(o)
            if len(tried) >= max_attempts:
                break
        target[s] = tgt
        # retries = failed contacts beyond none: every down node tried
        retries[s] = len(tried)
    return target, retries


def _failover_tables(
    ring: HashRing, down: frozenset, retry_budget: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-ring-slot failover routing under a set of down nodes.

    Semantics are exactly :func:`_failover_tables_walk` (see its
    docstring for the client-walk model), but computed in O(M): every
    down slot's forward walk stops at the first *live* slot after it,
    so each maximal run of down slots shares one live right endpoint.
    Walking each run once, backward from that endpoint, accumulates
    the distinct down owners a client starting at each slot would try
    — each ring slot is visited exactly once overall.
    """
    owners = ring.owners
    M = len(owners)
    target = np.empty(M, dtype=np.int64)
    retries = np.zeros(M, dtype=np.int64)
    if not down:
        target[:] = owners
        return target, retries
    max_attempts = 1 + int(retry_budget)
    is_down = np.isin(owners, np.fromiter(down, dtype=np.int64))
    live_slots = np.flatnonzero(~is_down)
    if live_slots.size == 0:
        # Every owner is down: each walk tries all distinct owners (or
        # gives up at the attempt cap) and degrades to target -1.
        target[:] = -1
        retries[:] = min(len({int(o) for o in owners}), max_attempts)
        return target, retries
    target[live_slots] = owners[live_slots]
    for k in range(live_slots.size):
        end = int(live_slots[k])
        start = int(live_slots[k - 1])  # k=0 wraps to the last live slot
        seen: set = set()
        s = (end - 1) % M
        while s != start:
            seen.add(int(owners[s]))
            if len(seen) < max_attempts:
                target[s] = owners[end]
                retries[s] = len(seen)
            else:
                target[s] = -1
                retries[s] = max_attempts
            s = (s - 1) % M
    return target, retries


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class FaultEvent:
    """One materialized fault event at a concrete request index."""

    idx: int
    frac: float
    action: str
    node: int

    def to_dict(self) -> dict:
        return {
            "idx": int(self.idx),
            "frac": float(self.frac),
            "action": self.action,
            "node": int(self.node),
        }


@dataclass(frozen=True)
class FaultSpec:
    """Deterministic fault-injection schedule for a cluster scenario.

    Fields
    ------
    events:
        Scheduled ``(frac, action, node)`` tuples: at request index
        ``frac * n_requests`` apply ``action`` (one of ``fail`` /
        ``recover`` / ``add`` / ``remove``) to ``node``. Times are
        trace *fractions* so ``Scenario.scaled`` keeps the schedule
        aligned with the shrunk trace.
    random_failures:
        Additionally draw this many seeded-random fail events (node
        uniform over the initial membership, time uniform in the middle
        [0.1, 0.8] of the trace), each recovering ``mttr_frac`` later.
        The draw is keyed on the scenario seed — bit-reproducible.
    mttr_frac:
        Mean-time-to-repair of random failures, as a trace fraction.
    vnodes:
        Virtual nodes per physical node on the consistent-hash ring.
    retry_budget:
        Distinct failover nodes a client tries after a down primary
        before giving up and counting the request as a miss
        (``0`` disables failover: down primary = degraded miss).
    warm_remapped:
        On membership change, push the old owner's resident copies of
        remapped keys to their new owner (ghost-list warm-up). The
        synthetic warming requests are subtracted from every reported
        counter, but they do advance the new owner's local clock, so
        occupancy estimates are approximate in warmed runs.
    window_frac:
        Width of the hit-rate measurement windows (trace fraction) used
        for the time series and recovery detection.
    recovery_tol:
        A post-fault window counts as recovered once its aggregate hit
        rate is within this absolute tolerance of the pre-fault
        baseline.
    """

    events: Tuple[Tuple[float, str, int], ...] = ()
    random_failures: int = 0
    mttr_frac: float = 0.05
    vnodes: int = DEFAULT_VNODES
    retry_budget: int = 2
    warm_remapped: bool = False
    window_frac: float = 0.02
    recovery_tol: float = 0.02

    def __post_init__(self) -> None:
        norm = []
        for ev in self.events:
            if len(ev) != 3:
                raise ValueError(f"fault event must be (frac, action, node): {ev!r}")
            frac, action, node = float(ev[0]), str(ev[1]), int(ev[2])
            if not 0.0 <= frac <= 1.0:
                raise ValueError(f"event time {frac} must be a trace fraction in [0, 1]")
            if action not in FAULT_ACTIONS:
                raise ValueError(
                    f"unknown fault action {action!r}; options: {FAULT_ACTIONS}"
                )
            if node < 0:
                raise ValueError("node ids must be nonnegative")
            norm.append((frac, action, node))
        object.__setattr__(self, "events", tuple(norm))
        if self.random_failures < 0:
            raise ValueError("random_failures must be nonnegative")
        if not 0.0 < self.mttr_frac <= 1.0:
            raise ValueError("mttr_frac must be in (0, 1]")
        if self.vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        if self.retry_budget < 0:
            raise ValueError("retry_budget must be nonnegative")
        if not 0.0 < self.window_frac <= 1.0:
            raise ValueError("window_frac must be in (0, 1]")
        if self.recovery_tol < 0.0:
            raise ValueError("recovery_tol must be nonnegative")

    @property
    def is_empty(self) -> bool:
        """No scheduled and no random events: a fault-free cluster."""
        return not self.events and self.random_failures == 0

    def materialize(
        self, n_requests: int, n_nodes: int, seed: int
    ) -> List[FaultEvent]:
        """Concrete, sorted event list for an ``n_requests`` trace.

        Scheduled events land at ``round(frac * n)``; random failures
        draw from a :class:`numpy.random.SeedSequence` substream keyed
        on ``seed``, so the same (spec, trace length, seed) triple
        always yields the same schedule.
        """
        n = int(n_requests)
        out = [
            FaultEvent(min(int(round(f * n)), n), f, a, m)
            for f, a, m in self.events
        ]
        if self.random_failures:
            rng = np.random.default_rng(
                np.random.SeedSequence([int(seed) & _MASK64, 0xFA17])
            )
            for _ in range(self.random_failures):
                node = int(rng.integers(0, n_nodes))
                t = float(rng.uniform(0.1, 0.8))
                t_rec = min(t + self.mttr_frac, 1.0)
                out.append(FaultEvent(min(int(round(t * n)), n), t, "fail", node))
                out.append(
                    FaultEvent(min(int(round(t_rec * n)), n), t_rec, "recover", node)
                )
        out.sort(key=lambda e: e.idx)
        return out

    # -- JSON round-trip ---------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "events": [[f, a, m] for f, a, m in self.events],
            "random_failures": self.random_failures,
            "mttr_frac": self.mttr_frac,
            "vnodes": self.vnodes,
            "retry_budget": self.retry_budget,
            "warm_remapped": self.warm_remapped,
            "window_frac": self.window_frac,
            "recovery_tol": self.recovery_tol,
        }

    @staticmethod
    def from_dict(d: dict) -> "FaultSpec":
        d = dict(d)
        d["events"] = tuple(tuple(ev) for ev in d.get("events", ()))
        return FaultSpec(**d)


# ---------------------------------------------------------------------------
# Cluster simulation
# ---------------------------------------------------------------------------
def _counter_delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _feed_array(drv, proxies: np.ndarray, objects: np.ndarray, chunk_size) -> None:
    """Feed one (proxy, object) slice, split into ``chunk_size`` pieces.

    The drivers are incremental, so splitting a feed changes nothing but
    peak temporary memory (the PR-3 streaming invariant) — ``None``
    feeds in one call, exactly the pre-chunking behavior."""
    n = len(objects)
    if not chunk_size or n <= int(chunk_size):
        if n:
            drv.feed(proxies, objects)
        return
    step = int(chunk_size)
    for a in range(0, n, step):
        drv.feed(proxies[a : a + step], objects[a : a + step])


class _FeedPlan:
    """Read-only inputs of the per-node feeding pass.

    One instance is shared by every executor worker: under the ``fork``
    start method the trace arrays and route tables are inherited
    copy-on-write (never copied, never re-pickled); under ``spawn`` the
    plan is pickled once per worker. Nothing in it is mutated after
    construction.

    fork-shared: read-only — the ``forksafety`` analyzer rule keys on
    this marker and statically rejects any worker-side write through a
    value reachable from an instance of this class."""

    __slots__ = (
        "params", "n_objects", "lengths", "engine", "chunk_size",
        "proxies", "objects", "sel", "local_warm", "local_rf", "n_segs",
    )

    def __init__(
        self, params, n_objects, lengths, engine, chunk_size,
        proxies, objects, sel, local_warm, local_rf, n_segs,
    ):
        self.params = params
        self.n_objects = n_objects
        self.lengths = lengths
        self.engine = engine
        self.chunk_size = chunk_size
        self.proxies = proxies
        self.objects = objects
        self.sel = sel
        self.local_warm = local_warm
        self.local_rf = local_rf
        self.n_segs = n_segs


class _NodeBank:
    """Per-node drivers + warm-up corrections for a subset of nodes.

    This is the single implementation of the feeding pass: the
    sequential executor holds one bank over all nodes in-process, each
    :class:`ClusterExecutor` worker holds one over its node subset.
    Identical code on identical per-node feed sequences is what makes
    the two executors bit-identical by construction."""

    def __init__(self, plan: _FeedPlan, my_nodes: Sequence[int]):
        self.plan = plan
        self.my_nodes = [int(m) for m in my_nodes]
        self.drivers: Dict[int, object] = {}
        self.corr: Dict[int, dict] = {}
        self.engine_name = "?"
        self.vlen_scale = 1
        self.n_injected = 0
        # cumulative warm-adjusted list hits after each segment; the
        # parent sums banks and diffs to recover per-segment hits
        self.adj = np.zeros(plan.n_segs, dtype=np.int64)

    def _driver(self, m: int):
        drv = self.drivers.get(m)
        if drv is None:
            drv, self.engine_name, self.vlen_scale = make_chunk_driver(
                self.plan.params,
                self.plan.n_objects,
                self.plan.lengths,
                self.plan.local_warm[m],
                self.plan.local_rf[m],
                engine=self.plan.engine,
            )
            self.drivers[m] = drv
        return drv

    def resident(self, m: int, keys: np.ndarray) -> np.ndarray:
        """Which ``keys`` are resident on node ``m`` (False if the node
        never received traffic — no driver, nothing cached)."""
        drv = self.drivers.get(m)
        if drv is None:
            return np.zeros(len(keys), dtype=bool)
        return np.asarray(drv.length)[keys] > 0

    def warm(self, m: int, warm_proxies: np.ndarray, warm_keys: np.ndarray) -> None:
        drv = self._driver(m)
        before = drv.counters()
        _feed_array(drv, warm_proxies, warm_keys, self.plan.chunk_size)
        delta = _counter_delta(drv.counters(), before)
        acc = self.corr.setdefault(m, {k: 0 * v for k, v in delta.items()})
        for k in delta:
            acc[k] = acc[k] + delta[k]
        self.n_injected += int(len(warm_keys))

    def feed_segment(self, si: int, a: int, b: int) -> None:
        plan = self.plan
        for m in self.my_nodes:
            sm = plan.sel[m]
            lo, hi = np.searchsorted(sm, (a, b))
            if lo == hi:
                continue
            idxs = sm[lo:hi]
            _feed_array(
                self._driver(m), plan.proxies[idxs], plan.objects[idxs],
                plan.chunk_size,
            )
        total = sum(int(d.counters()["n_hit_list"]) for d in self.drivers.values())
        total -= sum(int(c["n_hit_list"]) for c in self.corr.values())
        self.adj[si] = total

    def collect(self) -> tuple:
        outs = {m: drv.finish(int(drv.idx)) for m, drv in self.drivers.items()}
        elapsed = {m: float(drv.elapsed) for m, drv in self.drivers.items()}
        return (
            outs, self.corr, elapsed, self.adj, self.n_injected,
            self.engine_name, self.vlen_scale,
        )


class _SequentialExecutor:
    """The reference executor: every node in one in-process bank."""

    def __init__(self, plan: _FeedPlan, nodes: Sequence[int]):
        self._bank = _NodeBank(plan, nodes)

    def resident(self, m, keys):
        return self._bank.resident(m, keys)

    def warm(self, m, warm_proxies, warm_keys):
        self._bank.warm(m, warm_proxies, warm_keys)

    def feed_segment(self, si, a, b):
        self._bank.feed_segment(si, a, b)

    def collect(self):
        return self._bank.collect()

    def close(self):
        pass


def _worker_main(plan: _FeedPlan, my_nodes: List[int], conn) -> None:
    """Worker process loop: apply the parent's feed schedule to one
    node-subset bank. Commands arrive in the exact order the sequential
    path would execute them (pipes are FIFO), replies are only sent for
    the synchronous ops (``resident`` queries and the final collect)."""
    bank = _NodeBank(plan, my_nodes)
    try:
        while True:
            msg = conn.recv()
            op = msg[0]
            if op == "seg":
                bank.feed_segment(msg[1], msg[2], msg[3])
            elif op == "warm":
                bank.warm(msg[1], msg[2], msg[3])
            elif op == "resident":
                conn.send(bank.resident(msg[1], msg[2]))
            elif op == "finish":
                conn.send(bank.collect())
                return
            else:  # pragma: no cover - protocol bug guard
                raise RuntimeError(f"unknown cluster worker op {op!r}")
    except EOFError:  # parent died / closed early: nothing to report to
        return
    except Exception:
        try:
            conn.send(("error", traceback.format_exc()))
        except Exception:  # pragma: no cover - parent already gone
            pass
    finally:
        conn.close()


class ClusterExecutor:
    """Process-pool executor for the per-node feeding pass
    (``System(executor="parallel")``).

    ``workers=N`` worker processes (default: ``os.cpu_count()``, capped
    at the number of nodes that ever receive traffic) each own a fixed
    round-robin subset of nodes. The parent streams the same segment
    schedule the sequential executor runs — asynchronous ``seg`` /
    ``warm`` commands, synchronous ghost-residency queries at remap
    boundaries — and merges per-worker counter snapshots by node id, so
    worker count and scheduling never reach the results: the output is
    bit-identical to the sequential reference for every (K, faults,
    chunk_size, backend) combination.

    Prefers the ``fork`` start method so the trace arrays and route
    tables in the :class:`_FeedPlan` are shared copy-on-write; falls
    back to ``spawn`` (plan pickled per worker) where fork is
    unavailable. A forked child cannot use a CUDA context its parent
    created (CUDA does not survive ``fork``), so workers only ever
    execute numpy and the host fastsim C/flat drivers (``simulate_cluster``
    refuses every other engine) and never touch torch or the card."""

    def __init__(
        self,
        plan: _FeedPlan,
        nodes: Sequence[int],
        workers: Optional[int] = None,
    ):
        methods = multiprocessing.get_all_start_methods()
        ctx = multiprocessing.get_context(
            "fork" if "fork" in methods else "spawn"
        )
        node_list = sorted(int(m) for m in nodes)
        W = int(workers) if workers is not None else (os.cpu_count() or 1)
        W = max(1, min(W, max(len(node_list), 1)))
        self.workers = W
        self._owner = {m: i % W for i, m in enumerate(node_list)}
        groups: List[List[int]] = [[] for _ in range(W)]
        for m in node_list:
            groups[self._owner[m]].append(m)
        self._conns = []
        self._procs = []
        for g in groups:
            parent_conn, child_conn = ctx.Pipe()
            p = ctx.Process(
                target=_worker_main, args=(plan, g, child_conn), daemon=True
            )
            p.start()
            child_conn.close()
            self._conns.append(parent_conn)
            self._procs.append(p)

    def _send(self, w: int, msg: tuple) -> None:
        try:
            self._conns[w].send(msg)
        except (BrokenPipeError, OSError) as e:
            raise RuntimeError(
                f"cluster worker {w} died (pid {self._procs[w].pid}): {e}"
            ) from e

    def _recv(self, w: int):
        try:
            obj = self._conns[w].recv()
        except EOFError as e:
            raise RuntimeError(
                f"cluster worker {w} exited without replying "
                f"(exitcode {self._procs[w].exitcode})"
            ) from e
        if isinstance(obj, tuple) and obj and obj[0] == "error":
            raise RuntimeError(f"cluster worker {w} failed:\n{obj[1]}")
        return obj

    def resident(self, m, keys):
        w = self._owner[m]
        self._send(w, ("resident", m, keys))
        return self._recv(w)

    def warm(self, m, warm_proxies, warm_keys):
        self._send(self._owner[m], ("warm", m, warm_proxies, warm_keys))

    def feed_segment(self, si, a, b):
        for w in range(self.workers):
            self._send(w, ("seg", si, a, b))

    def collect(self):
        for w in range(self.workers):
            self._send(w, ("finish",))
        outs: Dict[int, dict] = {}
        corr: Dict[int, dict] = {}
        elapsed: Dict[int, float] = {}
        adj = None
        n_injected = 0
        engine_name = "?"
        vlen_scale = 1
        # merge in worker-index order: node sets are disjoint and the
        # segment totals are sums of ints, so arrival order cannot
        # reach the merged result — this order is for readability
        for w in range(self.workers):
            o, c, e, a, inj, en, vs = self._recv(w)
            outs.update(o)
            corr.update(c)
            elapsed.update(e)
            adj = a if adj is None else adj + a
            n_injected += int(inj)
            if engine_name == "?" and en != "?":
                engine_name, vlen_scale = en, vs
        return outs, corr, elapsed, adj, n_injected, engine_name, vlen_scale

    def close(self):
        for conn in self._conns:
            try:
                conn.close()
            except OSError:  # pragma: no cover
                pass
        for p in self._procs:
            p.join(timeout=5.0)
            if p.is_alive():  # pragma: no cover - hung worker guard
                p.terminate()
                p.join(timeout=5.0)


def simulate_cluster(
    params: SimParams,
    trace: IRMTrace,
    n_objects: int,
    *,
    nodes: int,
    faults: Optional[FaultSpec] = None,
    lengths: Optional[np.ndarray] = None,
    warmup: int,
    ripple_from: Optional[int] = None,
    engine: str = "auto",
    sparse: bool = False,
    fault_seed: int = 0,
    executor: str = "sequential",
    workers: Optional[int] = None,
    chunk_size: Optional[int] = None,
) -> Tuple[SimResult, dict]:
    """Drive one trace through a K-node MCD-OS cluster with faults.

    Each node is an independent shared cache configured by ``params``
    (same per-proxy allocations on every node — a homogeneous cluster);
    the consistent-hash ring partitions the object space, the
    ``faults`` schedule injects churn, and the failover client resolves
    down primaries. Returns ``(aggregate SimResult, cluster stats)``:
    the SimResult matches the single-node contract (with ``nodes=1``
    and an empty spec it is bit-identical to ``simulate_trace``), the
    stats dict is the JSON payload for ``Report.extras["cluster"]``
    (:meth:`ClusterStats.to_dict`). Degraded requests (retry budget
    exhausted) are folded into ``reqs_by_proxy`` so realized hit rates
    charge them as misses.

    ``executor="parallel"`` runs the per-node feeding pass on a
    :class:`ClusterExecutor` process pool with ``workers`` processes
    (default ``os.cpu_count()``); results and telemetry are
    bit-identical to the sequential reference. ``chunk_size`` bounds
    the length of any single feed call (memory, not semantics: the
    drivers are incremental, so results are identical for every split).
    """
    if params.variant != "lru":
        raise ValueError(
            "cluster simulation supports variant='lru' only "
            f"(got {params.variant!r})"
        )
    if engine not in ("auto", "c", "flat"):
        raise ValueError(
            "cluster simulation needs a chunk-fed counter backend: "
            f"engine must be 'auto', 'c' or 'flat' (got {engine!r})"
        )
    if executor not in EXECUTORS:
        raise ValueError(
            f"unknown cluster executor {executor!r}; options: {EXECUTORS}"
        )
    if workers is not None and int(workers) < 1:
        raise ValueError("workers must be >= 1")
    if chunk_size is not None and int(chunk_size) < 1:
        raise ValueError("chunk_size must be >= 1")
    K = int(nodes)
    if K < 1:
        raise ValueError("cluster needs at least one node")
    spec = faults if faults is not None else FaultSpec()
    N = int(n_objects)
    J = len(params.allocations)
    proxies = np.ascontiguousarray(trace.proxies)
    objects = np.ascontiguousarray(trace.objects)
    n = len(proxies)
    warmup = min(int(warmup), n)
    ripple_from = int(ripple_from) if ripple_from is not None else warmup
    if lengths is None:
        lengths = np.ones(N, dtype=np.int64)

    t_wall = time.perf_counter()
    events = spec.materialize(n, K, fault_seed)

    # -- routing pass: ring + failover state evolves only at events -------
    key_pos = key_positions(np.arange(N, dtype=np.int64))
    members = set(range(K))
    down: set = set()
    ring = HashRing(members, spec.vnodes)
    slot_all = ring.slot_of(key_pos)
    owner_all = ring.owners[slot_all]
    tgt_by_slot, rtr_by_slot = _failover_tables(
        ring, frozenset(down), spec.retry_budget
    )

    target = np.empty(n, dtype=np.int64)
    retries_total = 0
    remap_log: List[dict] = []
    remap_by_idx: Dict[int, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
    downtime = {m: 0 for m in members}
    down_since: Dict[int, int] = {}

    def _route(a: int, b: int) -> None:
        nonlocal retries_total
        if a >= b:
            return
        s = slot_all[objects[a:b]]
        target[a:b] = tgt_by_slot[s]
        if down:
            retries_total += int(rtr_by_slot[s].sum())

    pos = 0
    for e in events:
        _route(pos, e.idx)
        pos = e.idx
        if e.action == "fail":
            if e.node not in members:
                raise ValueError(f"fail event for unknown node {e.node}")
            if e.node not in down:
                down.add(e.node)
                down_since[e.node] = e.idx
        elif e.action == "recover":
            if e.node not in members:
                raise ValueError(f"recover event for unknown node {e.node}")
            if e.node in down:
                down.discard(e.node)
                downtime[e.node] += e.idx - down_since.pop(e.node)
        elif e.action in ("add", "remove"):
            new_ring = (
                ring.with_node(e.node)
                if e.action == "add"
                else ring.without_node(e.node)
            )
            if e.action == "add":
                members.add(e.node)
                downtime.setdefault(e.node, 0)
            else:
                members.discard(e.node)
                if e.node in down:
                    down.discard(e.node)
                    downtime[e.node] += e.idx - down_since.pop(e.node)
            new_owner_all = new_ring.owners[new_ring.slot_of(key_pos)]
            moved = np.flatnonzero(new_owner_all != owner_all)
            remap_log.append(
                {
                    "idx": int(e.idx),
                    "action": e.action,
                    "node": int(e.node),
                    "fraction": float(moved.size / max(N, 1)),
                }
            )
            remap_by_idx.setdefault(e.idx, []).append(
                (moved, owner_all[moved], new_owner_all[moved])
            )
            ring = new_ring
            owner_all = new_owner_all
            slot_all = ring.slot_of(key_pos)
        tgt_by_slot, rtr_by_slot = _failover_tables(
            ring, frozenset(down), spec.retry_budget
        )
    _route(pos, n)
    for m, since in down_since.items():
        downtime[m] += n - since

    degraded = target < 0
    n_degraded = int(degraded.sum())
    post_w = np.zeros(n, dtype=bool)
    post_w[warmup:] = True
    degraded_p = np.bincount(
        proxies[degraded & post_w], minlength=J
    ).astype(np.int64)

    # -- feeding pass: one engine per node, counters cut at boundaries ----
    w = max(1, int(round(n * spec.window_frac)))
    window_starts = list(range(warmup, n, w))
    bounds = sorted(
        {0, warmup, min(ripple_from, n), n}
        | {e.idx for e in events}
        | set(window_starts)
    )
    segs = list(zip(bounds[:-1], bounds[1:]))

    ever_nodes = sorted(set(np.unique(target[~degraded]).tolist()) | set(downtime))
    # one stable argsort instead of K linear scans: within each node the
    # stable order preserves ascending request index, so sel[m] is
    # exactly np.flatnonzero(target == m)
    route_order = np.argsort(target, kind="stable")
    route_sorted = target[route_order]
    sel = {}
    for m in ever_nodes:
        lo, hi = np.searchsorted(route_sorted, (m, m + 1))
        sel[m] = np.ascontiguousarray(route_order[lo:hi])
    local_warm = {m: int(np.searchsorted(sel[m], warmup)) for m in ever_nodes}
    local_rf = {m: int(np.searchsorted(sel[m], ripple_from)) for m in ever_nodes}

    plan = _FeedPlan(
        params, N, lengths, engine, chunk_size,
        proxies, objects, sel, local_warm, local_rf, len(segs),
    )
    ex = (
        ClusterExecutor(plan, ever_nodes, workers=workers)
        if executor == "parallel"
        else _SequentialExecutor(plan, ever_nodes)
    )
    last_proxy = np.zeros(N, dtype=np.int64)
    try:
        for si, (a, b) in enumerate(segs):
            if spec.warm_remapped and a in remap_by_idx:
                for moved, old_own, new_own in remap_by_idx[a]:
                    for m in np.unique(new_own).tolist():
                        if m not in sel:  # new owner never sees real traffic
                            continue
                        keys_m = moved[new_own == m]
                        olds = old_own[new_own == m]
                        resident = np.zeros(keys_m.size, dtype=bool)
                        for o in np.unique(olds).tolist():
                            osel = olds == o
                            resident[osel] = ex.resident(o, keys_m[osel])
                        warm_keys = keys_m[resident]
                        if not warm_keys.size:
                            continue
                        ex.warm(m, last_proxy[warm_keys], warm_keys)
            ex.feed_segment(si, a, b)
            last_proxy[objects[a:b]] = proxies[a:b]
        (
            outs, corr, elapsed_by_node, seg_totals,
            n_injected, engine_name, vlen_scale,
        ) = ex.collect()
    finally:
        ex.close()
    seg_hits = np.diff(seg_totals, prepend=np.int64(0))
    # canonical node order: the executors hand nodes back in driver- or
    # worker-creation order, and the float aggregations below (vlen and
    # occupancy sums) round differently under reordering — sorting here
    # makes every aggregate a pure function of the per-node results
    outs = {m: outs[m] for m in sorted(outs)}

    # -- per-node correction + aggregation --------------------------------
    for m, out in outs.items():
        c = corr.get(m)
        if c is not None:
            for k in (
                "n_hit_list", "n_hit_cache", "n_miss",
                "n_sets", "n_prim", "n_rip", "n_batch",
            ):
                out[k] = int(out[k]) - int(c[k])
            out["hits_p"] = np.asarray(out["hits_p"]) - c["hits_by_proxy"]
            out["reqs_p"] = np.asarray(out["reqs_p"]) - c["reqs_by_proxy"]
            out["hist"] = np.asarray(out["hist"]) - c["hist"]

    results = {
        m: _assemble(
            out, elapsed_by_node[m], len(sel[m]), local_warm[m], J, N,
            vlen_scale, engine_name, sparse=True,
        )
        for m, out in outs.items()
    }

    # occupancy: each node weighted by its share of every object's
    # post-warmup demand (degraded requests land on no node and weigh
    # the mixture down); objects with no post-warmup demand fall back to
    # their final ring owner with weight 1, which keeps the nodes=1
    # fault-free cluster bit-identical to the single-node simulator.
    denom = np.bincount(objects[warmup:], minlength=N).astype(np.float64)
    final_owner = owner_all
    union_idx = (
        np.unique(np.concatenate([r.occupancy.indices for r in results.values()]))
        if results
        else np.zeros(0, dtype=np.int64)
    )
    acc = np.zeros((J, union_idx.size), dtype=np.float64)
    for m, r in results.items():
        occ = r.occupancy
        if not occ.indices.size:
            continue
        cnt_m = np.bincount(
            objects[warmup:][target[warmup:] == m], minlength=N
        ).astype(np.float64)
        w_m = np.divide(
            cnt_m, denom, out=np.zeros_like(cnt_m), where=denom > 0
        )
        w_m[(denom == 0) & (final_owner == m)] = 1.0
        p = np.searchsorted(union_idx, occ.indices)
        acc[:, p] += occ.values * w_m[occ.indices][None, :]
    if sparse:
        nz = acc.any(axis=0) if acc.size else np.zeros(0, dtype=bool)
        occupancy = SparseOccupancy(N, union_idx[nz], acc[:, nz])
    else:
        dense = np.zeros((J, N), dtype=np.float64)
        dense[:, union_idx] = acc
        occupancy = dense

    hist_len = max((len(r.evictions_per_set) for r in results.values()), default=1)
    hist = np.zeros(max(hist_len, 1), dtype=np.int64)
    for r in results.values():
        hist[: len(r.evictions_per_set)] += r.evictions_per_set
    hits_p = sum(
        (r.hits_by_proxy for r in results.values()),
        np.zeros(J, dtype=np.int64),
    )
    reqs_p = sum(
        (r.reqs_by_proxy for r in results.values()),
        np.zeros(J, dtype=np.int64),
    )
    final_vlen = sum(
        (np.asarray(r.final_vlen, dtype=np.float64) for r in results.values()),
        np.zeros(J, dtype=np.float64),
    )
    elapsed = time.perf_counter() - t_wall
    agg = SimResult(
        occupancy=occupancy,
        n_requests=n,
        warmup=warmup,
        n_hit_list=sum(r.n_hit_list for r in results.values()),
        n_hit_cache=sum(r.n_hit_cache for r in results.values()),
        n_miss=sum(r.n_miss for r in results.values()) + n_degraded,
        hits_by_proxy=hits_p,
        reqs_by_proxy=reqs_p + degraded_p,
        evictions_per_set=_ripple_finish(hist.tolist()),
        n_sets_recorded=sum(r.n_sets_recorded for r in results.values()),
        n_primary=sum(r.n_primary for r in results.values()),
        n_ripple=sum(r.n_ripple for r in results.values()),
        n_batch_evictions=sum(r.n_batch_evictions for r in results.values()),
        final_vlen=final_vlen,
        elapsed_s=elapsed,
        engine=engine_name,
    )

    stats = _cluster_stats(
        spec, K, events, segs, seg_hits, warmup, n, w, window_starts,
        remap_log, retries_total, n_degraded, n_injected, downtime,
        results, sel, engine_name,
    )
    return agg, stats.to_dict()


def _phase_stats(
    segs, seg_hits: np.ndarray, lo: int, hi: int
) -> Optional[dict]:
    """Aggregate hit rate over ``[lo, hi)`` — both must be segment
    boundaries (events, warmup and window starts all are)."""
    if hi <= lo:
        return None
    hits = reqs = 0
    for (a, b), h in zip(segs, seg_hits):
        if a >= lo and b <= hi:
            hits += int(h)
            reqs += b - a
    if reqs == 0:
        return None
    return {
        "start": int(lo),
        "end": int(hi),
        "requests": int(reqs),
        "hits": int(hits),
        "hit_rate": hits / reqs,
    }


@dataclass
class ClusterStats:
    """The ``Report.extras["cluster"]`` telemetry payload.

    A declared schema rather than an ad-hoc dict so the
    ``tools.analyze`` schema rule audits it: a field added here without
    touching :meth:`to_dict` / :meth:`from_dict` fails the
    static-analysis CI job, which is what keeps new telemetry from
    shipping un-round-tripped. Every value is JSON-safe (ints, floats,
    strings, ``None`` — never NaN: zero-request phases, windows and
    nodes report ``None`` rates)."""

    nodes: int
    vnodes: int
    engine: str
    retry_budget: int
    events: List[dict] = field(default_factory=list)
    phases: Dict[str, Optional[dict]] = field(default_factory=dict)
    windows: dict = field(default_factory=dict)
    remap: List[dict] = field(default_factory=list)
    retries: dict = field(default_factory=dict)
    recovery: dict = field(default_factory=dict)
    warm_remapped: dict = field(default_factory=dict)
    per_node: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "nodes": int(self.nodes),
            "vnodes": int(self.vnodes),
            "engine": self.engine,
            "retry_budget": int(self.retry_budget),
            "events": self.events,
            "phases": self.phases,
            "windows": self.windows,
            "remap": self.remap,
            "retries": self.retries,
            "recovery": self.recovery,
            "warm_remapped": self.warm_remapped,
            "per_node": self.per_node,
        }

    @staticmethod
    def from_dict(d: dict) -> "ClusterStats":
        return ClusterStats(**d)


def _cluster_stats(
    spec, K, events, segs, seg_hits, warmup, n, w, window_starts,
    remap_log, retries_total, n_degraded, n_injected, downtime,
    results, sel, engine_name,
) -> ClusterStats:
    windows = []
    for ws in window_starts:
        we = min(ws + w, n)
        st = _phase_stats(segs, seg_hits, ws, we)
        if st is not None:
            windows.append(st)

    first_e = events[0].idx if events else None
    last_e = events[-1].idx if events else None
    if events:
        phases = {
            "pre_fault": _phase_stats(segs, seg_hits, warmup, max(first_e, warmup)),
            "during": _phase_stats(
                segs, seg_hits, max(first_e, warmup), max(last_e, warmup)
            ),
            "post_recovery": _phase_stats(segs, seg_hits, max(last_e, warmup), n),
        }
    else:
        phases = {
            "steady": _phase_stats(segs, seg_hits, warmup, n),
            "pre_fault": None,
            "during": None,
            "post_recovery": None,
        }

    # recovery: first full window after the last event whose hit rate is
    # back within tolerance of the pre-fault baseline
    baseline = None
    pre = phases.get("pre_fault") or phases.get("steady")
    if pre is not None:
        baseline = pre["hit_rate"]
    recovery = {
        "baseline": baseline,
        "tol": float(spec.recovery_tol),
        "recovered": None,
        "requests_to_baseline": None,
    }
    if events and baseline is not None:
        recovery["recovered"] = False
        for win in windows:
            if win["start"] < last_e:
                continue
            if win["hit_rate"] >= baseline - spec.recovery_tol:
                recovery["recovered"] = True
                recovery["requests_to_baseline"] = int(win["end"] - last_e)
                break

    per_node = []
    for m in sorted(sel):
        r = results.get(m)
        hits = int(r.hits_by_proxy.sum()) if r else 0
        reqs = int(r.reqs_by_proxy.sum()) if r else 0
        per_node.append(
            {
                "node": int(m),
                "requests": int(len(sel[m])),
                "post_warmup_hits": hits,
                "post_warmup_requests": reqs,
                # None, not NaN, on zero-request nodes: the payload must
                # stay valid JSON through a round trip
                "hit_rate": (hits / reqs) if reqs else None,
                "downtime_frac": downtime.get(m, 0) / max(n, 1),
            }
        )

    return ClusterStats(
        nodes=int(K),
        vnodes=int(spec.vnodes),
        engine=engine_name,
        retry_budget=int(spec.retry_budget),
        events=[e.to_dict() for e in events],
        phases=phases,
        windows={
            "size": int(w),
            "starts": [int(x["start"]) for x in windows],
            "hit_rate": [float(x["hit_rate"]) for x in windows],
        },
        remap=remap_log,
        retries={
            "total": int(retries_total),
            "degraded_requests": int(n_degraded),
        },
        recovery=recovery,
        warm_remapped={
            "enabled": bool(spec.warm_remapped),
            "injected": int(n_injected),
        },
        per_node=per_node,
    )
