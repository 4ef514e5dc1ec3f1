"""Execution layer behind :meth:`Scenario.run`.

Dispatches on the system and estimator:

* ``monte_carlo`` — samples the workload's trace and drives it through
  :func:`repro_torch.core.fastsim.simulate_trace` — the CUDA lane engine
  on the run's device for the flat shared LRU (``backend="auto"`` or
  ``"cuda"``), the C / inlined-Python host backends for the other
  variants, the cluster and a forced host backend — or, with
  ``System(backend="reference")``, through the hookable executable-spec caches of :mod:`repro_torch.core.shared_lru` /
  :mod:`repro_torch.core.slru` (event-equivalent, orders of magnitude slower —
  small runs and debugging). Large runs stream instead: past the
  ``STREAMING_*`` thresholds (or with ``Estimator(streaming=True)``)
  the trace is fed chunk by chunk through
  :func:`repro_torch.core.fastsim.simulate_chunks` and occupancy comes back
  sparse — same results, O(chunk + touched-set) memory. The trace and
  object-length draws use independent seed substreams derived from
  ``Scenario.seed`` (:func:`derive_seeds`).
* ``working_set`` — solves the paper's eq. (8) fixed point
  (:func:`repro_torch.core.workingset.solve_workingset`, torch on the
  run's device) on the workload's (time-average) rate matrix. No trace
  is sampled.
* ``Workload(kind="serving")`` — compiles the multi-tenant prompt
  streams to a (tenant, KV-block) trace (:mod:`repro_torch.serving.trace`)
  and runs it through the Monte-Carlo or working-set path above, then
  translates the block counters into serving economics
  (:class:`~repro_torch.scenario.report.ServingReport`, stored in
  ``Report.extras["serving"]``). With ``System(admission=...)``,
  tenant onboarding is first gated by the eq. (13) test on the
  declared rates (:func:`_serving_onboarding`).
* ``System(admission=...)`` + a ``tenant_churn`` workload — replays the
  Section IV-C admission episode (:func:`_run_admission`): arrivals and
  departures flow through an
  :class:`~repro_torch.core.admission.AdmissionController`, per-round
  estimation traffic feeds a
  :class:`~repro_torch.core.irm.PopularityEstimator`, and the surviving
  tenant set is *validated* by handing the final virtual allocations to
  whichever estimator the scenario configured (Monte-Carlo replays the
  system; working-set solves it) — so every admission decision is
  checked against the realized hit probabilities it promised.

All paths return the same :class:`~repro_torch.scenario.report.Report`, so
simulation and analytics are interchangeable downstream. ``device`` (the
argument of :meth:`Scenario.run`) reaches the two places that use one:
the lane engine and the working-set solver (the admission controller's
solves included). ``None`` is the CUDA card and raises without one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.admission import AdmissionController
from repro_torch.core.cluster import simulate_cluster
from repro_torch.core.fastsim import (
    HIST_BUCKETS,
    SimResult,
    SparseOccupancy,
    default_warmup,
    simulate_chunks,
    simulate_trace,
)
from repro_torch.core.irm import IRMTrace, PopularityEstimator, sample_trace
from repro_torch.core.metrics import OccupancyRecorder
from repro_torch.core.shared_lru import GetResult, SharedLRUCache
from repro_torch.core.slru import SegmentedSharedLRUCache
from repro_torch.core.workingset import solve_workingset, solve_workingset_unshared
from repro_torch.device import DeviceLike

from repro_torch.serving.trace import popularity

from .report import Report, ServingReport
from .scenario import Scenario
from .system import System
from .workload import Workload

# Auto-streaming thresholds (Estimator.streaming=None): switch the
# Monte-Carlo path to chunked trace feeding + sparse occupancy once the
# one-shot trace (n_requests * J request cells) or the per-(proxy,
# object) state (J * n_objects cells) would dominate memory.
STREAMING_REQUEST_CELLS = 12_000_000
STREAMING_STATE_CELLS = 4_000_000


def run_scenario(sc: Scenario, device: DeviceLike = None) -> Report:
    if sc.workload.kind == "serving":
        return _run_serving(sc, device)
    if sc.system.admission is not None:
        return _run_admission(sc, device)
    if sc.workload.kind == "tenant_churn":
        raise ValueError(
            "tenant_churn workloads need System(admission=AdmissionSpec())"
        )
    if sc.system.is_cluster:
        return _run_cluster(sc)
    if sc.estimator.kind == "working_set":
        return _run_working_set(sc, device)
    return _run_monte_carlo(sc, device)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------
def derive_seeds(seed: int) -> Tuple[int, int]:
    """Independent (trace_seed, length_seed) substreams from one scenario
    seed.

    The trace draw and the object-length draw must not share an RNG
    stream (feeding the same seed to both correlates the sampled trace
    with the sampled sizes); spawning two ``SeedSequence`` children
    keeps every preset rerun reproducible while decorrelating the
    draws.
    """
    children = np.random.SeedSequence(int(seed)).spawn(2)
    return tuple(int(c.generate_state(1)[0]) for c in children)


def ensemble_seeds(trace_seed: int, replications: int) -> list:
    """Per-replica trace seeds for an ``Estimator(replications=R)`` run.

    Replica 0 keeps the scenario's derived trace seed itself, so its
    trajectory — and hence every per-replica estimate in lane 0 — is
    bit-identical to a ``replications=1`` run of the same scenario.
    Replicas ``r >= 1`` draw independent ``SeedSequence`` substreams
    keyed on ``(trace_seed, r)``.
    """
    out = [int(trace_seed)]
    for r in range(1, int(replications)):
        ss = np.random.SeedSequence([int(trace_seed), int(r), 0xE25B])
        out.append(int(ss.generate_state(1)[0]))
    return out


def _demand_weights(lam: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-proxy object weights and proxy traffic shares from a rate
    matrix (guarded against all-zero rows)."""
    totals = lam.sum(axis=1)
    w = lam / np.maximum(totals, 1e-300)[:, None]
    shares = totals / max(totals.sum(), 1e-300)
    return w, shares


def _rates_for(sc: Scenario) -> np.ndarray:
    n = sc.n_requests or (
        len(sc.workload.trace_proxies) if sc.workload.kind == "trace" else 0
    )
    return sc.workload.mean_rates(max(n, 1))


def _hit_rates(hit_prob, lam: np.ndarray):
    w, shares = _demand_weights(lam)
    if isinstance(hit_prob, SparseOccupancy):
        # untouched objects have exactly zero occupancy: only the
        # touched columns contribute to the demand-weighted rate.
        per_proxy = (w[:, hit_prob.indices] * hit_prob.values).sum(axis=1)
    else:
        per_proxy = (w * hit_prob).sum(axis=1)
    return per_proxy, float((shares * per_proxy).sum())


def use_streaming(sc: Scenario, n_requests: int) -> bool:
    """Whether this Monte-Carlo run takes the chunked + sparse path."""
    est, system = sc.estimator, sc.system
    if system.backend == "reference":
        if est.streaming:
            raise ValueError(
                "backend='reference' has no streaming driver; use one of "
                "the fastsim backends for streaming scenarios"
            )
        return False
    if est.streaming is not None:
        return bool(est.streaming)
    J = system.n_proxies
    return (
        n_requests * J >= STREAMING_REQUEST_CELLS
        or J * sc.workload.n_objects >= STREAMING_STATE_CELLS
    )


# ---------------------------------------------------------------------------
# Working-set estimator
# ---------------------------------------------------------------------------
def _run_working_set(sc: Scenario, device: DeviceLike = None) -> Report:
    est, system = sc.estimator, sc.system
    if system.variant == "slru":
        raise ValueError(
            "working_set estimator has no S-LRU model; use monte_carlo "
            "for variant='slru'"
        )
    lam = _rates_for(sc)
    _, length_seed = derive_seeds(sc.seed)
    lengths = sc.workload.object_lengths(length_seed).astype(np.float64)
    kw = dict(
        n_quad=est.n_quad,
        n_outer=est.n_outer,
        n_bisect=est.n_bisect,
        damping=est.damping,
        tol=est.tol,
        device=device,
    )
    t0 = time.perf_counter()
    if system.variant == "pooled":
        # One collective LRU: single-list classical working set on the
        # merged demand; every proxy sees the same per-object hit prob.
        attribution = "full"
        lam_pool = lam.sum(axis=0, keepdims=True)
        sol = solve_workingset(
            lam_pool,
            lengths,
            np.array([float(system.capacity())]),
            attribution=attribution,
            **kw,
        )
        hit_prob = np.repeat(sol.h, system.n_proxies, axis=0)
    else:
        # noshare has no sharing term: the classical ("full") attribution
        # is the only applicable model, whatever the estimator asked for.
        attribution = (
            "full" if system.variant == "noshare" else est.attribution
        )
        sol = solve_workingset(
            lam,
            lengths,
            np.asarray(system.allocations, dtype=np.float64),
            attribution=attribution,
            **kw,
        )
        hit_prob = sol.h
    elapsed = time.perf_counter() - t0
    per_proxy, overall = _hit_rates(hit_prob, lam)
    return Report(
        scenario=sc.to_dict(),
        estimator="working_set",
        backend="torch-ws",
        hit_prob=hit_prob,
        hit_rate=per_proxy,
        overall_hit_rate=overall,
        n_requests=0,
        warmup=0,
        elapsed_s=elapsed,
        throughput_rps=0.0,
        converged=sol.converged,
        extras={
            "effective_attribution": attribution,
            "characteristic_times": sol.t.tolist(),
            "iterations": sol.iterations,
            "max_abs_residual": float(np.max(np.abs(sol.residual))),
        },
    )


# ---------------------------------------------------------------------------
# Monte-Carlo estimator
# ---------------------------------------------------------------------------
def _run_monte_carlo(sc: Scenario, device: DeviceLike = None) -> Report:
    system = sc.system
    n = sc.n_requests
    if sc.workload.kind == "trace" and n < 1:
        n = len(sc.workload.trace_proxies)
    trace_seed, length_seed = derive_seeds(sc.seed)
    streaming = use_streaming(sc, n)
    lengths = sc.workload.object_lengths(length_seed)
    warmup = (
        sc.warmup
        if sc.warmup is not None
        else default_warmup(n, system.allocations)
    )
    warmup = min(warmup, n)
    if sc.estimator.replications > 1:
        return _run_monte_carlo_ensemble(
            sc, n, warmup, lengths, trace_seed, streaming, device
        )
    if system.backend == "reference":
        trace = sc.workload.sample(n, trace_seed)
        res = _run_reference(sc, trace, lengths, warmup)
        backend = "reference"
    elif streaming:
        # Chunk-fed drive loop + sparse touched-set occupancy: the trace
        # is never materialized in full, and the result is bit-identical
        # to the one-shot dense path (tests/test_streaming.py).
        res = simulate_chunks(
            system.to_sim_params(),
            sc.workload.iter_chunks(
                n, trace_seed, chunk_size=sc.estimator.chunk_size
            ),
            sc.workload.n_objects,
            n,
            lengths=lengths,
            warmup=warmup,
            ripple_from=sc.ripple_from,
            engine=system.backend,
            sparse=True,
            device=device,
        )
        backend = res.engine
    else:
        trace = sc.workload.sample(n, trace_seed)
        res = simulate_trace(
            system.to_sim_params(),
            trace,
            sc.workload.n_objects,
            lengths=lengths,
            warmup=warmup,
            ripple_from=sc.ripple_from,
            engine=system.backend,
            device=device,
        )
        # SimResult records the backend that actually ran (under "auto"
        # the C path can silently fall back to the Python loop).
        backend = res.engine
    lam = _rates_for(sc)
    per_proxy, overall = _hit_rates(res.occupancy, lam)
    ripple = None
    if system.variant in ("lru", "slru"):
        ripple = {
            "evictions_per_set": {
                str(k): int(c)
                for k, c in enumerate(res.evictions_per_set)
                if c
            },
            "n_sets_recorded": int(res.n_sets_recorded),
            "n_primary": int(res.n_primary),
            "n_ripple": int(res.n_ripple),
            "n_batch_evictions": int(res.n_batch_evictions),
            "frac_multi_eviction": float(res.frac_multi_eviction),
            "mean_evictions": float(res.mean_evictions),
        }
    return Report(
        scenario=sc.to_dict(),
        estimator="monte_carlo",
        backend=backend,
        hit_prob=res.occupancy,
        hit_rate=per_proxy,
        overall_hit_rate=overall,
        n_requests=res.n_requests,
        warmup=res.warmup,
        elapsed_s=res.elapsed_s,
        throughput_rps=res.requests_per_sec,
        realized_hit_rate=res.hit_rate_by_proxy,
        ripple=ripple,
        final_vlen=np.asarray(res.final_vlen, dtype=np.float64),
        extras={
            "n_hit_list": int(res.n_hit_list),
            "n_hit_cache": int(res.n_hit_cache),
            "n_miss": int(res.n_miss),
            "streaming": bool(streaming),
            **(
                {"chunk_size": int(sc.estimator.chunk_size)}
                if streaming
                else {}
            ),
        },
    )


def cluster_fault_seed(seed: int) -> int:
    """Fault-schedule seed substream for a cluster scenario.

    Independent of the trace/length substreams (:func:`derive_seeds`),
    so adding random failures never perturbs the sampled workload."""
    ss = np.random.SeedSequence([int(seed), 0xC105])
    return int(ss.generate_state(1)[0])


def _run_cluster(sc: Scenario) -> Report:
    """K-node consistent-hash cluster run (``System(nodes=K, faults=...)``).

    Samples the scenario trace once, routes it through
    :func:`repro_torch.core.cluster.simulate_cluster` (per-node fastsim
    engines behind the ring + failover client), and reports the
    aggregate exactly like :func:`_run_monte_carlo` — with ``nodes=1``
    and an empty :class:`~repro_torch.core.cluster.FaultSpec` the estimates
    are bit-identical to the single-node path. The cluster telemetry
    (phases, windows, remaps, retries, recovery) lands in
    ``Report.extras["cluster"]``. ``System(executor="parallel",
    workers=W)`` fans the per-node feeding pass out over a
    :class:`~repro_torch.core.cluster.ClusterExecutor` process pool with
    bit-identical results and telemetry.
    """
    system, est = sc.system, sc.estimator
    if est.kind != "monte_carlo":
        raise ValueError(
            "cluster systems are simulated: use Estimator('monte_carlo') "
            "(the working-set fixed point has no churn model)"
        )
    if est.replications > 1:
        raise ValueError(
            "cluster systems do not support ensemble replications yet"
        )
    n = sc.n_requests
    if sc.workload.kind == "trace" and n < 1:
        n = len(sc.workload.trace_proxies)
    trace_seed, length_seed = derive_seeds(sc.seed)
    streaming = use_streaming(sc, n)
    lengths = sc.workload.object_lengths(length_seed)
    warmup = (
        sc.warmup
        if sc.warmup is not None
        else default_warmup(n, system.allocations)
    )
    warmup = min(warmup, n)
    trace = sc.workload.sample(n, trace_seed)
    res, cluster = simulate_cluster(
        system.to_sim_params(),
        trace,
        sc.workload.n_objects,
        nodes=system.nodes,
        faults=system.faults,
        lengths=lengths,
        warmup=warmup,
        ripple_from=sc.ripple_from,
        engine=system.backend,
        sparse=streaming,
        fault_seed=cluster_fault_seed(sc.seed),
        executor=system.executor,
        workers=system.workers,
        # streamed runs bound per-feed temporaries exactly like the
        # single-node chunked path; results are split-invariant
        chunk_size=est.chunk_size if streaming else None,
    )
    lam = _rates_for(sc)
    per_proxy, overall = _hit_rates(res.occupancy, lam)
    ripple = {
        "evictions_per_set": {
            str(k): int(c) for k, c in enumerate(res.evictions_per_set) if c
        },
        "n_sets_recorded": int(res.n_sets_recorded),
        "n_primary": int(res.n_primary),
        "n_ripple": int(res.n_ripple),
        "n_batch_evictions": int(res.n_batch_evictions),
        "frac_multi_eviction": float(res.frac_multi_eviction),
        "mean_evictions": float(res.mean_evictions),
    }
    return Report(
        scenario=sc.to_dict(),
        estimator="monte_carlo",
        backend=res.engine,
        hit_prob=res.occupancy,
        hit_rate=per_proxy,
        overall_hit_rate=overall,
        n_requests=res.n_requests,
        warmup=res.warmup,
        elapsed_s=res.elapsed_s,
        throughput_rps=res.requests_per_sec,
        realized_hit_rate=res.hit_rate_by_proxy,
        ripple=ripple,
        final_vlen=np.asarray(res.final_vlen, dtype=np.float64),
        extras={
            "n_hit_list": int(res.n_hit_list),
            "n_hit_cache": int(res.n_hit_cache),
            "n_miss": int(res.n_miss),
            "streaming": bool(streaming),
            "cluster": cluster,
        },
    )


def _run_monte_carlo_ensemble(
    sc: Scenario,
    n: int,
    warmup: int,
    lengths: np.ndarray,
    trace_seed: int,
    streaming: bool,
    device: DeviceLike = None,
) -> Report:
    """R-replica Monte-Carlo run (``Estimator(replications=R)``).

    Replica trace seeds come from :func:`ensemble_seeds` (replica 0 is
    bit-identical to a single run). When the lane engine runs
    (``backend="cuda"``, or ``"auto"`` where
    :func:`~repro_torch.core.fastsim.pick_engine` picks it: flat LRU, no
    delayed batching, inside the int32 envelope) all replicas run
    batched, one lane each, on ``device`` via
    :func:`repro_torch.core.fastsim_cuda.simulate_ensemble`;
    every other backend runs the replicas sequentially with identical
    per-replica results. The Report carries cross-replica means in the
    main fields and the per-replica estimates in ``Report.ensemble``.
    """
    from repro_torch.core.fastsim import _xla_applicable, pick_engine

    system, est = sc.system, sc.estimator
    R = est.replications
    seeds = ensemble_seeds(trace_seed, R)
    params = system.to_sim_params()
    ripple_from = sc.ripple_from
    engine = system.backend
    if engine != "reference":
        engine = pick_engine(
            engine, params, n, sc.workload.n_objects, np.asarray(lengths)
        )
    batched = False
    results = None
    if (
        engine == "cuda"
        and system.variant == "lru"
        and system.batch_interval == 0
        and _xla_applicable(
            n, sc.workload.n_objects, np.asarray(lengths), params
        )
    ):
        from repro_torch.core import fastsim_cuda

        if streaming:
            traces = [
                sc.workload.iter_chunks(n, s, chunk_size=est.chunk_size)
                for s in seeds
            ]
        else:
            traces = [sc.workload.sample(n, s) for s in seeds]
        results = fastsim_cuda.simulate_ensemble(
            params,
            traces,
            sc.workload.n_objects,
            n,
            lengths=lengths,
            warmup=warmup,
            ripple_from=ripple_from,
            sparse=streaming,
            device=device,
        )
        batched = True
    if results is None:
        results = []
        for s in seeds:
            if system.backend == "reference":
                res = _run_reference(
                    sc, sc.workload.sample(n, s), lengths, warmup
                )
                res.engine = "reference"
                results.append(res)
            elif streaming:
                results.append(
                    simulate_chunks(
                        params,
                        sc.workload.iter_chunks(
                            n, s, chunk_size=est.chunk_size
                        ),
                        sc.workload.n_objects,
                        n,
                        lengths=lengths,
                        warmup=warmup,
                        ripple_from=ripple_from,
                        engine=engine,
                        sparse=True,
                        device=device,
                    )
                )
            else:
                results.append(
                    simulate_trace(
                        params,
                        sc.workload.sample(n, s),
                        sc.workload.n_objects,
                        lengths=lengths,
                        warmup=warmup,
                        ripple_from=ripple_from,
                        engine=engine,
                        device=device,
                    )
                )
    return _ensemble_report(sc, results, streaming, batched)


# Cap on the stacked (R, J, N) per-replica hit-probability payload kept
# inside ensemble Reports (beyond it — or for sparse results — only the
# per-proxy ensemble statistics are retained).
ENSEMBLE_HIT_PROB_CELLS = 32_000_000


def _ensemble_report(
    sc: Scenario, results, streaming: bool, batched: bool
) -> Report:
    """Aggregate per-replica SimResults into one ensemble Report."""
    R = len(results)
    lam = _rates_for(sc)
    per = [_hit_rates(r.occupancy, lam) for r in results]
    hit_rate_stack = np.stack([p for p, _ in per])  # (R, J)
    overall_stack = np.asarray([o for _, o in per], dtype=np.float64)
    realized_stack = np.stack([r.hit_rate_by_proxy for r in results])

    sparse_any = any(
        isinstance(r.occupancy, SparseOccupancy) for r in results
    )
    N = sc.workload.n_objects
    J = hit_rate_stack.shape[1]
    if sparse_any:
        # union of touched sets; untouched columns are exactly zero
        idx = np.unique(
            np.concatenate([r.occupancy.indices for r in results])
        )
        acc = np.zeros((J, idx.size), dtype=np.float64)
        for r in results:
            occ = r.occupancy
            pos = np.searchsorted(idx, occ.indices)
            acc[:, pos] += occ.values
        hit_prob = SparseOccupancy(N, idx, acc / R)
        # small catalogues still get per-object error bars: densify the
        # per-replica stack when it fits the cap (streaming may have
        # been chosen for the trace length, not the state size)
        prob_stack = (
            np.stack([r.occupancy.densify() for r in results])
            if R * J * N <= ENSEMBLE_HIT_PROB_CELLS
            else None
        )
    else:
        stack = np.stack([r.occupancy for r in results])
        hit_prob = stack.mean(axis=0)
        prob_stack = (
            stack if stack.size <= ENSEMBLE_HIT_PROB_CELLS else None
        )

    ripple = None
    if sc.system.variant in ("lru", "slru"):
        hist_len = max(len(r.evictions_per_set) for r in results)
        hist = np.zeros(hist_len, dtype=np.int64)
        for r in results:
            hist[: len(r.evictions_per_set)] += r.evictions_per_set
        n_sets = sum(r.n_sets_recorded for r in results)
        ks = np.arange(hist_len)
        ripple = {
            "evictions_per_set": {
                str(k): int(c) for k, c in enumerate(hist) if c
            },
            "n_sets_recorded": int(n_sets),
            "n_primary": int(sum(r.n_primary for r in results)),
            "n_ripple": int(sum(r.n_ripple for r in results)),
            "n_batch_evictions": int(
                sum(r.n_batch_evictions for r in results)
            ),
            "frac_multi_eviction": float(
                hist[2:].sum() / n_sets if n_sets else 0.0
            ),
            "mean_evictions": float(
                (ks * hist).sum() / n_sets if n_sets else 0.0
            ),
        }

    # Batched replicas share one wall clock; sequential replicas add up.
    elapsed = (
        results[0].elapsed_s if batched else sum(r.elapsed_s for r in results)
    )
    n_total = sum(r.n_requests for r in results)
    ensemble = {
        "replications": R,
        "batched": bool(batched),
        "hit_rate": hit_rate_stack,
        "overall_hit_rate": overall_stack,
        "realized_hit_rate": realized_stack,
    }
    if prob_stack is not None:
        ensemble["hit_prob"] = prob_stack
    return Report(
        scenario=sc.to_dict(),
        estimator="monte_carlo",
        backend=results[0].engine,
        hit_prob=hit_prob,
        hit_rate=hit_rate_stack.mean(axis=0),
        overall_hit_rate=float(overall_stack.mean()),
        n_requests=n_total,
        warmup=results[0].warmup,
        elapsed_s=elapsed,
        throughput_rps=n_total / elapsed if elapsed > 0 else float("inf"),
        realized_hit_rate=realized_stack.mean(axis=0),
        ripple=ripple,
        final_vlen=np.stack(
            [np.asarray(r.final_vlen, dtype=np.float64) for r in results]
        ).mean(axis=0),
        ensemble=ensemble,
        extras={
            "n_hit_list": int(sum(r.n_hit_list for r in results)),
            "n_hit_cache": int(sum(r.n_hit_cache for r in results)),
            "n_miss": int(sum(r.n_miss for r in results)),
            "streaming": bool(streaming),
            **(
                {"chunk_size": int(sc.estimator.chunk_size)}
                if streaming
                else {}
            ),
        },
    )


def _run_reference(
    sc: Scenario, trace: IRMTrace, lengths: np.ndarray, warmup: int
) -> SimResult:
    """Drive the hookable reference caches per-operation (slow path).

    Event-equivalent to the fastsim backends (``tests/test_fastsim.py``
    proves it for the engines; ``tests/test_scenario.py`` closes the loop
    through this driver), so a scenario can be spot-checked against the
    executable spec on a small trace.
    """
    system = sc.system
    if system.variant not in ("lru", "slru"):
        raise ValueError(
            "backend='reference' supports variants 'lru' and 'slru' only"
        )
    params = system.to_sim_params()
    common = dict(
        physical_capacity=params.physical_capacity,
        ghost_retention=params.ghost_retention,
        ripple_allocations=(
            list(params.ripple_allocations)
            if params.ripple_allocations is not None
            else None
        ),
    )
    if system.variant == "slru":
        cache = SegmentedSharedLRUCache(
            list(params.allocations),
            hot_frac=params.hot_frac,
            warm_frac=params.warm_frac,
            **common,
        )
    else:
        cache = SharedLRUCache(list(params.allocations), **common)
    J, N = system.n_proxies, sc.workload.n_objects
    rec = OccupancyRecorder(J, N).attach_to(cache)
    lengths_l = [int(x) for x in lengths]
    P, O = trace.proxies.tolist(), trace.objects.tolist()
    n = len(P)
    ripple_from = sc.ripple_from if sc.ripple_from is not None else warmup
    hist = [0] * HIST_BUCKETS
    hits_by_proxy = [0] * J
    reqs_by_proxy = [0] * J
    n_sets = n_primary = n_ripple = n_batch = 0
    n_hit_list = n_hit_cache = n_miss = 0
    sets_since_batch = 0

    t0 = time.perf_counter()
    for idx in range(n):
        rec.now = idx
        if idx == warmup:
            rec.reset_window()
        i, k = P[idx], O[idx]
        st = cache.get(i, k)
        if st.result is GetResult.MISS:
            n_miss += 1
            st = cache.set(i, k, lengths_l[k])
            if params.batch_interval > 0:
                sets_since_batch += 1
                if sets_since_batch >= params.batch_interval:
                    sets_since_batch = 0
                    n_batch += len(cache.enforce())
            if idx >= ripple_from:
                n_sets += 1
                ne = len(st.evictions)
                hist[min(ne, HIST_BUCKETS - 1)] += 1
                nr = sum(1 for e in st.evictions if e.ripple)
                n_ripple += nr
                n_primary += ne - nr
        elif st.result is GetResult.HIT_LIST:
            n_hit_list += 1
        else:
            n_hit_cache += 1
        if idx >= warmup:
            reqs_by_proxy[i] += 1
            if st.result is GetResult.HIT_LIST:
                hits_by_proxy[i] += 1
    elapsed = time.perf_counter() - t0
    rec.now = n
    rec.finalize()

    from repro_torch.core.fastsim import _ripple_finish

    return SimResult(
        occupancy=rec.occupancy(),
        n_requests=n,
        warmup=warmup,
        n_hit_list=n_hit_list,
        n_hit_cache=n_hit_cache,
        n_miss=n_miss,
        hits_by_proxy=np.asarray(hits_by_proxy, dtype=np.int64),
        reqs_by_proxy=np.asarray(reqs_by_proxy, dtype=np.int64),
        evictions_per_set=_ripple_finish(hist),
        n_sets_recorded=n_sets,
        n_primary=n_primary,
        n_ripple=n_ripple,
        n_batch_evictions=n_batch,
        final_vlen=np.asarray([cache.vlen(i) for i in range(J)]),
        elapsed_s=elapsed,
    )


# ---------------------------------------------------------------------------
# Section IV-C: online admission-control episodes
# ---------------------------------------------------------------------------
def _round_seed(trace_seed: int, round_idx: int) -> int:
    """Deterministic per-round estimation-trace seed, independent of the
    validation trace (which uses ``trace_seed`` itself)."""
    ss = np.random.SeedSequence([int(trace_seed), int(round_idx), 0xAD31])
    return int(ss.generate_state(1)[0])


def _run_admission(sc: Scenario, device: DeviceLike = None) -> Report:
    """Replay a tenant-churn episode through the admission controller,
    then validate the surviving configuration with the scenario's
    estimator.

    Per round: departures release their virtual allocations (footnote-1
    refresh), arrivals face the conservative eq. (13) test (optionally
    retried once after a refresh), the active tenants generate
    ``round_requests`` of estimation traffic, popularity estimates are
    refreshed, virtual allocations recomputed via eq. (10), and — if the
    commitment overflowed — most-recently-admitted tenants are evicted.

    The returned Report is the *validation* report of the final admitted
    set running at its final (integer-rounded) virtual allocations, with
    the full episode — decisions, allocations, overbooking gain, and
    predicted-vs-realized SLA hit rates — under
    ``Report.extras["admission"]``.
    """
    wl, system, spec = sc.workload, sc.system, sc.system.admission
    if wl.kind != "tenant_churn":
        raise ValueError(
            "System(admission=...) needs a tenant_churn workload "
            f"(got kind={wl.kind!r})"
        )
    T, N = wl.n_proxies, wl.n_objects
    B = system.capacity()
    trace_seed, length_seed = derive_seeds(sc.seed)
    lengths = wl.object_lengths(length_seed).astype(np.float64)
    lam_true = wl.rates()
    b_star = np.asarray(system.allocations, dtype=np.float64)

    ctl = AdmissionController(
        B,
        lengths,
        attribution=spec.attribution,
        safety_margin=spec.safety_margin,
        device=device,
    )
    estimator = PopularityEstimator(T, N)
    name = [f"tenant{i}" for i in range(T)]
    active: list = []
    n_est_requests = 0

    t0 = time.perf_counter()
    by_round = wl.events_by_round()
    for r in range(wl.n_rounds):
        for action, i in by_round.get(r, ()):
            if action == "depart":
                if i in active:
                    active.remove(i)
                    ctl.depart(name[i])
                    estimator.reset_proxy(i)
                continue
            d = ctl.admit(name[i], float(b_star[i]))
            if not d.admitted and spec.refresh_on_reject:
                # Free the sharing surplus the estimates justify, then
                # retry once — the paper's stated use of the working-set
                # approximation ("to facilitate admission control").
                ctl.refresh()
                d = ctl.admit(name[i], float(b_star[i]))
            if d.admitted:
                active.append(i)
        if active and wl.round_requests:
            rows = np.asarray(sorted(active), dtype=np.int64)
            t = sample_trace(
                lam_true[rows], wl.round_requests, seed=_round_seed(trace_seed, r)
            )
            estimator.observe_trace(
                IRMTrace(rows[t.proxies].astype(np.int32), t.objects)
            )
            n_est_requests += len(t)
            rates = estimator.rates(laplace=spec.laplace)
            for i in active:
                ctl.observe(name[i], rates[i])
            ctl.refresh()
            if spec.decay < 1.0:
                estimator.decay(spec.decay)
        if spec.evict_on_overcommit:
            for victim in ctl.enforce():
                active.remove(int(victim.removeprefix("tenant")))
    episode_s = time.perf_counter() - t0

    active = sorted(active)
    b_virtual = {i: ctl.tenants[name[i]].b_virtual for i in active}
    admission: dict = {
        "decisions": [d.to_dict() for d in ctl.log],
        "active_tenants": list(active),
        "tenant_names": [name[i] for i in active],
        "b_star": {name[i]: float(b_star[i]) for i in active},
        "b_virtual": {name[i]: float(b_virtual[i]) for i in active},
        "capacity": float(B),
        "committed": float(ctl.committed),
        "committed_sla": float(ctl.committed_sla),
        "overbooked": bool(ctl.overbooked),
        "overbooking_gain": float(ctl.overbooking_gain),
        "n_admitted": sum(1 for d in ctl.log if d.action == "admit"),
        "n_rejected": sum(1 for d in ctl.log if d.action == "reject"),
        "n_departed": sum(1 for d in ctl.log if d.action == "depart"),
        "n_evicted": sum(1 for d in ctl.log if d.action == "evict"),
        "n_estimation_requests": int(n_est_requests),
        "episode_s": float(episode_s),
    }

    if not active:
        return Report(
            scenario=sc.to_dict(),
            estimator=sc.estimator.kind,
            backend="none",
            hit_prob=np.zeros((0, N)),
            hit_rate=np.zeros(0),
            overall_hit_rate=0.0,
            n_requests=0,
            warmup=0,
            elapsed_s=episode_s,
            throughput_rps=0.0,
            extras={"admission": admission},
        )

    # -- validation: final admitted set at its final virtual allocations.
    # Integer-rounded (the engines allocate in object-length units); the
    # exact floats stay in extras["admission"]["b_virtual"].
    b_int = tuple(max(1, round(b_virtual[i])) for i in active)
    admission["b_virtual_int"] = list(b_int)
    val_wl = Workload(
        kind="irm",
        n_objects=N,
        alphas=tuple(wl.alphas[i] for i in active),
        proxy_rates=(
            tuple(wl.proxy_rates[i] for i in active)
            if wl.proxy_rates is not None
            else None
        ),
        lengths=wl.lengths,
    )
    val_sys = System(
        variant=system.variant,
        allocations=b_int,
        physical_capacity=B,
        ghost_retention=system.ghost_retention,
        backend=system.backend,
    )
    val_sc = Scenario(
        name=f"{sc.name}/validation",
        description="final admitted set at its virtual allocations",
        workload=val_wl,
        system=val_sys,
        estimator=sc.estimator,
        n_requests=sc.n_requests,
        warmup=sc.warmup,
        seed=sc.seed,
    )
    rep = run_scenario(val_sc, device)

    # -- eq. (10) promise: each admitted tenant's hit rate under sharing
    # at b_virtual should match a dedicated (unshared) b* cache.
    lam_active = lam_true[np.asarray(active, dtype=np.int64)]
    sol_star = solve_workingset_unshared(
        lam_active, lengths, b_star[np.asarray(active, dtype=np.int64)],
        device=device,
    )
    predicted = sol_star.hit_rate
    # Counted hits when the validation simulated (Report.realized_hit_rate
    # semantics); the occupancy/fixed-point estimate otherwise.
    realized = (
        rep.realized_hit_rate
        if rep.realized_hit_rate is not None
        else rep.hit_rate
    )
    admission["predicted_sla_hit_rate"] = [float(x) for x in predicted]
    admission["realized_hit_rate"] = [float(x) for x in realized]
    admission["estimated_hit_rate"] = [float(x) for x in rep.hit_rate]
    gaps = np.asarray(realized) - np.asarray(predicted)
    admission["max_abs_sla_gap"] = float(np.max(np.abs(gaps)))
    admission["min_sla_margin"] = float(np.min(gaps))
    return dataclasses.replace(
        rep,
        scenario=sc.to_dict(),
        extras={**rep.extras, "admission": admission},
    )


# ---------------------------------------------------------------------------
# Serving workloads: multi-tenant KV prefix-block traces
# ---------------------------------------------------------------------------
def _serving_cost(wl: Workload):
    """(ServingCostModel, bytes_per_block) for a serving workload.

    ``kv_arch=None`` falls back to unit pricing (1 block = 1 byte =
    1 FLOP-unit); otherwise the architecture's KV layout sizes the
    blocks and its active-parameter count prices prefill."""
    from repro_torch.serving.costs import ServingCostModel

    if wl.kv_arch is None:
        return ServingCostModel.unit(), 1.0
    from repro_torch.cacheblocks.kv_layout import layout_for
    from repro_torch.configs import get_config

    cfg = get_config(wl.kv_arch)
    kvl = layout_for(cfg, block_tokens=wl.block_tokens)
    # state archs snapshot fixed-size prefix states instead of per-token KV
    bpb = float(max(kvl.bytes_per_block, kvl.state_bytes, 1))
    cost = ServingCostModel.for_arch(
        cfg, bytes_per_token=bpb / wl.block_tokens
    )
    return cost, bpb


def _union_residency(occ, ids: np.ndarray) -> np.ndarray:
    """``min(1, sum_i occ[i, k])`` looked up at object ids ``k``.

    The clip makes it the union-residency upper bound: a block resident
    in any tenant's list (occupancy sums can exceed 1 when shared) is
    served from cache regardless of who holds it."""
    flat = np.asarray(ids, dtype=np.int64).ravel()
    if isinstance(occ, SparseOccupancy):
        u = np.zeros(flat.size, dtype=np.float64)
        if occ.indices.size:
            col = occ.values.sum(axis=0)
            pos = np.clip(
                np.searchsorted(occ.indices, flat), 0, occ.indices.size - 1
            )
            hit = occ.indices[pos] == flat
            u[hit] = col[pos[hit]]
    else:
        u = np.asarray(occ, dtype=np.float64).sum(axis=0)[flat]
    return np.minimum(u, 1.0).reshape(np.asarray(ids).shape)


def _serving_onboarding(sc: Scenario, layout, device: DeviceLike = None):
    """Gate tenant onboarding through the eq. (13) test, then build the
    effective scenario the trace actually runs.

    Sequential admission in tenant order against the *declared* rate
    matrix — the serving model assumes the operator knows each tenant's
    prompt mix up front (the online-estimation variant is the
    ``tenant_churn`` episode). Admitted tenants run at their eq. (10)
    virtual allocations; rejected tenants keep their proxy slot (the
    serving object-id space is a function of T) but send no traffic and
    hold a minimal 1-block list. Returns ``(effective_scenario,
    active_tenants, admission_record)``.
    """
    wl, system, spec = sc.workload, sc.system, sc.system.admission
    T = wl.n_proxies
    B = float(system.capacity())
    lam = wl.rates()
    lengths = np.ones(layout.n_objects, dtype=np.float64)
    b_star = np.asarray(system.allocations, dtype=np.float64)
    name = [f"tenant{t}" for t in range(T)]
    ctl = AdmissionController(
        B,
        lengths,
        attribution=spec.attribution,
        safety_margin=spec.safety_margin,
        device=device,
    )
    active: list = []
    for t in range(T):
        d = ctl.admit(name[t], float(b_star[t]))
        if not d.admitted and spec.refresh_on_reject:
            # Free the sharing surplus the declared rates justify, then
            # retry once (same policy as the churn episode).
            ctl.refresh()
            d = ctl.admit(name[t], float(b_star[t]))
        if d.admitted:
            active.append(t)
            ctl.observe(name[t], lam[t])
            ctl.refresh()
    if spec.evict_on_overcommit:
        for victim in ctl.enforce():
            active.remove(int(victim.removeprefix("tenant")))
    active = sorted(active)
    if not active:
        raise ValueError(
            "admission rejected every serving tenant; grow "
            "physical_capacity or shrink the per-tenant allocations"
        )
    b_virtual = {t: ctl.tenants[name[t]].b_virtual for t in active}
    b_eff = [
        max(1, round(b_virtual[t])) if t in active else 1 for t in range(T)
    ]
    # Integer rounding plus the 1-block slots rejected tenants keep can
    # nudge the total past B (eq. (11) is a hard engine precondition):
    # shave the largest admitted allocations back until it fits.
    over = sum(b_eff) - int(B)
    while over > 0:
        t = max(active, key=lambda i: b_eff[i])
        if b_eff[t] <= 1:
            break
        take = min(over, b_eff[t] - 1)
        b_eff[t] -= take
        over -= take
    b_eff = tuple(b_eff)
    mix = (
        wl.proxy_rates
        if wl.proxy_rates is not None
        else tuple([1.0] * T)
    )
    eff_mix = tuple(
        float(mix[t]) if t in active else 0.0 for t in range(T)
    )
    eff = dataclasses.replace(
        sc,
        workload=dataclasses.replace(wl, proxy_rates=eff_mix),
        system=dataclasses.replace(
            system, allocations=b_eff, admission=None
        ),
    )
    admission: dict = {
        "decisions": [d.to_dict() for d in ctl.log],
        "active_tenants": list(active),
        "tenant_names": [name[t] for t in active],
        "b_star": {name[t]: float(b_star[t]) for t in active},
        "b_virtual": {name[t]: float(b_virtual[t]) for t in active},
        "b_virtual_int": [int(b_eff[t]) for t in active],
        "capacity": B,
        "committed": float(ctl.committed),
        "committed_sla": float(ctl.committed_sla),
        "overbooked": bool(ctl.overbooked),
        "overbooking_gain": float(ctl.overbooking_gain),
        "n_admitted": sum(1 for d in ctl.log if d.action == "admit"),
        "n_rejected": sum(1 for d in ctl.log if d.action == "reject"),
        "n_evicted": sum(1 for d in ctl.log if d.action == "evict"),
    }
    # eq. (10) promise per admitted tenant: the hit rate of a dedicated
    # (unshared) b* cache, to compare against the realized rate.
    idx = np.asarray(active, dtype=np.int64)
    sol = solve_workingset_unshared(
        lam[idx], lengths, b_star[idx], device=device
    )
    admission["predicted_sla_hit_rate"] = [float(x) for x in sol.hit_rate]
    return eff, active, admission


def _serving_report(
    sc: Scenario,
    eff: Scenario,
    rep: Report,
    layout,
    active,
    admission,
) -> ServingReport:
    """Translate a block-trace Report into serving economics."""
    wl = sc.workload
    cost, bpb = _serving_cost(wl)
    btok = wl.block_tokens
    occ = rep.hit_prob

    # -- hit economics from the drive-loop counters (whole trace).
    n_hits = int(rep.extras.get("n_hit_list", 0)) + int(
        rep.extras.get("n_hit_cache", 0)
    )
    n_miss = int(rep.extras.get("n_miss", 0))
    n_events = n_hits + n_miss
    ratio = (
        n_hits / n_events if n_events else float(rep.overall_hit_rate)
    )
    tokens_saved = float(n_hits) * btok

    # -- sharing economics from steady-state occupancy. col[k] is the
    # expected number of tenant lists holding block k; every holder past
    # the first is a copy the shared store does not materialize.
    if isinstance(occ, SparseOccupancy):
        col = occ.values.sum(axis=0)
    else:
        col = np.asarray(occ, dtype=np.float64).sum(axis=0)
    bytes_shared_lb = float(bpb * np.maximum(col - 1.0, 0.0).sum())
    unshared_bytes = float(bpb * col.sum())

    # -- latency proxy: roofline prefill time of the expected missing
    # tokens per request, over the (tenant, prompt) demand distribution
    # the trace actually ran (rejected tenants carry zero weight).
    T, R, C = layout.n_tenants, layout.n_prompts, layout.suffix_choices
    tt = np.repeat(np.arange(T, dtype=np.int64), R * C)
    rr = np.tile(np.repeat(np.arange(R, dtype=np.int64), C), T)
    cc = np.tile(np.arange(C, dtype=np.int64), T * R)
    objs = layout.request_objects(tt, rr, cc)
    miss_blocks = (1.0 - _union_residency(occ, objs)).sum(axis=1)
    miss_blocks = miss_blocks.reshape(T, R, C).mean(axis=2)
    miss_tok = miss_blocks * btok
    lat = np.maximum(
        miss_tok * cost.flops_per_token / cost.peak_flops,
        miss_tok * cost.kv_bytes_per_token / cost.hbm_bw,
    )
    emix = eff.workload.proxy_rates
    shares = (
        np.full(T, 1.0 / T)
        if emix is None
        else np.asarray(emix, dtype=np.float64)
    )
    shares = shares / max(shares.sum(), 1e-300)
    w = (shares[:, None] * popularity(layout, wl.alphas)).ravel()
    order = np.argsort(lat.ravel())
    lat_sorted, cw = lat.ravel()[order], np.cumsum(w[order])
    p99_idx = min(
        int(np.searchsorted(cw, 0.99 * cw[-1])), lat_sorted.size - 1
    )
    return ServingReport(
        tenants=T,
        active_tenants=tuple(int(t) for t in active),
        blocks_per_request=int(layout.blocks_per_request),
        block_tokens=int(btok),
        bytes_per_block=float(bpb),
        kv_arch=wl.kv_arch,
        n_block_events=n_events,
        n_serving_requests=n_events / layout.blocks_per_request,
        prefix_hit_block_ratio=float(ratio),
        prefix_hit_token_ratio=float(ratio),
        prefill_tokens_saved=tokens_saved,
        flops_per_token=float(cost.flops_per_token),
        prefill_flops_saved=cost.prefill_flops(tokens_saved),
        bytes_shared_lb=bytes_shared_lb,
        unshared_equivalent_bytes=unshared_bytes,
        final_virtual_bytes=(
            tuple(float(v) * bpb for v in rep.final_vlen)
            if rep.final_vlen is not None
            else None
        ),
        latency_mean_s=float((lat.ravel() * w).sum() / max(w.sum(), 1e-300)),
        latency_p99_s=float(lat_sorted[p99_idx]),
        latency_cold_s=cost.prefill_time_s(
            layout.blocks_per_request * btok
        ),
        admission=admission,
    )


def _run_serving(sc: Scenario, device: DeviceLike = None) -> Report:
    """Run a serving workload: compile → drive → translate.

    The compiled block trace goes through the ordinary Monte-Carlo (any
    fastsim backend, streaming, ensembles, reference) or working-set
    path; this wrapper only gates onboarding (when ``admission`` is
    set) and attaches the :class:`ServingReport` afterwards.
    """
    wl, system = sc.workload, sc.system
    if system.is_cluster:
        raise ValueError(
            "serving workloads do not support cluster systems yet"
        )
    if system.variant not in ("lru", "noshare"):
        raise ValueError(
            "serving workloads support variants 'lru' (shared prefix "
            f"store) and 'noshare' (dedicated) only, got {system.variant!r}"
        )
    layout = wl.serving_layout()
    eff, active, admission = (
        _serving_onboarding(sc, layout, device)
        if system.admission is not None
        else (sc, list(range(wl.n_proxies)), None)
    )
    rep = (
        _run_working_set(eff, device)
        if eff.estimator.kind == "working_set"
        else _run_monte_carlo(eff, device)
    )
    if admission is not None:
        realized = (
            rep.realized_hit_rate
            if rep.realized_hit_rate is not None
            else rep.hit_rate
        )
        admission["realized_hit_rate"] = [
            float(realized[t]) for t in active
        ]
        gaps = np.asarray(admission["realized_hit_rate"]) - np.asarray(
            admission["predicted_sla_hit_rate"]
        )
        admission["max_abs_sla_gap"] = float(np.max(np.abs(gaps)))
        admission["min_sla_margin"] = float(np.min(gaps))
    serving = _serving_report(sc, eff, rep, layout, active, admission)
    return dataclasses.replace(
        rep,
        scenario=sc.to_dict(),
        extras={**rep.extras, "serving": serving.to_dict()},
    )
