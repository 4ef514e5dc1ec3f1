"""R-lane ensembles of the port's lane engine against the reference.

The port of ``tests/test_ensemble.py``, with the lane engine's host
build (``device="cpu"``) in the place of the XLA program: lane r of the
batched runner equals a single run on trace r, a sweep lane equals its
dedicated run, a streamed ensemble equals the one-shot one, and each
equals the reference's ``fastsim_jax.simulate_ensemble`` on the same
traces. At the scenario level, ``Estimator(replications=R)`` on
``backend="cuda"`` gives the reference's Report (``same_estimates``
through ``from_dict``, in both directions).
"""

import dataclasses
import json

import numpy as np
import pytest

from repro.core import fastsim_jax as jfx
from repro.core.fastsim import SimParams as JSimParams
from repro.scenario import Estimator as JEstimator
from repro.scenario import Scenario as JScenario
from repro.scenario import System as JSystem
from repro.scenario import Workload as JWorkload
from repro.scenario.report import Report as JReport
from repro_torch.core.fastsim import SimParams, simulate_trace
from repro_torch.core.fastsim_cuda import BatchedCudaRunner, simulate_ensemble
from repro_torch.core.irm import rate_matrix, sample_trace, sample_trace_chunks
from repro_torch.scenario import Estimator, Scenario, System, Workload
from repro_torch.scenario.report import Report
from repro_torch.scenario.runner import ensemble_seeds
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

N_OBJ, N_REQ, WARMUP, R = 250, 6_000, 600, 4
CPU = "cpu"


@pytest.fixture(scope="module")
def lam():
    return rate_matrix(N_OBJ, [0.75, 0.5, 1.0])


@pytest.fixture(scope="module")
def traces(lam):
    return [sample_trace(lam, N_REQ, seed=100 + r) for r in range(R)]


def _assert_bitidentical(a, b):
    assert np.array_equal(a.dense_occupancy(), b.dense_occupancy())
    assert np.array_equal(a.final_vlen, b.final_vlen)
    assert np.array_equal(a.evictions_per_set, b.evictions_per_set)
    assert np.array_equal(a.hits_by_proxy, b.hits_by_proxy)
    assert np.array_equal(a.reqs_by_proxy, b.reqs_by_proxy)
    assert (a.n_hit_list, a.n_hit_cache, a.n_miss) == (b.n_hit_list, b.n_hit_cache, b.n_miss)
    assert (a.n_sets_recorded, a.n_primary, a.n_ripple) == (
        b.n_sets_recorded, b.n_primary, b.n_ripple)


@pytest.mark.parametrize(
    "kw", [dict(), dict(ghost_retention=False), dict(ripple_allocations=(12, 20, 12))]
)
def test_every_lane_equals_single_run_and_reference_ensemble(traces, kw):
    p = SimParams(allocations=(8, 16, 8), physical_capacity=220, **kw)
    ens = simulate_ensemble(p, traces, N_OBJ, warmup=WARMUP, device=CPU)
    ref = jfx.simulate_ensemble(JSimParams(allocations=(8, 16, 8), physical_capacity=220, **kw),
                                traces, N_OBJ, warmup=WARMUP)
    for r, t in enumerate(traces):
        single = simulate_trace(p, t, N_OBJ, warmup=WARMUP, engine="cuda", device=CPU)
        _assert_bitidentical(ens[r], single)
        _assert_bitidentical(ens[r], ref[r])
        assert ens[r].engine == "cuda"
    assert not np.array_equal(ens[0].dense_occupancy(), ens[1].dense_occupancy())


def test_streamed_ensemble_equals_oneshot(lam, traces):
    p = SimParams(allocations=(8, 16, 8), physical_capacity=220)
    oneshot = simulate_ensemble(p, traces, N_OBJ, warmup=WARMUP, device=CPU)
    streamed = simulate_ensemble(
        p,
        [sample_trace_chunks(lam, N_REQ, chunk_size=1_111, seed=100 + r) for r in range(R)],
        N_OBJ, N_REQ, warmup=WARMUP, sparse=True, device=CPU,
    )
    for a, b in zip(streamed, oneshot):
        assert a.occupancy_is_sparse
        _assert_bitidentical(a, b)


def test_sweep_lanes_match_dedicated_runs_and_reference(traces):
    p = SimParams(allocations=(8, 16, 8), physical_capacity=220)
    b_sweep = np.array([[8, 16, 8], [16, 8, 8], [10, 10, 10]])
    bhat_sweep = b_sweep + np.array([[0, 0, 0], [2, 2, 2], [0, 1, 2]])
    run = BatchedCudaRunner(p, N_OBJ, np.ones(N_OBJ, np.int64), WARMUP, WARMUP, 6, 3,
                            b_sweep=b_sweep, bhat_sweep=bhat_sweep, device=CPU)
    ref = jfx.BatchedXLARunner(JSimParams(allocations=(8, 16, 8), physical_capacity=220),
                               N_OBJ, np.ones(N_OBJ, np.int64), WARMUP, WARMUP, 6, 3,
                               b_sweep=b_sweep, bhat_sweep=bhat_sweep)
    for x in (run, ref):
        x.feed(np.stack([t.proxies for t in traces[:3]]),
               np.stack([t.objects for t in traces[:3]]))
    outs, ref_outs = run.finish(N_REQ), ref.finish(N_REQ)
    for r in range(3):
        for k, v in ref_outs[r].items():
            assert np.array_equal(np.asarray(outs[r][k]), np.asarray(v)), (r, k)
        ded = simulate_trace(
            SimParams(allocations=tuple(int(x) for x in b_sweep[r]), physical_capacity=220,
                      ripple_allocations=tuple(int(x) for x in bhat_sweep[r])),
            traces[r], N_OBJ, warmup=WARMUP, engine="c",
        )
        assert outs[r]["n_miss"] == ded.n_miss
        assert np.array_equal(np.asarray(outs[r]["vlen"]),
                              (np.asarray(ded.final_vlen) * 6).astype(np.int64))
        assert np.array_equal(outs[r]["tot_time"].reshape(3, N_OBJ),
                              np.rint(ded.occupancy * max(N_REQ - WARMUP, 1)).astype(np.int64))


def test_sweep_points_are_checked():
    p = SimParams(allocations=(8, 16, 8), physical_capacity=220)
    with pytest.raises(ValueError, match="b_hat >= b"):
        BatchedCudaRunner(p, N_OBJ, np.ones(N_OBJ, np.int64), 0, 0, 6, 2,
                          b_sweep=[[8, 8, 8], [9, 9, 9]], bhat_sweep=[[8, 8, 8], [8, 8, 8]],
                          device=CPU)
    with pytest.raises(ValueError, match=r"\(R, J\)"):
        BatchedCudaRunner(p, N_OBJ, np.ones(N_OBJ, np.int64), 0, 0, 6, 2,
                          b_sweep=[[8, 8, 8]], device=CPU)


def _scenarios(backend: str, replications: int, **est):
    out = []
    for Sc, Wl, Sy, Es in ((Scenario, Workload, System, Estimator),
                           (JScenario, JWorkload, JSystem, JEstimator)):
        out.append(Sc(
            name="ens-test",
            workload=Wl(kind="irm", n_objects=N_OBJ, alphas=(0.75, 0.5, 1.0)),
            system=Sy(allocations=(12, 12, 12), physical_capacity=N_OBJ,
                      backend=backend if Sc is Scenario else "c"),
            estimator=Es("monte_carlo", replications=replications, **est),
            n_requests=5_000,
            seed=17,
        ))
    return out


def _same_both_ways(port: Report, ref: JReport) -> None:
    as_ref = JReport.from_dict(json.loads(json.dumps(port.to_dict())))
    as_port = Report.from_dict(json.loads(json.dumps(ref.to_dict())))
    assert as_ref.same_estimates(ref) and ref.same_estimates(as_ref)
    assert as_port.same_estimates(port) and port.same_estimates(as_port)


@pytest.mark.parametrize("streaming", [False, True])
def test_scenario_ensemble_equals_reference(streaming):
    port_sc, ref_sc = _scenarios("cuda", 3, streaming=streaming, chunk_size=1_700)
    port = port_sc.run(device=CPU)
    ref = ref_sc.run()
    assert port.ensemble["batched"] is True and port.backend == "cuda"
    assert port.extras["streaming"] is streaming
    _same_both_ways(port, ref)
    seq = dataclasses.replace(port_sc, system=dataclasses.replace(port_sc.system,
                                                                  backend="c")).run()
    assert seq.ensemble["batched"] is False
    assert seq.same_estimates(port)


def test_replica0_equals_single_run_and_ci_accessors():
    single = _scenarios("cuda", 1)[0].run(device=CPU)
    ens = _scenarios("cuda", 4)[0].run(device=CPU)
    assert ens.replications == 4 and single.ensemble is None
    assert np.array_equal(ens.ensemble["hit_prob"][0], single.dense_hit_prob())
    assert np.array_equal(ens.ensemble["hit_rate"][0], single.hit_rate)
    assert ens.n_requests == 4 * single.n_requests
    mean, lo, hi = ens.hit_prob_ci(level=0.95)
    assert (lo <= mean + 1e-15).all() and (mean <= hi + 1e-15).all()
    back = Report.from_dict(json.loads(json.dumps(ens.to_dict())))
    assert back.same_estimates(ens)
    assert ensemble_seeds(12345, 4)[0] == 12345
