"""Streaming and sparse occupancy in the port against the reference:
``tests/test_streaming.py``'s assertions, diffed on the same NumPy traces.

The port's chunk-fed host drivers (Python loop, C loop) must give the
reference's one-shot result bit for bit whatever the chunking; the
sparse occupancy must densify to the dense one; the scenario layer's
streaming mode, its auto selection, its seed substreams and the NaN of a
starved proxy must be the reference's. The lane engine's streaming legs
are in ``tests/test_torch_fastsim.py``. Traces are 10^4 requests.
"""

import ctypes
import dataclasses
import threading
import warnings

import numpy as np
import pytest

from repro.core import SimParams as JSimParams
from repro.core import simulate_trace as jsimulate_trace
from repro.scenario import Estimator as JEstimator
from repro.scenario import LengthSpec as JLengthSpec
from repro.scenario import Scenario as JScenario
from repro.scenario import System as JSystem
from repro.scenario import Workload as JWorkload
from repro.scenario.runner import derive_seeds as jderive_seeds
from repro.scenario.runner import use_streaming as juse_streaming
from repro_torch.core import (
    SimParams,
    SparseOccupancy,
    rate_matrix,
    sample_trace,
    sample_trace_chunks,
    simulate_chunks,
    simulate_trace,
)
from repro_torch.core import fastsim_c
from repro_torch.scenario import Estimator, LengthSpec, Scenario, System, Workload
from repro_torch.scenario.report import Report
from repro_torch.scenario.runner import (
    STREAMING_REQUEST_CELLS,
    STREAMING_STATE_CELLS,
    derive_seeds,
    use_streaming,
)

N_OBJ, ALPHAS, N_REQ, WARMUP = 300, [0.75, 0.5, 1.0], 10_000, 1_000
CHUNK_SIZES = (997, 3_001)       # prime; inside eviction bursts; a ragged last chunk
PARAM_GRID = [dict(), dict(ghost_retention=False), dict(ripple_allocations=(12, 20, 12)),
              dict(ripple_allocations=(10, 18, 10), batch_interval=50)]
c_only = pytest.mark.skipif(not fastsim_c.available(), reason="no C compiler")


@pytest.fixture(scope="module")
def setup():
    lam = rate_matrix(N_OBJ, ALPHAS)
    return lam, sample_trace(lam, N_REQ, seed=11)


def _chunks(lam, size):
    return sample_trace_chunks(lam, N_REQ, chunk_size=size, seed=11)


def _dense(occ):
    return occ.densify() if hasattr(occ, "densify") else occ


def _same(a, b):
    assert np.array_equal(_dense(a.occupancy), _dense(b.occupancy))
    for k in ("evictions_per_set", "hits_by_proxy", "reqs_by_proxy", "final_vlen"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k in ("n_hit_list", "n_hit_cache", "n_miss", "n_ripple", "n_primary",
              "n_batch_evictions", "n_sets_recorded"):
        assert getattr(a, k) == getattr(b, k), k


@pytest.mark.parametrize("engine", ["flat", pytest.param("c", marks=c_only)])
@pytest.mark.parametrize("kw", PARAM_GRID)
def test_chunked_bitidentical_to_reference_oneshot(setup, kw, engine, monkeypatch):
    """The C loop starts with a touched set of 8 slots, so its mid-chunk
    grow-and-resume runs many times over."""
    lam, trace = setup
    monkeypatch.setattr(fastsim_c, "INITIAL_SLOT_CAP", 8)
    want = jsimulate_trace(JSimParams(allocations=(8, 16, 8), physical_capacity=300, **kw),
                           trace, N_OBJ, warmup=WARMUP, engine="flat")
    p = SimParams(allocations=(8, 16, 8), physical_capacity=300, **kw)
    for cs in CHUNK_SIZES:
        got = simulate_chunks(p, _chunks(lam, cs), N_OBJ, N_REQ, warmup=WARMUP, engine=engine)
        assert isinstance(got.occupancy, SparseOccupancy)
        _same(got, want)


def test_chunked_other_variants_bitidentical_to_reference(setup):
    lam, trace = setup
    for kw in (dict(allocations=(16, 24, 8), variant="noshare"),
               dict(allocations=(12, 12, 12), variant="pooled"),
               dict(allocations=(32, 32, 32), physical_capacity=300, variant="slru")):
        want = jsimulate_trace(JSimParams(**kw), trace, N_OBJ, warmup=WARMUP)
        _same(simulate_chunks(SimParams(**kw), _chunks(lam, 997), N_OBJ, N_REQ,
                              warmup=WARMUP), want)


def test_sparse_occupancy_densifies_exactly(setup):
    _, trace = setup
    p = SimParams(allocations=(8, 16, 8), physical_capacity=300)
    want = jsimulate_trace(JSimParams(allocations=(8, 16, 8), physical_capacity=300), trace,
                           N_OBJ, warmup=WARMUP, engine="flat", sparse=False).occupancy
    for engine in ["flat"] + (["c"] if fastsim_c.available() else []):
        dense = simulate_trace(p, trace, N_OBJ, warmup=WARMUP, engine=engine, sparse=False)
        occ = simulate_trace(p, trace, N_OBJ, warmup=WARMUP, engine=engine, sparse=True).occupancy
        assert np.array_equal(dense.occupancy, want)
        assert isinstance(occ, SparseOccupancy) and occ.shape == want.shape
        assert np.all(np.diff(occ.indices) > 0) and occ.values.any(axis=0).all()
        assert np.array_equal(occ.densify(), want)
        untouched = np.setdiff1d(np.arange(N_OBJ), occ.indices)
        assert np.all(want[:, untouched] == 0.0)
        probe = [0, 1, int(occ.indices[-1])] + untouched[:2].tolist()
        for i in range(3):
            assert np.array_equal(occ.lookup(i, probe), want[i, probe])


def test_simulate_chunks_validates_stream_length(setup):
    lam, _ = setup
    with pytest.raises(ValueError, match="n_requests"):
        simulate_chunks(SimParams(allocations=(8, 16, 8), physical_capacity=300),
                        _chunks(lam, 4_000), N_OBJ, N_REQ + 5, warmup=WARMUP, engine="flat")


# -- the scenario layer -------------------------------------------------------

def _small(S, W, Sys, E, **kw):
    d = dict(name="stream-small", workload=W(n_objects=200, alphas=(0.7, 1.0)),
             system=Sys(allocations=(12, 12), physical_capacity=120),
             estimator=E("monte_carlo"), n_requests=10_000, seed=3)
    d.update(kw)
    return S(**d)


def test_streaming_scenario_equals_dense_and_reference():
    sys_kw = dict(allocations=(12, 12), physical_capacity=140, slack_frac=0.25,
                  batch_interval=100, backend="c")
    sc = _small(Scenario, Workload, System, Estimator, system=System(**sys_kw), ripple_from=0)
    jsc = _small(JScenario, JWorkload, JSystem, JEstimator, system=JSystem(**sys_kw),
                 ripple_from=0)
    dense = sc.run()
    stream = dataclasses.replace(sc, estimator=Estimator("monte_carlo", streaming=True,
                                                         chunk_size=4_096)).run()
    jstream = dataclasses.replace(jsc, estimator=JEstimator("monte_carlo", streaming=True,
                                                            chunk_size=4_096)).run()
    assert dense.extras["streaming"] is False and stream.extras["streaming"] is True
    assert stream.extras["chunk_size"] == 4_096
    assert stream.hit_prob_is_sparse and not dense.hit_prob_is_sparse
    np.testing.assert_array_equal(stream.dense_hit_prob(), dense.hit_prob)
    np.testing.assert_array_equal(stream.realized_hit_rate, dense.realized_hit_rate)
    assert stream.ripple == dense.ripple
    np.testing.assert_allclose(stream.hit_rate, dense.hit_rate, rtol=1e-12)
    back = Report.from_dict(jstream.to_dict())
    assert back.same_estimates(stream) and stream.same_estimates(back)
    rt = Report.from_dict(stream.to_dict())
    assert rt.same_estimates(stream)
    assert rt.hit_prob_at_ranks(0, (1, 10, 100)) == stream.hit_prob_at_ranks(0, (1, 10, 100))


def test_streaming_auto_selection_equals_reference():
    pairs = [(_small(Scenario, Workload, System, Estimator, **kw),
              _small(JScenario, JWorkload, JSystem, JEstimator, **jkw), n)
             for kw, jkw, n in (
                 ({}, {}, None),
                 ({}, {}, STREAMING_REQUEST_CELLS // 2 + 1),
                 (dict(workload=Workload(n_objects=STREAMING_STATE_CELLS // 2 + 1,
                                         alphas=(0.7, 1.0)), n_requests=1_000),
                  dict(workload=JWorkload(n_objects=STREAMING_STATE_CELLS // 2 + 1,
                                          alphas=(0.7, 1.0)), n_requests=1_000), None),
             )]
    got = []
    for sc, jsc, n in pairs:
        n = sc.n_requests if n is None else n
        got.append(use_streaming(sc, n))
        assert got[-1] == juse_streaming(jsc, n)
    assert got == [False, True, True]
    big = pairs[2][0]
    off = dataclasses.replace(big, estimator=Estimator("monte_carlo", streaming=False))
    assert use_streaming(off, off.n_requests) is False
    ref = _small(Scenario, Workload, System, Estimator,
                 system=System(allocations=(12, 12), physical_capacity=120, backend="reference"),
                 estimator=Estimator("monte_carlo", streaming=True))
    with pytest.raises(ValueError, match="reference"):
        use_streaming(ref, ref.n_requests)


def test_seed_substreams_and_lognormal_lengths_equal_reference():
    for seed in (7, 8):
        assert derive_seeds(seed) == jderive_seeds(seed)
    a = derive_seeds(7)
    assert a[0] != a[1] and a != derive_seeds(8)
    kw = dict(n_objects=200, alphas=(0.7, 1.0))
    sc = _small(Scenario, Workload, System, Estimator, system=System(
        allocations=(12, 12), physical_capacity=120, backend="c"),
        workload=Workload(**kw, lengths=LengthSpec("lognormal", sigma=0.8, max_len=9)))
    jsc = _small(JScenario, JWorkload, JSystem, JEstimator, system=JSystem(
        allocations=(12, 12), physical_capacity=120, backend="c"),
        workload=JWorkload(**kw, lengths=JLengthSpec("lognormal", sigma=0.8, max_len=9)))
    r1, r2 = sc.run(), sc.run()
    assert r1.same_estimates(r2)
    assert Report.from_dict(jsc.run().to_dict()).same_estimates(r1)


def test_zero_request_proxy_reports_nan_like_reference():
    out = []
    for S, W, Sys in ((Scenario, Workload, System), (JScenario, JWorkload, JSystem)):
        sc = S(name="starved", workload=W(n_objects=100, alphas=(0.7, 1.0),
                                          proxy_rates=(1.0, 1e-12)),
               system=Sys(allocations=(10, 10), physical_capacity=100, backend="c"),
               n_requests=2_000, warmup=500, seed=5)
        with warnings.catch_warnings():
            warnings.simplefilter("error")        # any RuntimeWarning fails
            out.append(sc.run())
    rep = out[0]
    assert np.isnan(rep.realized_hit_rate[1]) and np.isfinite(rep.realized_hit_rate[0])
    assert np.isfinite(rep.overall_hit_rate)
    assert Report.from_dict(rep.to_dict()).same_estimates(rep)
    assert Report.from_dict(out[1].to_dict()).same_estimates(rep)


# -- the port's on-demand C build ------------------------------------------------

@pytest.mark.skipif(fastsim_c._compiler() is None, reason="no C compiler")
def test_concurrent_c_builds_race_safely(tmp_path):
    cc, name = fastsim_c._compiler(), "fastsim_race_test.so"
    results, errors = [], []

    def build():
        try:
            results.append(fastsim_c._build_so(cc, fastsim_c._SRC, tmp_path, name))
        except Exception as e:  # pragma: no cover - the assertion target
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and all(p == tmp_path / name for p in results)
    assert hasattr(ctypes.CDLL(str(tmp_path / name)), "drive_chunk")
    assert [p.name for p in tmp_path.iterdir()] == [name]     # no leaked .tmp files
    winner = tmp_path / "fastsim_winner.so"
    winner.write_bytes(b"sentinel: a prior winner")
    assert fastsim_c._build_so(cc, fastsim_c._SRC, tmp_path, winner.name) == winner
    assert winner.read_bytes() == b"sentinel: a prior winner"  # not clobbered
