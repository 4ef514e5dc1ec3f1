"""The port's Monte-Carlo engines against the reference package.

The lane engine (``repro_torch.core.fastsim_cuda`` over
``repro_torch.kernels.lane_engine``) runs here as its host build, the
same step body as the CUDA kernel built by g++ (``device="cpu"``). It
must equal the reference's XLA lane engine (``engine="xla"``), C loop
and Python loop exactly: occupancy integers, virtual lengths, counters
and the evictions-per-set histogram — and the whole carried state,
array for array, against the XLA program's. The host copies
(``fastsim``, ``fastsim_c``) must equal the reference engines too.

The kernel on the card is tested by ``tests/test_torch_lane_engine.py``
(a file that imports no JAX, as the card's machine has none).
"""

import numpy as np
import pytest

from repro.core import fastsim_jax as jfx
from repro.core.fastsim import SimParams as JSimParams
from repro.core.fastsim import simulate_chunks as jsimulate_chunks
from repro.core.fastsim import simulate_trace as jsimulate_trace
from repro.core.irm import IRMTrace as JTrace
from repro.core.irm import rate_matrix, sample_trace, sample_trace_chunks
from repro_torch.core import fastsim, fastsim_c, fastsim_cuda
from repro_torch.core.fastsim import HIST_BUCKETS, SimParams, simulate_chunks, simulate_trace
from repro_torch.core.irm import IRMTrace

N_OBJ, N_REQ, WARMUP = 200, 4_000, 700
KWS = [
    dict(),
    dict(ghost_retention=False),
    dict(ripple_allocations=(10, 12, 9)),
]


@pytest.fixture(scope="module")
def lam():
    return rate_matrix(N_OBJ, [0.8, 1.0, 0.6])


@pytest.fixture(scope="module")
def trace(lam):
    return sample_trace(lam, N_REQ, seed=3)


@pytest.fixture(scope="module")
def lengths():
    return np.random.default_rng(1).integers(1, 4, N_OBJ)


def _assert_identical(a, b):
    assert np.array_equal(a.dense_occupancy(), b.dense_occupancy())
    assert np.array_equal(a.final_vlen, b.final_vlen)
    assert np.array_equal(a.evictions_per_set, b.evictions_per_set)
    assert np.array_equal(a.hits_by_proxy, b.hits_by_proxy)
    assert np.array_equal(a.reqs_by_proxy, b.reqs_by_proxy)
    assert (a.n_hit_list, a.n_hit_cache, a.n_miss) == (b.n_hit_list, b.n_hit_cache, b.n_miss)
    assert (a.n_sets_recorded, a.n_primary, a.n_ripple) == (
        b.n_sets_recorded, b.n_primary, b.n_ripple)


@pytest.mark.parametrize("kw", KWS)
def test_lane_engine_equals_reference_engines(trace, lengths, kw):
    """Unit and unequal lengths; ghosts on and off; RRE b_hat."""
    for lens in (None, lengths):
        jp = JSimParams(allocations=(8, 8, 6), physical_capacity=60, **kw)
        p = SimParams(allocations=(8, 8, 6), physical_capacity=60, **kw)
        got = simulate_trace(p, trace, N_OBJ, warmup=WARMUP, engine="cuda", device="cpu",
                             lengths=lens)
        assert got.engine == "cuda"
        for engine in ("xla", "c", "flat"):
            _assert_identical(got, jsimulate_trace(jp, trace, N_OBJ, warmup=WARMUP,
                                                   engine=engine, lengths=lens))
        assert got.n_miss > 0 and got.n_hit_list > 0


@pytest.mark.parametrize("kw", KWS)
def test_lane_state_equals_xla_state(trace, lengths, kw):
    """Every carried array of the lane equals the XLA program's, after a
    warmup split inside the first of two chunks."""
    jp = JSimParams(allocations=(8, 8, 6), physical_capacity=60, **kw)
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60, **kw)
    ref = jfx.XLAChunkRunner(jp, N_OBJ, lengths, WARMUP, WARMUP, 6)
    run = fastsim_cuda.CudaChunkRunner(p, N_OBJ, lengths, WARMUP, WARMUP, 6, device="cpu")
    for a, b in ((0, 1500), (1500, N_REQ)):
        ref.feed(trace.proxies[a:b], trace.objects[a:b])
        run.feed(trace.proxies[a:b], trace.objects[a:b])
    want = {k: np.asarray(v).reshape(-1) for k, v in ref.st.items()}
    got = run.state()
    assert set(want) <= set(got)
    for k, v in want.items():
        assert np.array_equal(got[k].reshape(-1), v), k
    assert int(got["t_start"][0]) == WARMUP
    out, ref_out = run.finish(N_REQ), ref.finish(N_REQ)
    for k, v in ref_out.items():
        assert np.array_equal(np.asarray(out[k]), np.asarray(v)), k


def test_lane_engine_equals_python_flat():
    """The xla leg of tests/test_fastsim.py, on the lane engine."""
    lam = rate_matrix(200, [0.8, 1.0])
    trace = sample_trace(lam, 20_000, seed=3)
    p = SimParams(allocations=(8, 8), physical_capacity=200)
    a = simulate_trace(p, trace, 200, warmup=2_000, engine="cuda", device="cpu")
    b = simulate_trace(p, trace, 200, warmup=2_000, engine="flat")
    assert np.array_equal(a.occupancy, b.occupancy)
    assert np.array_equal(a.evictions_per_set, b.evictions_per_set)
    assert a.n_hit_list == b.n_hit_list and a.n_miss == b.n_miss


def test_chunked_lane_engine_bitidentical_to_oneshot():
    """The xla leg of tests/test_streaming.py, on the lane engine, and
    against the reference's chunked XLA run."""
    lam = rate_matrix(200, [0.8, 1.0])
    trace = sample_trace(lam, 20_000, seed=3)
    p = SimParams(allocations=(8, 8), physical_capacity=200)
    oneshot = simulate_trace(p, trace, 200, warmup=2_000, engine="flat")
    chunked = simulate_chunks(
        p, sample_trace_chunks(lam, 20_000, chunk_size=3_333, seed=3), 200, 20_000,
        warmup=2_000, engine="cuda", device="cpu",
    )
    _assert_identical(chunked, oneshot)
    assert chunked.occupancy_is_sparse
    ref = jsimulate_chunks(
        JSimParams(allocations=(8, 8), physical_capacity=200),
        sample_trace_chunks(lam, 20_000, chunk_size=3_333, seed=3), 200, 20_000,
        warmup=2_000, engine="xla",
    )
    _assert_identical(chunked, ref)


def test_envelope_and_unsupported_options_raise(trace):
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60)
    big = np.full(N_OBJ, 2**28)          # max length * M * (J + 1) >= 2^31
    with pytest.raises(RuntimeError, match="not applicable"):
        simulate_trace(p, trace, N_OBJ, engine="cuda", device="cpu", lengths=big)
    rre = SimParams(allocations=(8, 8, 6), physical_capacity=60,
                    ripple_allocations=(9, 9, 7), batch_interval=5)
    with pytest.raises(RuntimeError, match="not applicable"):
        simulate_trace(rre, trace, N_OBJ, engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="does not support variant"):
        simulate_trace(SimParams(allocations=(8, 8, 6), variant="noshare"), trace, N_OBJ,
                       engine="cuda", device="cpu")
    with pytest.raises(ValueError, match="envelope"):
        fastsim_cuda.simulate_ensemble(p, [trace], N_OBJ, lengths=big, device="cpu")
    assert not fastsim._xla_applicable(N_REQ, N_OBJ, big, p)
    assert fastsim._xla_applicable(N_REQ, N_OBJ, np.ones(N_OBJ), p)
    # sweep lanes: one envelope, over every lane's b_hat
    rows = np.array([[8, 8, 6], [8, 8, 2**28]])
    assert not fastsim._xla_applicable(N_REQ, N_OBJ, np.ones(N_OBJ), p, rows)
    with pytest.raises(ValueError, match="envelope"):
        fastsim_cuda.BatchedCudaRunner(p, N_OBJ, np.ones(N_OBJ), 0, 0, 6, 2, b_sweep=rows,
                                       bhat_sweep=rows, device="cpu")


def test_histogram_clamps_into_the_last_bucket():
    """One set that evicts 1100 objects: every engine counts it in bucket
    HIST_BUCKETS - 1."""
    N = 1101
    lengths = np.ones(N, np.int64)
    lengths[0] = 1100
    objs = np.concatenate([np.arange(1, N), [0]])
    P, O = np.zeros(N, np.int32), objs.astype(np.int64)
    want = jsimulate_trace(JSimParams(allocations=(1100, 1100)), JTrace(P, O), N,
                           lengths=lengths, warmup=0, ripple_from=0, engine="c")
    got = simulate_trace(SimParams(allocations=(1100, 1100)), IRMTrace(P, O), N,
                         lengths=lengths, warmup=0, ripple_from=0, engine="cuda",
                         device="cpu")
    assert len(got.evictions_per_set) == HIST_BUCKETS
    assert got.evictions_per_set[-1] == 1 and got.n_primary == 1100
    _assert_identical(got, want)


def test_host_copies_equal_the_reference(trace, lengths):
    """fastsim (flat, generic, noshare, pooled, S-LRU) and the C loop,
    whose build is the port's own."""
    for kw in (dict(physical_capacity=60), dict(physical_capacity=60, batch_interval=7,
                                                ripple_allocations=(9, 10, 7))):
        for engine in ("c", "flat", "generic"):
            _assert_identical(
                simulate_trace(SimParams(allocations=(8, 8, 6), **kw), trace, N_OBJ,
                               warmup=WARMUP, engine=engine, lengths=lengths),
                jsimulate_trace(JSimParams(allocations=(8, 8, 6), **kw), trace, N_OBJ,
                                warmup=WARMUP, engine=engine, lengths=lengths),
            )
    for kw in (dict(variant="noshare"), dict(variant="pooled"),
               dict(variant="slru", physical_capacity=60)):
        a = simulate_trace(SimParams(allocations=(16, 24, 8), **kw), trace, N_OBJ,
                           warmup=WARMUP)
        b = jsimulate_trace(JSimParams(allocations=(16, 24, 8), **kw), trace, N_OBJ,
                            warmup=WARMUP)
        _assert_identical(a, b)
        assert a.engine == b.engine
    assert fastsim_c.available()
    assert "repro_torch" in str(fastsim_c._lib._name)
