"""The lane engine's runners and wrapper, and its CUDA kernel on the card.

This file imports no JAX and nothing of the reference package (the
card's machine has neither), so it runs there whole. Here on the CPU its
cases hold the runners' host side (the warmup split, pieces of a long
chunk, the id checks, the device rule) to the port's host C engine; the
cases marked ``cuda`` run the kernel against its host build (the same
step body, built by g++) and the host C engine, and skip without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lane_engine.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import fastsim, fastsim_cuda
from repro_torch.core.fastsim import SimParams, simulate_chunks, simulate_trace
from repro_torch.core.irm import rate_matrix, sample_trace, sample_trace_chunks
from repro_torch.core.shared_lru import _lcm_1_to
from repro_torch.kernels import lane_engine as le
from repro_torch.scenario import get_preset

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


def _assert_identical(a, b):
    assert np.array_equal(a.dense_occupancy(), b.dense_occupancy())
    assert np.array_equal(a.final_vlen, b.final_vlen)
    assert np.array_equal(a.evictions_per_set, b.evictions_per_set)
    assert np.array_equal(a.hits_by_proxy, b.hits_by_proxy)
    assert np.array_equal(a.reqs_by_proxy, b.reqs_by_proxy)
    assert (a.n_hit_list, a.n_hit_cache, a.n_miss) == (b.n_hit_list, b.n_hit_cache, b.n_miss)
    assert (a.n_sets_recorded, a.n_primary, a.n_ripple) == (
        b.n_sets_recorded, b.n_primary, b.n_ripple)


@pytest.mark.parametrize("chunk", [997, 4_000])
def test_warmup_inside_a_chunk_and_long_chunks_split(lam, trace, monkeypatch, chunk):
    """A chunk that holds the warmup boundary is split there, and a chunk
    longer than a launch's limit is fed in pieces; neither changes the
    result."""
    monkeypatch.setattr(fastsim_cuda, "MAX_LAUNCH_REQUESTS", 613)
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60)
    got = simulate_chunks(p, sample_trace_chunks(lam, N_REQ, chunk_size=chunk, seed=3), N_OBJ,
                          N_REQ, warmup=WARMUP, engine="cuda", device="cpu", sparse=False)
    want = simulate_trace(p, trace, N_OBJ, warmup=WARMUP, engine="c")
    _assert_identical(got, want)


def test_ids_are_checked_before_the_kernel():
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60)
    run = fastsim_cuda.CudaChunkRunner(p, N_OBJ, np.ones(N_OBJ, np.int64), 0, 0, 6,
                                       device="cpu")
    with pytest.raises(ValueError, match="object ids"):
        run.feed(np.zeros(3, np.int32), np.array([0, N_OBJ, 1]))
    with pytest.raises(ValueError, match="proxy ids"):
        run.feed(np.array([0, 3, 1]), np.zeros(3, np.int64))
    with pytest.raises(TypeError, match="int32"):
        le.lane_engine(run.st, torch.zeros((1, 2), dtype=torch.int64),
                       torch.zeros((1, 2), dtype=torch.int32), idx0=0, lengths=run.lengths,
                       share=run.share, B=60, warmup=0, ripple_from=0, ghost=True)
    with pytest.raises(ValueError, match="shape"):
        le.lane_engine(run.st, torch.zeros((2, 2), dtype=torch.int32),
                       torch.zeros((2, 2), dtype=torch.int32), idx0=0, lengths=run.lengths,
                       share=run.share, B=60, warmup=0, ripple_from=0, ghost=True)


def test_cuda_engine_needs_a_card_unless_cpu_is_named(trace, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_trace(p, trace, N_OBJ, engine="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fastsim_cuda.simulate_ensemble(p, [trace], N_OBJ)
    # "auto" runs the flat shared LRU on the lane engine: on the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_trace(p, trace, N_OBJ, engine="auto")
    assert simulate_trace(p, trace, N_OBJ, engine="auto", device="cpu").engine == "cuda"
    # host engines take no device
    assert simulate_trace(p, trace, N_OBJ, engine="c").engine == "c"


def test_auto_picks_the_lane_engine_only_where_it_applies():
    n, ones = N_REQ, np.ones(N_OBJ, np.int64)
    lru = SimParams(allocations=(8, 8, 6), physical_capacity=60)
    assert fastsim.pick_engine("auto", lru, n, N_OBJ, ones) == "cuda"
    for forced in ("c", "flat", "generic", "cuda"):
        assert fastsim.pick_engine(forced, lru, n, N_OBJ, ones) == forced
    host = [
        dataclasses.replace(lru, batch_interval=5),
        dataclasses.replace(lru, variant="slru"),
        dataclasses.replace(lru, variant="noshare"),
        dataclasses.replace(lru, variant="pooled"),
    ]
    for p in host:
        assert fastsim.pick_engine("auto", p, n, N_OBJ, ones) == "auto", p
    big = np.full(N_OBJ, 2**28, np.int64)          # outside the int32 envelope
    assert fastsim.pick_engine("auto", lru, n, N_OBJ, big) == "auto"


def test_host_build_launches_nothing(trace):
    """The plain version runs on the host and is not a launch."""
    le.lane_engine.launches = 0
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60)
    simulate_trace(p, trace, N_OBJ, engine="cuda", device="cpu")
    assert le.lane_engine.launches == 0


# -- the kernel on the card (skips without one) ---------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the lane engine's CUDA kernel runs only there")
    return torch.device("cuda")


def _runs(p, traces, N, warmup, scale, device, **kw):
    run = fastsim_cuda.BatchedCudaRunner(p, N, np.ones(N, np.int64), warmup, warmup, scale,
                                         len(traces), device=device, **kw)
    run.feed(np.stack([t.proxies for t in traces]), np.stack([t.objects for t in traces]))
    return run


@pytest.mark.cuda
@pytest.mark.parametrize("kw", KWS)
def test_kernel_equals_host_build_and_c_engine(card, lam, kw):
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60, **kw)
    traces = [sample_trace(lam, N_REQ, seed=10 + r) for r in range(6)]
    le.lane_engine.launches = 0
    on_card = _runs(p, traces, N_OBJ, WARMUP, 6, card)
    assert le.lane_engine.launches == 2       # the warmup split; the module load is no launch
    host = _runs(p, traces, N_OBJ, WARMUP, 6, "cpu")
    for k in on_card.st:
        assert torch.equal(on_card.st[k].cpu(), host.st[k]), k
    for r, t in enumerate(traces):
        c = simulate_trace(p, t, N_OBJ, warmup=WARMUP, engine="c")
        got = fastsim._assemble(on_card.finish(N_REQ)[r], 1.0, N_REQ, WARMUP, 3, N_OBJ, 6,
                                "cuda", False)
        _assert_identical(got, c)


@pytest.mark.cuda
def test_kernel_sweep_lanes_equal_host_build(card, lam):
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60)
    traces = [sample_trace(lam, N_REQ, seed=20 + r) for r in range(4)]
    b = np.array([[8, 8, 6], [6, 8, 8], [10, 4, 6], [5, 5, 5]])
    kw = dict(b_sweep=b, bhat_sweep=b + np.array([0, 1, 2, 0])[:, None])
    on_card = _runs(p, traces, N_OBJ, WARMUP, 6, card, **kw)
    host = _runs(p, traces, N_OBJ, WARMUP, 6, "cpu", **kw)
    for k in on_card.st:
        assert torch.equal(on_card.st[k].cpu(), host.st[k]), k


@pytest.mark.cuda
def test_kernel_at_fig2_width_equals_host_build_and_c(card):
    """Two lanes of the Fig. 2 system at its published widths (J=9,
    N=1e6, allocations 3 x 1000 + 3 x 2000 + 3 x 7000), 20,000 requests."""
    J, N, n = 9, 1_000_000, 20_000
    allocs = (1000, 1000, 1000, 2000, 2000, 2000, 7000, 7000, 7000)
    lam = rate_matrix(N, tuple(0.5 + 0.5 * i for i in range(J)))
    traces = [sample_trace(lam, n, seed=5 + r) for r in range(2)]
    p = SimParams(allocations=allocs, physical_capacity=sum(allocs))
    scale = _lcm_1_to(J)
    on_card = _runs(p, traces, N, n // 10, scale, card)
    host = _runs(p, traces, N, n // 10, scale, "cpu")
    for k in on_card.st:
        assert torch.equal(on_card.st[k].cpu(), host.st[k]), k
    for r, t in enumerate(traces):
        c = simulate_trace(p, t, N, warmup=n // 10, engine="c", sparse=True)
        got = fastsim._assemble(on_card.finish(n)[r], 1.0, n, n // 10, J, N, scale, "cuda",
                                True)
        _assert_identical(got, c)


@pytest.mark.cuda
def test_table1_scenario_on_the_card_equals_c(card):
    sc = get_preset("table1", b=(64, 8, 64)).scaled(requests=5e-3)
    sc = dataclasses.replace(sc, estimator=dataclasses.replace(sc.estimator, replications=4))
    off = dataclasses.replace(sc, system=dataclasses.replace(sc.system, backend="c"))
    want = off.run()
    for backend in ("cuda", "auto"):      # "auto" runs the lane engine on the card
        on = dataclasses.replace(sc, system=dataclasses.replace(sc.system, backend=backend))
        got = on.run(device=card)
        assert got.backend == "cuda" and got.ensemble["batched"] is True
        assert got.same_estimates(want) and want.same_estimates(got)
