"""The lane engine's runners and wrapper, and its CUDA kernel on the card.

This file imports no JAX and nothing of the reference package (the
card's machine has neither), so it runs there whole. Here on the CPU its
cases hold the runners' host side (the warmup split, pieces of a long
chunk, the id checks, the device rule), the route choice and the memory
rule of ``backend="auto"`` to the port's host C engine and to the
kernel's layout; the cases marked ``cuda`` run the kernel on each route
against its host build (the same step body, built by g++) and the host C
engine, and skip without a card:

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
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

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


H100_SHARED_LIMIT = 232_448   # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100


def _largest_shared_n(J, limit):
    """The largest N whose lane fits ``limit`` bytes on the shared route,
    counted from the layout: 5 J*N + 6 N words for the lane and the
    lengths, J + 3 for share and the walker's position, 2 x 3 x 256 for
    the request tiles."""
    return (limit // 4 - (J + 3) - 2 * 3 * 256) // (5 * J + 6)


@pytest.mark.parametrize("J,N", [(1, 1), (3, 1000), (3, 2693), (9, 500), (9, 1_000_000),
                                 (62, 7)])
def test_shared_bytes_match_the_kernel_layout(J, N):
    """The route choice in Python counts the bytes the kernel launches
    with (lane_engine.cuh shared_words, through the host build)."""
    from repro_torch.kernels import _build
    import ctypes

    fn = _build.load_host("lane_engine").repro_lane_engine_shared_words_host
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int] * 3
    for route, whole in (("shared", 1), ("device", 0)):
        assert le.shared_bytes(J, N, route) == 4 * fn(J, N, whole)


def test_route_follows_the_shared_memory_limit():
    lim = H100_SHARED_LIMIT
    assert le.pick_route(3, 1000, lim) == "shared"         # Table I: 90,168 B
    assert le.shared_bytes(3, 1000, "shared") == 90_168
    assert le.pick_route(9, 1_000_000, lim) == "device"    # Fig. 2
    for J in (1, 3, 9):
        n = _largest_shared_n(J, lim)
        assert le.shared_bytes(J, n, "shared") <= lim < le.shared_bytes(J, n + 1, "shared")
        assert le.pick_route(J, n, lim) == "shared"
        assert le.pick_route(J, n + 1, lim) == "device"
    assert _largest_shared_n(3, lim) == 2693
    with pytest.raises(ValueError, match="route"):
        le.shared_bytes(3, 10, "global")


def test_lane_state_bytes_count_what_a_runner_allocates():
    J, N, R = 3, 1000, 4
    st = le.init_state(J, N, R, [8, 8, 6], [8, 8, 6], torch.device("cpu"))
    state = sum(t.numel() * t.element_size() for t in st.values())
    consts = 4 * N + 4 * (J + 2)                  # lengths, share
    finish = 2 * 8 * J * N + J * N                # int64 res, tot and a bool mask
    assert le.lane_state_bytes(J, N, R) == state + consts + finish
    assert le.lane_state_bytes(9, 1_000_000, 1) > 200e6   # a Fig. 2 lane


def test_auto_keeps_the_lane_engine_only_where_the_lanes_fit(monkeypatch):
    """Broadcast lengths: nothing is allocated. J=3, N=4e8 is inside the
    int32 envelope, but three lanes take 96 GB: on an 80 GB card "auto"
    keeps the host engines. Fig. 2's 16 lanes of 200 MB still take the
    lane engine."""
    monkeypatch.setattr(fastsim, "device_free_bytes", lambda device: 80 * 10**9)
    lru = SimParams(allocations=(64, 8, 64), physical_capacity=136)
    N = 400_000_000
    ones = np.broadcast_to(np.ones(1, np.int64), (N,))
    assert fastsim.pick_engine("auto", lru, 10**6, N, ones, replicas=3, device="cuda") == "auto"
    assert fastsim.pick_engine("auto", lru, 10**6, N, ones, replicas=1, device="cuda") == "cuda"
    assert fastsim.pick_engine("cuda", lru, 10**6, N, ones, replicas=3, device="cuda") == "cuda"
    allocs = (1000, 1000, 1000, 2000, 2000, 2000, 7000, 7000, 7000)
    fig2 = SimParams(allocations=allocs, physical_capacity=sum(allocs))
    N2 = 1_000_000
    ones2 = np.broadcast_to(np.ones(1, np.int64), (N2,))
    assert fastsim.pick_engine("auto", fig2, 1_200_000, N2, ones2, replicas=16,
                               device="cuda") == "cuda"
    monkeypatch.setattr(fastsim, "device_free_bytes", lambda device: 10**9)
    assert fastsim.pick_engine("auto", fig2, 1_200_000, N2, ones2, replicas=16,
                               device="cuda") == "auto"


def test_scenario_ensemble_that_does_not_fit_runs_on_the_host(monkeypatch):
    """The ensemble path asks for all R lanes at once; when they do not
    fit, every replica runs on the host engines, and the Report says so."""
    sc = get_preset("table1", b=(64, 8, 64)).scaled(requests=1e-3)
    sc = dataclasses.replace(sc, estimator=dataclasses.replace(sc.estimator, replications=3))
    want = dataclasses.replace(sc, system=dataclasses.replace(sc.system, backend="c")).run()
    lane = le.lane_state_bytes(3, sc.workload.n_objects, 1)
    for free, backend in ((10**12, "cuda"), (int(2.5 * lane / fastsim.LANE_MEMORY_SHARE), "c")):
        monkeypatch.setattr(fastsim, "device_free_bytes", lambda device, f=free: f)
        got = sc.run(device="cpu")
        assert got.backend == backend and got.ensemble["batched"] is (backend == "cuda")
        assert got.same_estimates(want) and want.same_estimates(got)


def test_route_and_distance_arguments_are_checked():
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60)
    run = fastsim_cuda.CudaChunkRunner(p, N_OBJ, np.ones(N_OBJ, np.int64), 0, 0, 6,
                                       device="cpu")
    assert run.route is None              # the host build has no routes
    P = torch.zeros((1, 2), dtype=torch.int32)
    kw = dict(idx0=0, lengths=run.lengths, share=run.share, B=60, warmup=0, ripple_from=0,
              ghost=True)
    with pytest.raises(ValueError, match="route"):
        le.lane_engine(run.st, P, P, route="global", **kw)
    big = le.init_state(63, 1, 1, [1] * 63, [1] * 63, torch.device("cpu"))
    with pytest.raises(ValueError, match="at most 62 lists"):
        le.lane_engine(big, P, P, idx0=0, lengths=torch.ones(1, dtype=torch.int32),
                       share=torch.zeros(65, dtype=torch.int32), B=60, warmup=0,
                       ripple_from=0, ghost=True)


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


def _same_state(a, b):
    for k in a.st:
        assert torch.equal(a.st[k].cpu(), b.st[k].cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("route", le.ROUTES)
@pytest.mark.parametrize("kw", KWS)
def test_each_route_equals_host_build_and_c_engine(card, lam, monkeypatch, route, kw):
    """Ghosts on and off, ripple allocations; a warmup split inside the
    chunk and pieces of 1500 requests (tiles of 256 end mid-piece)."""
    monkeypatch.setattr(fastsim_cuda, "MAX_LAUNCH_REQUESTS", 1500)
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60, **kw)
    traces = [sample_trace(lam, N_REQ, seed=30 + r) for r in range(5)]
    le.lane_engine.launches = 0
    on_card = _runs(p, traces, N_OBJ, WARMUP, 6, card, route=route)
    assert on_card.route == route
    assert le.lane_engine.launches == 4       # [0, 700) | [700, 2200) [2200, 3700) [3700, 4000)
    host = _runs(p, traces, N_OBJ, WARMUP, 6, "cpu")
    _same_state(on_card, host)
    for r, t in enumerate(traces):
        c = simulate_trace(p, t, N_OBJ, warmup=WARMUP, engine="c")
        got = fastsim._assemble(on_card.finish(N_REQ)[r], 1.0, N_REQ, WARMUP, 3, N_OBJ, 6,
                                "cuda", False)
        _assert_identical(got, c)


@pytest.mark.cuda
@pytest.mark.parametrize("route", le.ROUTES)
def test_each_route_sweep_lanes_equal_host_build(card, lam, route):
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60)
    traces = [sample_trace(lam, N_REQ, seed=40 + r) for r in range(4)]
    b = np.array([[8, 8, 6], [6, 8, 8], [10, 4, 6], [5, 5, 5]])
    kw = dict(b_sweep=b, bhat_sweep=b + np.array([0, 1, 2, 0])[:, None])
    _same_state(_runs(p, traces, N_OBJ, WARMUP, 6, card, route=route, **kw),
                _runs(p, traces, N_OBJ, WARMUP, 6, "cpu", **kw))


@pytest.mark.cuda
def test_j9_lane_on_the_shared_route(card):
    """Nine lists of 500 objects fit one block's shared memory."""
    J, N, n = 9, 500, 6_000
    allocs = (20, 20, 20, 40, 40, 40, 60, 60, 60)
    lam9 = rate_matrix(N, tuple(0.5 + 0.5 * i for i in range(J)))
    traces = [sample_trace(lam9, n, seed=50 + r) for r in range(3)]
    p = SimParams(allocations=allocs, physical_capacity=sum(allocs) + 40)
    scale = _lcm_1_to(J)
    on_card = _runs(p, traces, N, n // 10, scale, card)
    assert on_card.route == "shared"
    _same_state(on_card, _runs(p, traces, N, n // 10, scale, "cpu"))
    for r, t in enumerate(traces):
        c = simulate_trace(p, t, N, warmup=n // 10, engine="c")
        got = fastsim._assemble(on_card.finish(n)[r], 1.0, n, n // 10, J, N, scale, "cuda",
                                False)
        _assert_identical(got, c)


@pytest.mark.cuda
def test_largest_shared_lane_and_the_next_one(card):
    """The largest N of J=3 that fits the card's shared memory takes the
    shared route, N + 1 the device-memory route; a shared route forced on
    N + 1 raises before anything launches."""
    n_max = _largest_shared_n(3, le.shared_limit(card))
    p = SimParams(allocations=(300, 200, 300), physical_capacity=900)
    for N, route in ((n_max, "shared"), (n_max + 1, "device")):
        lamN = rate_matrix(N, [0.8, 1.0, 0.6])
        traces = [sample_trace(lamN, 5_000, seed=60 + r) for r in range(2)]
        on_card = _runs(p, traces, N, 500, 6, card)
        assert on_card.route == route
        _same_state(on_card, _runs(p, traces, N, 500, 6, "cpu"))
    le.lane_engine.launches = 0
    with pytest.raises(ValueError, match="shared memory"):
        fastsim_cuda.BatchedCudaRunner(p, n_max + 1, np.ones(n_max + 1, np.int64), 500, 500, 6,
                                       2, device=card, route="shared")
    run = _runs(p, traces, n_max + 1, 500, 6, card)
    Pd = torch.zeros((2, 4), dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="shared memory"):
        le.lane_engine(run.st, Pd, Pd, idx0=run.idx, lengths=run.lengths, share=run.share,
                       B=900, warmup=500, ripple_from=500, ghost=True, route="shared")
    assert le.lane_engine.launches == 2       # the runner's two pieces, not the refused one


@pytest.mark.cuda
def test_more_lanes_than_the_card_holds_at_once(card):
    """300 Table I lanes on the shared route: two blocks an SM, so the
    grid runs in more than one wave."""
    N, n, R = 1000, 2_000, 300
    lam1 = rate_matrix(N, [0.75, 0.5, 1.0])
    traces = [sample_trace(lam1, n, seed=70 + r) for r in range(R)]
    p = SimParams(allocations=(64, 8, 64), physical_capacity=N)
    on_card = _runs(p, traces, N, 200, 6, card)
    assert on_card.route == "shared"
    _same_state(on_card, _runs(p, traces, N, 200, 6, "cpu"))


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
