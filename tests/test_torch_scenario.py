"""The port's estimator loop, ``Scenario.run() -> Report``, against the
reference package, and its host copies.

The paper's presets, scaled down (request counts and catalogue), run on
the lane engine (``backend="cuda"``, its host build with
``device="cpu"``), on the port's C loop and on "auto" (S-LRU on the
generic engine, the cluster on the C loop); each Report passes
``same_estimates`` against the reference's Report of the same scenario,
through ``Report.from_dict`` in both directions. The working-set preset
runs the port's torch solver. The host copies (``slru``, ``baselines``,
``metrics``, ``cluster``, ``serving/trace``, ``serving/costs``) are held
to the reference on the same inputs, with the assertions of
``tests/test_shared_lru.py`` and ``tests/test_props_cache.py``. The
Scenario path on the card is tested by ``tests/test_torch_lane_engine.py``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.cacheblocks import layout_for as jlayout_for
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.core import GetResult as JGetResult
from repro.core import NotSharedSystem as JNotShared
from repro.core import PooledLRU as JPooled
from repro.core import SegmentedSharedLRUCache as JSLRU
from repro.core import SharedLRUCache as JShared
from repro.core import SimpleLRU as JSimple
from repro.core.cluster import FaultSpec as JFaultSpec
from repro.core.metrics import HitRecorder as JHitRecorder
from repro.core.metrics import OccupancyRecorder as JOccupancy
from repro.core.metrics import RippleStats as JRippleStats
from repro.scenario import get_preset as jget_preset
from repro.scenario.report import Report as JReport
from repro.serving import costs as jcosts
from repro.serving import trace as jtrace
from repro_torch.cacheblocks import layout_for
from repro_torch.configs import SHAPES, get_config
from repro_torch.core import (
    GetResult,
    NotSharedSystem,
    PooledLRU,
    SegmentedSharedLRUCache,
    SharedLRUCache,
    SimpleLRU,
)
from repro_torch.core.cluster import FaultSpec
from repro_torch.core.metrics import HitRecorder, OccupancyRecorder, RippleStats
from repro_torch.scenario import get_preset
from repro_torch.scenario.report import Report
from repro_torch.serving import costs, trace
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

CPU = "cpu"
# preset, its arguments, scale (requests, catalogue), the engine "auto"
# picks for it on the CPU: the lane engine's host build ("cuda") for the
# flat-LRU Monte-Carlo presets, the generic engine for S-LRU, the C loop
# for a cluster. A preset runs on "auto" and on each engine that accepts
# it, the reference on its C loop (generic for S-LRU, which the C loop
# refuses); every engine gives the same estimates.
PRESETS = [
    ("table1", dict(b=(8, 64, 8)), (5e-4, 1.0), "cuda"),
    ("fig2_ripple", {}, (2e-3, 1e-2), "cuda"),
    ("rre", {}, (6e-3, 1e-2), "cuda"),
    ("slru", {}, (1e-3, 1.0), "generic"),
    ("j2_bounds", {}, (1e-3, 1.0), "cuda"),
    ("shot_noise", {}, (1e-3, 1.0), "cuda"),
    ("admission_overbooking", {}, (2e-3, 1.0), "cuda"),
    ("cluster_failover", {}, (2e-3, 1e-2), "c"),
    ("quickstart", {}, (5e-3, 1.0), "cuda"),
]
_ENGINES = {"cuda": ("cuda", "c", "auto"), "c": ("c", "auto"), "generic": ("generic", "auto")}
PRESET_RUNS = [pytest.param(name, kw, scale, backend, auto, id=f"{name}-{backend}")
               for name, kw, scale, auto in PRESETS for backend in _ENGINES[auto]]


def _pair(name, kw, scale, backend, replications=1, ref_backend="c"):
    """The same scaled preset in both packages; the reference on
    ``ref_backend`` (every engine gives the same estimates)."""
    out = []
    for get in (get_preset, jget_preset):
        sc = get(name, **kw).scaled(*scale)
        sys_kw = dict(backend=backend if get is get_preset else ref_backend)
        est = dataclasses.replace(sc.estimator, replications=replications)
        out.append(dataclasses.replace(sc, system=dataclasses.replace(sc.system, **sys_kw),
                                       estimator=est))
    return out


def _same_both_ways(port: Report, ref: JReport) -> None:
    as_ref = JReport.from_dict(json.loads(json.dumps(port.to_dict())))
    as_port = Report.from_dict(json.loads(json.dumps(ref.to_dict())))
    assert as_ref.same_estimates(ref) and ref.same_estimates(as_ref)
    assert as_port.same_estimates(port) and port.same_estimates(as_port)


@pytest.mark.parametrize("name,kw,scale,backend,auto", PRESET_RUNS)
def test_preset_report_equals_reference(name, kw, scale, backend, auto):
    """"auto" runs the flat-LRU presets on the lane engine."""
    port_sc, ref_sc = _pair(name, kw, scale, backend,
                            ref_backend="generic" if auto == "generic" else "c")
    assert port_sc.to_dict()["workload"] == ref_sc.to_dict()["workload"]
    port, ref = port_sc.run(device=CPU), ref_sc.run()
    ran = auto if backend == "auto" else backend
    assert port.backend == ran and port.n_requests == ref.n_requests > 0
    _same_both_ways(port, ref)
    assert port.ripple["n_sets_recorded"] > 0


def test_table1_ensemble_on_cuda_equals_reference():
    port_sc, ref_sc = _pair("table1", dict(b=(8, 8, 64)), (4e-4, 1.0), "cuda", 4)
    port, ref = port_sc.run(device=CPU), ref_sc.run()
    assert port.ensemble["batched"] is True and port.replications == 4
    _same_both_ways(port, ref)


def test_table3_noshare_on_host_engines_and_not_on_cuda():
    for backend in ("c", "flat"):
        port_sc, ref_sc = _pair("table3_noshare", {}, (5e-4, 1.0), backend)
        _same_both_ways(port_sc.run(), ref_sc.run())
    port_sc, _ = _pair("table3_noshare", {}, (5e-4, 1.0), "cuda")
    with pytest.raises(ValueError, match="does not support variant"):
        port_sc.run(device=CPU)           # as the reference's engine="xla" refuses it


def test_table2_ws_matches_reference():
    """Tolerances of tests/test_workingset.py (h atol 5e-5) and of the
    port's solver tests (t rtol 1e-4)."""
    for b in ((8, 8, 8), (64, 8, 64)):
        port = get_preset("table2_ws", b=b).run(device=CPU)
        ref = jget_preset("table2_ws", b=b).run()
        assert port.backend == "torch-ws" and ref.backend == "jax-ws"
        np.testing.assert_allclose(port.hit_prob, ref.hit_prob, atol=5e-5)
        np.testing.assert_allclose(port.hit_rate, ref.hit_rate, rtol=1e-4)
        np.testing.assert_allclose(port.extras["characteristic_times"],
                                   ref.extras["characteristic_times"], rtol=1e-4)
        assert port.converged and ref.converged
        back = JReport.from_dict(json.loads(json.dumps(port.to_dict())))
        assert back.estimator == "working_set"


def test_device_none_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_preset("table2_ws").run()
    for backend in ("cuda", "auto"):
        port_sc, _ = _pair("table1", {}, (5e-4, 1.0), backend)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_sc.run()
    # a forced host engine, and "auto" where the lane engine does not
    # apply, take no device
    host_sc, _ = _pair("table1", {}, (5e-4, 1.0), "c")
    assert host_sc.run().backend == "c"
    noshare_sc, _ = _pair("table3_noshare", {}, (5e-4, 1.0), "auto")
    assert noshare_sc.run().backend in ("c", "flat")


def test_cluster_copy_equals_reference():
    """nodes=2 with a failure and recovery, sequential and parallel
    (forked workers on the host engines)."""
    out = []
    for get, Spec in ((get_preset, FaultSpec), (jget_preset, JFaultSpec)):
        sc = get("fig2_ripple").scaled(2e-3, 1e-2)
        out.append(dataclasses.replace(sc, system=dataclasses.replace(
            sc.system, nodes=2, faults=Spec(events=((0.4, "fail", 1), (0.6, "recover", 1))))))
    port, ref = out[0].run(), out[1].run()
    _same_both_ways(port, ref)
    assert port.extras["cluster"] == ref.extras["cluster"]
    par = dataclasses.replace(out[0], system=dataclasses.replace(
        out[0].system, executor="parallel", workers=2)).run()
    assert par.same_estimates(port)


def test_serving_trace_and_costs_copies_equal_reference():
    layouts = [M.ServingLayout(n_tenants=2, n_prompts=6, shared_frac=0.5, prefix_blocks=3,
                               suffix_blocks=1, suffix_choices=2) for M in (trace, jtrace)]
    for a, b in zip(trace.compile_trace(layouts[0], (0.8, 1.1), None, 3_000, 5),
                    jtrace.compile_trace(layouts[1], (0.8, 1.1), None, 3_000, 5)):
        assert np.array_equal(a, b)
    np.testing.assert_array_equal(trace.serving_rates(layouts[0], (0.8, 1.1), None),
                                  jtrace.serving_rates(layouts[1], (0.8, 1.1), None))
    for name in ("qwen3-1.7b", "deepseek-7b"):
        cfg, jcfg = get_config(name), jget_config(name)
        bpt = layout_for(cfg).bytes_per_token
        assert bpt == jlayout_for(jcfg).bytes_per_token
        assert dataclasses.asdict(costs.ServingCostModel.for_arch(cfg, bpt)) == \
            dataclasses.asdict(jcosts.ServingCostModel.for_arch(jcfg, bpt))
        for shape in ("prefill_32k", "decode_32k"):
            assert dataclasses.asdict(costs.cell_costs(cfg, SHAPES[shape])) == \
                dataclasses.asdict(jcosts.cell_costs(jcfg, JSHAPES[shape]))


def test_serving_preset_equals_reference():
    """Admission-gated onboarding (working-set solves on the device),
    the compiled block trace on the lane engine, and the serving report."""
    port_sc, ref_sc = _pair("serving_multitenant", {}, (3e-4, 0.05), "cuda")
    port, ref = port_sc.run(device=CPU), ref_sc.run()
    _same_both_ways(port, ref)
    p, r = port.extras["serving"], ref.extras["serving"]
    assert p["admission"]["active_tenants"] == r["admission"]["active_tenants"]
    assert p["prefix_hit_token_ratio"] == r["prefix_hit_token_ratio"]


# -- host copies of the executable spec ----------------------------------

def _ops(rng, J, n_obj, n_ops):
    return [(int(rng.integers(0, J)), int(rng.integers(0, n_obj))) for _ in range(n_ops)]


@pytest.mark.parametrize("seed", range(4))
def test_shared_and_segmented_caches_equal_reference(seed):
    """Random get_autofetch streams: the same results, evictions, virtual
    lengths and list contents, and the invariants of
    tests/test_props_cache.py on the port's caches."""
    rng = np.random.default_rng(seed)
    J = int(rng.integers(2, 5))
    lens = rng.integers(1, 4, size=30)
    allocs = rng.integers(2, 10, size=J).tolist()
    B = sum(allocs) + 10
    caches = [
        (SharedLRUCache(allocs, B), JShared(allocs, B)),
        (SegmentedSharedLRUCache(allocs, B), JSLRU(allocs, B)),
    ]
    unshared = NotSharedSystem(allocs)
    for step, (i, k) in enumerate(_ops(rng, J, 30, 300)):
        for c, jc in caches:
            a, b = c.get_autofetch(i, k, int(lens[k])), jc.get_autofetch(i, k, int(lens[k]))
            assert a.result.name == b.result.name
            assert [(e.proxy, e.key, e.ripple, e.physical) for e in a.evictions] == \
                [(e.proxy, e.key, e.ripple, e.physical) for e in b.evictions]
            assert c.vlen_scaled == jc.vlen_scaled
            if step % 7 == 0:
                c.check_invariants()
        unshared.get_autofetch(i, k, int(lens[k]))
        for j in range(J):
            assert caches[0][0].vlen_scaled[j] <= caches[0][0].b_scaled[j]
    shared = caches[0][0]
    for j in range(J):
        assert shared.list_keys(j) == caches[0][1].list_keys(j)
        # Prop. 3.1's coupling: the not-shared contents are a subset
        assert set(unshared.list_keys(j)) <= set(shared.list_keys(j))
        assert caches[1][0].list_keys(j) == caches[1][1].list_keys(j)
    shared.check_invariants()


def test_shared_lru_unit_semantics():
    """tests/test_shared_lru.py on the port's copy."""
    c = SharedLRUCache([4, 4], physical_capacity=16)
    assert c.get(0, "a").result is GetResult.MISS
    c.set(0, "a", 1)
    assert c.get(0, "a").result is GetResult.HIT_LIST
    assert c.get(1, "a").result is GetResult.HIT_CACHE
    assert c.share_of("a") == pytest.approx(0.5)
    c = SharedLRUCache([3, 3, 3], physical_capacity=32)
    c.set(0, "obj2", 3)
    c.get_autofetch(1, "obj2", 3)
    c.get_autofetch(2, "obj2", 3)
    c.set(1, "obj3", 2)
    c.get_autofetch(2, "obj3", 2)
    c.set(2, "obj5", 1)
    c.set(0, "obj4", 2)
    st = c.set(0, "obj1", 2)
    assert st.n_evictions >= 3 and st.n_ripple >= 1      # Fig. 1's ripple
    c = SharedLRUCache([2], physical_capacity=4, ghost_retention=True)
    c.set(0, "a", 2)
    c.set(0, "b", 2)
    assert c.in_physical("a") and not c.in_list(0, "a")   # a ghost
    c.set(0, "c", 2)
    assert not c.in_physical("a")                         # evicted for room
    base = SharedLRUCache([2, 2], physical_capacity=16)
    rre = SharedLRUCache([2, 2], physical_capacity=16, ripple_allocations=[3, 3])
    for x in (base, rre):
        x.set(0, "s", 2)
        x.get_autofetch(1, "s", 2)
        x.set(1, "t", 1)
        x.set(0, "u", 2)
    assert base.vlen(1) <= 2 and rre.vlen(1) == pytest.approx(3.0)
    assert rre.enforce() and rre.vlen(1) <= 2
    with pytest.raises(ValueError):
        SharedLRUCache([4, 4], physical_capacity=6)
    with pytest.raises(ValueError):
        SharedLRUCache([4], ripple_allocations=[2])


def test_baselines_and_recorders_equal_reference():
    rng = np.random.default_rng(7)
    ops = _ops(rng, 3, 20, 400)
    lens = rng.integers(1, 3, size=20)
    port = (NotSharedSystem([4, 5, 3]), PooledLRU(12), SimpleLRU(6))
    ref = (JNotShared([4, 5, 3]), JPooled(12), JSimple(6))
    rec = [(HitRecorder(3, 20), RippleStats(), OccupancyRecorder(3, 20)),
           (JHitRecorder(3, 20), JRippleStats(), JOccupancy(3, 20))]
    caches = [SharedLRUCache([4, 5, 3], 15), JShared([4, 5, 3], 15)]
    for c, (_, _, occ) in zip(caches, rec):
        occ.attach_to(c)
    for step, (i, k) in enumerate(ops):
        for (ns, pl, lru), (jns, jpl, jlru) in ((port, ref),):
            assert ns.get_autofetch(i, k, int(lens[k])).result.name == \
                jns.get_autofetch(i, k, int(lens[k])).result.name
            assert pl.get_autofetch(i, k, int(lens[k])).result.name == \
                jpl.get_autofetch(i, k, int(lens[k])).result.name
            assert lru.get_autofetch(k, int(lens[k])).result.name == \
                jlru.get_autofetch(k, int(lens[k])).result.name
        for c, (hits, ripple, occ) in zip(caches, rec):
            occ.now = step
            st = c.get_autofetch(i, k, int(lens[k]))
            hits.record(i, k, st.result)
            ripple.record(st)
    for (hits, ripple, occ), _ in zip(rec, caches):
        occ.now = len(ops)
        occ.finalize()
    np.testing.assert_array_equal(rec[0][0].hit_prob_matrix(), rec[1][0].hit_prob_matrix())
    assert rec[0][1].histogram() == rec[1][1].histogram()
    np.testing.assert_array_equal(rec[0][2].occupancy(), rec[1][2].occupancy())
    assert [ns.list_keys(j) for j in range(3) for ns in (port[0],)] == \
        [ns.list_keys(j) for j in range(3) for ns in (ref[0],)]
    assert JGetResult.MISS.name == GetResult.MISS.name
