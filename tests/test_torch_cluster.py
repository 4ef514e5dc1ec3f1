"""The port's fault-tolerant MCD-OS cluster (a host copy) against the
reference: ``tests/test_cluster.py``'s and ``tests/test_cluster_parallel.py``'s
assertions, diffed on the same NumPy traces.

Ring ownership, failover tables and fault schedules must be equal
element for element; ``simulate_cluster`` must give the reference's
aggregate result and telemetry bit for bit, sequential and on the fork
executor; the scenario layer the same Report. Traces are 10^4 requests,
a tenth of the reference tests'.
"""

import dataclasses
import json
import multiprocessing

import numpy as np
import pytest

from repro.core import cluster as jcluster
from repro.core.fastsim import SimParams as JSimParams
from repro.scenario import Estimator as JEstimator
from repro.scenario import Scenario as JScenario
from repro.scenario import System as JSystem
from repro.scenario import Workload as JWorkload
from repro_torch.core import consistent_route, rate_matrix, sample_trace
from repro_torch.core import cluster
from repro_torch.core.fastsim import SimParams, simulate_trace
from repro_torch.scenario import Estimator, Scenario, System, Workload
from repro_torch.scenario.report import Report

N_OBJ, N_REQ, WARMUP, CHUNK = 400, 10_000, 1_000, 997
fork = pytest.mark.skipif("fork" not in multiprocessing.get_all_start_methods(),
                          reason="needs the fork start method")


@pytest.fixture(scope="module")
def trace():
    return sample_trace(rate_matrix(N_OBJ, (0.7, 0.9, 1.1)), N_REQ, seed=17)


def _faults(mod, nodes):
    if nodes == 1:
        return mod.FaultSpec()
    return mod.FaultSpec(events=((0.35, "fail", 1), (0.55, "recover", 1), (0.7, "remove", 0),
                                 (0.85, "add", nodes)), retry_budget=1, warm_remapped=True)


def _dense(occ):
    """Either package's occupancy, dense (each has its own SparseOccupancy)."""
    return occ.densify() if hasattr(occ, "densify") else occ


def _same_result(a, b):
    assert np.array_equal(_dense(a.occupancy), _dense(b.occupancy))
    for k in ("evictions_per_set", "hits_by_proxy", "reqs_by_proxy", "final_vlen"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k
    for k in ("n_hit_list", "n_hit_cache", "n_miss", "n_ripple", "n_primary",
              "n_batch_evictions", "n_sets_recorded", "n_requests"):
        assert getattr(a, k) == getattr(b, k), k


def _pair_run(trace, nodes, *, faults=None, **kw):
    """simulate_cluster in both packages on the same trace."""
    out = []
    for mod, P in ((cluster, SimParams), (jcluster, JSimParams)):
        spec = faults(mod) if faults is not None else _faults(mod, nodes)
        out.append(mod.simulate_cluster(P(allocations=(20, 20, 20), physical_capacity=N_OBJ),
                                        trace, N_OBJ, nodes=nodes, faults=spec, warmup=WARMUP,
                                        **kw))
    return out


# -- ring, routing, failover tables, fault specs ------------------------------

def test_ring_owners_and_key_positions_equal_reference():
    pos = cluster.key_positions(np.arange(20_000))
    np.testing.assert_array_equal(pos, jcluster.key_positions(np.arange(20_000)))
    assert [cluster.key_position(k) for k in ("obj1", 7, "user/3")] == \
        [jcluster.key_position(k) for k in ("obj1", 7, "user/3")]
    for K, vnodes in ((3, 64), (8, 64), (5, 3)):
        ring, jring = cluster.HashRing(range(K), vnodes), jcluster.HashRing(range(K), vnodes)
        before = ring.owner_of(pos)
        np.testing.assert_array_equal(before, jring.owner_of(pos))
        shares = np.bincount(before, minlength=K) / len(pos)
        if vnodes == 64:                       # balance under 64 vnodes
            assert shares.max() * K < 1.8 and shares.min() * K > 0.4
        smaller = ring.without_node(K - 1)
        np.testing.assert_array_equal(smaller.owner_of(pos),
                                      jring.without_node(K - 1).owner_of(pos))
        moved = before != smaller.owner_of(pos)
        assert not np.any((before != K - 1) & moved)        # only the removed node's keys
        grown = ring.with_node(9)
        assert set(np.unique(grown.owner_of(pos)[before != grown.owner_of(pos)])) <= {9}
    for bad in (lambda: cluster.HashRing(range(3)).with_node(1),
                lambda: cluster.HashRing(range(3)).without_node(7),
                lambda: cluster.HashRing([5]).without_node(5), lambda: cluster.HashRing([])):
        with pytest.raises(ValueError):
            bad()


def test_consistent_route_balance_and_minimal_disruption():
    keys = [f"user/{i}/object" for i in range(3000)]
    before = [consistent_route(k, 8) for k in keys]
    after = [consistent_route(k, 7) for k in keys]
    moved = [b for b, a in zip(before, after) if a != b]
    assert all(b == 7 for b in moved) and 0.3 / 8 < len(moved) / len(keys) < 2.5 / 8
    counts = np.bincount(before, minlength=8)
    assert counts.max() / counts.mean() < 1.8 and counts.min() > 0


def test_failover_tables_equal_reference():
    """The segment walk, the per-slot walk and the reference's tables, on
    random rings, down sets and budgets, and the edge cases."""
    rng = np.random.default_rng(20260808)
    cases = [(cluster.default_ring(5), jcluster.default_ring(5), down)
             for down in (frozenset(), frozenset(range(5)), frozenset(range(5)) - {3},
                          frozenset({0}))]
    for _ in range(15):
        n, vnodes = int(rng.integers(1, 10)), int(rng.choice([1, 3, 16]))
        down = frozenset(int(x) for x in rng.choice(n, size=int(rng.integers(0, n + 1)),
                                                    replace=False))
        cases.append((cluster.HashRing(range(n), vnodes), jcluster.HashRing(range(n), vnodes),
                      down))
    for ring, jring, down in cases:
        for budget in (0, 1, 2, 4):
            got = cluster._failover_tables(ring, down, budget)
            for want in (cluster._failover_tables_walk(ring, down, budget),
                         jcluster._failover_tables(jring, down, budget)):
                np.testing.assert_array_equal(got[0], want[0])
                np.testing.assert_array_equal(got[1], want[1])
    target, retries = cluster._failover_tables(cluster.default_ring(6), frozenset({1, 4}), 1)
    owners = cluster.default_ring(6).owners
    live = ~np.isin(owners, [1, 4])
    assert np.array_equal(target[live], owners[live]) and not retries[live].any()
    assert np.all(retries[target == -1] == 2) and not np.isin(target[target != -1], [1, 4]).any()


def test_fault_spec_validation_round_trip_and_seeded_materialize():
    for bad in (dict(events=((1.5, "fail", 0),)), dict(events=((0.5, "explode", 0),)),
                dict(events=((0.5, "fail", -1),)), dict(retry_budget=-1), dict(vnodes=0)):
        for mod in (cluster, jcluster):
            with pytest.raises(ValueError):
                mod.FaultSpec(**bad)
    assert cluster.FaultSpec().is_empty and not cluster.FaultSpec(random_failures=1).is_empty
    kw = dict(events=((0.25, "fail", 1), (0.5, "recover", 1), (0.75, "add", 4)),
              random_failures=2, mttr_frac=0.1, retry_budget=3, warm_remapped=True)
    spec, jspec = cluster.FaultSpec(**kw), jcluster.FaultSpec(**kw)
    wire = json.loads(json.dumps(spec.to_dict()))
    assert wire == jspec.to_dict() and cluster.FaultSpec.from_dict(wire) == spec
    for seed in (9, 10, 21):
        got = [e.to_dict() for e in spec.materialize(100_000, 4, seed=seed)]
        assert got == [e.to_dict() for e in jspec.materialize(100_000, 4, seed=seed)]
    got = [(e.idx, e.action, e.node) for e in
           cluster.FaultSpec(random_failures=2, mttr_frac=0.1).materialize(50_000, 4, seed=21)]
    assert got == [(7872, "fail", 1), (12872, "recover", 1), (30527, "fail", 2),
                   (35527, "recover", 2)]                    # the reference's pinned stream


# -- simulate_cluster, sequential and parallel ------------------------------------

@pytest.mark.parametrize("nodes", [1, 4])
def test_simulate_cluster_equals_reference(trace, nodes):
    (res, stats), (jres, jstats) = _pair_run(trace, nodes)
    _same_result(res, jres)
    assert stats == jstats
    if nodes == 1:                     # one node, no faults: the plain engine, bit for bit
        plain = simulate_trace(SimParams(allocations=(20, 20, 20), physical_capacity=N_OBJ),
                               trace, N_OBJ, warmup=WARMUP, engine="c")
        _same_result(res, plain)


@pytest.mark.parametrize("kw", [dict(chunk_size=CHUNK), dict(engine="flat"),
                                dict(fault_seed=21)], ids=["chunked", "flat", "random-faults"])
def test_simulate_cluster_options_equal_reference(trace, kw):
    faults = None
    if "fault_seed" in kw:
        faults = lambda mod: mod.FaultSpec(random_failures=2, retry_budget=1)
    (res, stats), (jres, jstats) = _pair_run(trace, 4, faults=faults, **kw)
    _same_result(res, jres)
    assert stats == jstats


@fork
def test_parallel_executor_equals_sequential_and_reference(trace):
    """Worker counts below, at and above K, a chunk size that cuts fault
    segments, and the reference's parallel run: all bit-identical."""
    seq, ref = _pair_run(trace, 4)
    for kw in (dict(workers=1), dict(workers=3), dict(workers=8, chunk_size=CHUNK)):
        (res, stats), (jres, jstats) = _pair_run(trace, 4, executor="parallel", **kw)
        _same_result(res, seq[0])
        _same_result(jres, ref[0])
        assert stats == seq[1] == jstats


def test_degraded_mode_and_starved_node_like_reference():
    """Every node down with no retries: degraded misses, not errors; a
    node failed from early on reports hit_rate None, not NaN."""
    lam = rate_matrix(400, (0.8, 1.0))
    tr = sample_trace(lam, 10_000, seed=3)
    for spec_kw, check in (
        (dict(events=((0.5, "fail", 0), (0.5, "fail", 1)), retry_budget=0),
         lambda res, st: st["retries"]["degraded_requests"] > 0
         and int(res.reqs_by_proxy.sum()) == 10_000 - 1_000),
        (dict(events=((0.1, "fail", 1),), retry_budget=2),
         lambda res, st: [p for p in st["per_node"] if p["node"] == 1][0]["hit_rate"] is None),
    ):
        got = []
        for mod, P in ((cluster, SimParams), (jcluster, JSimParams)):
            got.append(mod.simulate_cluster(P(allocations=(16, 16), physical_capacity=400),
                                            tr, 400, nodes=2, faults=mod.FaultSpec(**spec_kw),
                                            warmup=1_000))
        _same_result(got[0][0], got[1][0])
        assert got[0][1] == got[1][1] and check(*got[0])
        assert json.loads(json.dumps(got[0][1])) == got[0][1]


def test_cluster_executor_validation(trace):
    for kw, match in ((dict(executor="threads"), "executor"),
                      (dict(executor="parallel", workers=0), "workers"),
                      (dict(chunk_size=0), "chunk_size")):
        with pytest.raises(ValueError, match=match):
            cluster.simulate_cluster(SimParams(allocations=(20, 20, 20),
                                               physical_capacity=N_OBJ),
                                     trace, N_OBJ, nodes=2, faults=cluster.FaultSpec(),
                                     warmup=WARMUP, **kw)


# -- the scenario layer ----------------------------------------------------------

def _scenario(S, Sys, W, E, F, **sys_kw):
    base = dict(allocations=(24, 24, 24), physical_capacity=500, nodes=3)
    base.update(sys_kw)
    if F is not None:
        base["faults"] = F
    return S(name="cluster_t", workload=W(n_objects=500, alphas=(0.7, 0.9, 1.1)),
             system=Sys(**base), estimator=E("monte_carlo"), n_requests=12_000,
             warmup=1_200, seed=13)


def _scenarios(faults=None, **sys_kw):
    return (_scenario(Scenario, System, Workload, Estimator,
                      None if faults is None else faults(cluster), **sys_kw),
            _scenario(JScenario, JSystem, JWorkload, JEstimator,
                      None if faults is None else faults(jcluster), **sys_kw))


@pytest.mark.parametrize("case", ["fail-recover", "remove-random", "one-node"])
def test_cluster_scenario_equals_reference(case):
    """Failover, a reshard with random failures (ghost warming on), and
    one node with an empty spec: the same Report and ClusterStats as the
    reference; JSON round trips; the reference's schema and claims."""
    faults, kw = {
        "fail-recover": (lambda m: m.FaultSpec(events=((0.4, "fail", 1), (0.7, "recover", 1))),
                         {}),
        "remove-random": (lambda m: m.FaultSpec(events=((0.5, "remove", 2),), random_failures=1,
                                                retry_budget=1, warm_remapped=True), {}),
        "one-node": (lambda m: m.FaultSpec(), dict(nodes=1)),
    }[case]
    sc, jsc = _scenarios(faults, **kw)
    assert Scenario.from_json(sc.to_json()) == sc and sc.to_dict() == jsc.to_dict()
    rep, ref = sc.run(), jsc.run()
    back = Report.from_dict(json.loads(json.dumps(ref.to_dict())))
    assert back.same_estimates(rep) and rep.same_estimates(back)
    cl = rep.extras["cluster"]
    assert cl == ref.extras["cluster"] and json.loads(json.dumps(cl)) == cl
    assert set(cl) == {f.name for f in dataclasses.fields(cluster.ClusterStats)}
    assert cluster.ClusterStats.from_dict(cl).to_dict() == cl
    if case == "one-node":             # the cluster layer adds no noise
        plain = dataclasses.replace(sc, system=dataclasses.replace(sc.system, faults=None))
        plain = plain.run(device="cpu")          # not a cluster: "auto" takes the lane engine
        assert "cluster" not in plain.extras and plain.same_estimates(rep)
    if case == "fail-recover":
        pre, during = cl["phases"]["pre_fault"], cl["phases"]["during"]
        assert pre["hit_rate"] - during["hit_rate"] > 0.01    # the outage is visible
        assert cl["retries"]["total"] > 0
    if case == "remove-random":
        (remap,) = cl["remap"]
        assert remap["action"] == "remove" and 0.05 < remap["fraction"] < 0.75
        assert cl["warm_remapped"]["enabled"]


@fork
def test_scenario_parallel_equals_sequential_and_reference():
    faults = lambda m: m.FaultSpec(events=((0.4, "fail", 1), (0.6, "recover", 1)))
    sc, jsc = _scenarios(faults, nodes=4, executor="parallel", workers=2)
    assert Scenario.from_json(sc.to_json()) == sc and sc.system.workers == 2
    par = sc.run()
    seq = dataclasses.replace(sc, system=dataclasses.replace(sc.system, executor="sequential",
                                                             workers=None)).run()
    ref = jsc.run()
    assert par.same_estimates(seq) and par.extras["cluster"] == seq.extras["cluster"]
    assert par.extras["cluster"] == ref.extras["cluster"]
    assert Report.from_dict(ref.to_dict()).same_estimates(par)


def test_system_cluster_validation_like_reference():
    for Sys in (System, JSystem):
        for kw in (dict(nodes=0), dict(variant="slru", nodes=2), dict(nodes=2, executor="threads"),
                   dict(nodes=2, workers=2), dict(nodes=2, executor="parallel", workers=0)):
            with pytest.raises(ValueError):
                Sys(allocations=(8,), **kw)
        assert not Sys(allocations=(8,)).is_cluster and Sys(allocations=(8,), nodes=2).is_cluster
        assert Sys(allocations=(8,), executor="parallel").is_cluster
    with pytest.raises(ValueError):
        System(allocations=(8,), backend="cuda", nodes=2)
    with pytest.raises(ValueError):
        dataclasses.replace(_scenarios()[0], estimator=Estimator("working_set")).run(device="cpu")
