"""Admission control (paper Section IV-C) in the port against the
reference: ``tests/test_admission.py``'s assertions, on both packages'
controllers and tenant-churn scenarios, on the same NumPy inputs.

The port's controller is a host copy over the torch working-set solver
(f32 on the CPU here); the reference's runs its JAX solver in f32. So
allocations agree to the solver tolerance of
``tests/test_torch_workingset.py`` (rtol 1e-4) and every decision, which
compares them with the capacity, is equal.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import AdmissionController as JController
from repro.core import virtual_allocations as jvirtual_allocations
from repro.core.irm import IRMTrace as JIRMTrace
from repro.core.irm import PopularityEstimator as JPopularity
from repro.scenario import AdmissionSpec as JAdmissionSpec
from repro.scenario import Estimator as JEstimator
from repro.scenario import Scenario as JScenario
from repro.scenario import System as JSystem
from repro.scenario import Workload as JWorkload
from repro_torch.core import AdmissionController, rate_matrix, virtual_allocations, virtual_footprint
from repro_torch.core.irm import IRMTrace, PopularityEstimator, sample_trace
from repro_torch.scenario import AdmissionSpec, Estimator, Scenario, System, Workload
from repro_torch.scenario.report import Report
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

N = 400
CPU = "cpu"
RTOL = 1e-4


def tenant_rates(J, base=0.9):
    return rate_matrix(N, [base + 0.02 * i for i in range(J)])


def _controllers(B):
    return AdmissionController(B, np.ones(N), device=CPU), JController(B, np.ones(N))


def _decisions(ctl):
    return [(d.action, d.name) for d in ctl.log]


def _same_decisions(port, ref):
    """The same decision log: equal actions, names, outcomes and reasons,
    and the headrooms and allocations within the solver tolerance."""
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        assert a.keys() == b.keys()
        for k, v in a.items():
            if isinstance(v, float):
                assert v == pytest.approx(b[k], rel=RTOL, abs=1e-3), (k, a, b)
            else:
                assert v == b[k], (k, a, b)


def _allocations_equal(port, ref):
    a, b = port.allocations(), ref.allocations()
    assert list(a) == list(b)
    np.testing.assert_allclose(list(a.values()), list(b.values()), rtol=RTOL)
    assert port.committed == pytest.approx(ref.committed, rel=RTOL)


# -- virtual_allocations (eq. (10)) ------------------------------------------

def test_virtual_allocations_equal_reference_and_identities():
    lam, lengths = tenant_rates(3), np.ones(N)
    b_star = np.array([30.0, 30.0, 30.0])
    b, sol = virtual_allocations(lam, lengths, b_star, device=CPU)
    jb, jsol = jvirtual_allocations(lam, lengths, b_star)
    np.testing.assert_allclose(b, jb, rtol=RTOL)
    np.testing.assert_allclose(sol.h, jsol.h, rtol=RTOL, atol=1e-7)
    assert np.all(b < b_star)                        # sharing strictly helps
    np.testing.assert_allclose(b, virtual_footprint(sol.h, lengths, device=CPU), rtol=1e-6)
    np.testing.assert_allclose(virtual_footprint(sol.h, lengths, attribution="full",
                                                 device=CPU), b_star, rtol=1e-3)


def test_virtual_allocations_monotone_and_single_tenant():
    lam, prev = tenant_rates(3), None
    for scale in (10.0, 20.0, 40.0, 80.0):
        b, _ = virtual_allocations(lam, np.ones(N), np.full(3, scale), device=CPU)
        jb, _ = jvirtual_allocations(lam, np.ones(N), np.full(3, scale))
        np.testing.assert_allclose(b, jb, rtol=RTOL)
        if prev is not None:
            assert np.all(b > prev)
        assert np.all(b <= scale + 1e-6)
        prev = b
    b, _ = virtual_allocations(tenant_rates(1), np.ones(N), np.array([25.0]), device=CPU)
    assert b[0] == pytest.approx(25.0, rel=1e-3)     # no sharing partner: b = b*


# -- AdmissionController edges ------------------------------------------------

def test_admit_boundary_double_admit_and_lifo_enforce():
    """eq. (13) is ``<=``; a double admit raises; a capacity shock
    evicts the latest admission first. The same log in both packages."""
    ctls = _controllers(100.0)
    for ctl in ctls:
        assert ctl.admit("a", 60.0).admitted
        d = ctl.admit("b", 40.0)                     # headroom exactly 40
        assert d.admitted and d.headroom_before == pytest.approx(40.0)
        d = ctl.admit("c", 1e-6)
        assert not d.admitted and d.action == "reject"
        with pytest.raises(ValueError, match="already admitted"):
            ctl.admit("a", 10.0)
    assert _decisions(ctls[0]) == _decisions(ctls[1])
    ctls = _controllers(100.0)
    for ctl in ctls:
        for nm, b in (("first", 40.0), ("second", 30.0), ("third", 30.0)):
            assert ctl.admit(nm, b).admitted
        ctl.B = 75.0                                 # committed 100 > 75
        assert ctl.enforce() == ["third"] and ctl.log[-1].action == "evict"
    assert _decisions(ctls[0]) == _decisions(ctls[1])


def test_departure_regrows_survivors_like_reference():
    """Footnote 1: a departure releases its allocation and the
    survivors' minimal allocations regrow; a lone survivor gets b*."""
    lam = tenant_rates(3)
    ctls = _controllers(120.0)
    for ctl in ctls:
        for i, nm in enumerate("abc"):
            assert ctl.admit(nm, 40.0).admitted
            ctl.observe(nm, lam[i])
        ctl.refresh()
    _allocations_equal(*ctls)
    shrunk = ctls[0].allocations()
    assert all(b < 40.0 for b in shrunk.values())
    for ctl in ctls:
        ctl.depart("a")
    _allocations_equal(*ctls)
    after = ctls[0].allocations()
    assert after["b"] > shrunk["b"] and after["c"] > shrunk["c"]
    for ctl in ctls:
        ctl.depart("b")
    assert ctls[0].allocations()["c"] == pytest.approx(40.0)
    assert _decisions(ctls[0]) == _decisions(ctls[1])


def test_refresh_frees_headroom_like_reference():
    lam = tenant_rates(4)
    ctls = _controllers(200.0)
    for ctl in ctls:
        for i, nm in enumerate("abcd"):
            assert ctl.admit(nm, 45.0).admitted
            ctl.observe(nm, lam[i])
    before = ctls[0].headroom()
    for ctl in ctls:
        ctl.refresh()
    _allocations_equal(*ctls)
    assert ctls[0].headroom() > before
    assert all(b <= 45.0 for b in ctls[0].allocations().values())
    assert ctls[0].overbooking_gain == pytest.approx(ctls[1].overbooking_gain, rel=RTOL)
    assert ctls[0].overbooking_gain > 1.0


# -- popularity estimates and eq. (13) under heavy decay ------------------------

def _observe(est, Trace, lam, n, seed0):
    for i in range(lam.shape[0]):
        t = sample_trace(lam[i:i + 1], n, seed=seed0 + i)
        est.observe_trace(Trace(t.proxies + i, t.objects))


def test_popularity_rates_equal_reference_under_any_decay_schedule():
    lam = tenant_rates(2)[:, :200]
    lam = lam / lam.sum(axis=1, keepdims=True)
    ests = [PopularityEstimator(3, 200), JPopularity(3, 200)]
    for est, Trace in zip(ests, (IRMTrace, JIRMTrace)):
        _observe(est, Trace, lam, 150, 0)
    for factor in (0.9,) * 60 + (0.5, 0.99, 0.1, 0.7) * 5:
        for est in ests:
            est.decay(factor)
        np.testing.assert_array_equal(ests[0].rates(), ests[1].rates())
        np.testing.assert_allclose(ests[0].rates().sum(axis=1)[:2], 1.0, rtol=1e-12)
        assert ests[0].rates().sum(axis=1)[2] == 0.0    # never observed: all zero
    np.testing.assert_array_equal(ests[0].rates(laplace=0.05), ests[1].rates(laplace=0.05))
    np.testing.assert_allclose(ests[0].rates(laplace=0.05)[2], np.full(200, 1 / 200),
                               rtol=1e-12)


def test_eq13_no_overadmission_with_heavily_decayed_estimates():
    lam = tenant_rates(3)
    ctls = _controllers(200.0)
    ests = [PopularityEstimator(3, N), JPopularity(3, N)]
    for est, Trace in zip(ests, (IRMTrace, JIRMTrace)):
        _observe(est, Trace, lam, 2000, 10)
        for _ in range(30):
            est.decay(0.05)
    assert ests[0].totals.max() < 1e-30
    for ctl, est in zip(ctls, ests):
        for i in range(3):
            assert ctl.admit(f"tenant{i}", 60.0).admitted
        rates = est.rates()
        for i in range(3):
            ctl.observe(f"tenant{i}", rates[i])
        ctl.refresh()
    _allocations_equal(*ctls)
    b_true, _ = virtual_allocations(lam, np.ones(N), np.full(3, 60.0), device=CPU)
    b_now = np.array(list(ctls[0].allocations().values()))
    np.testing.assert_allclose(b_now, np.minimum(b_true, 60.0), rtol=0.05)
    assert b_now.sum() > 100.0
    for ctl in ctls:
        d = ctl.admit("greedy", ctl.headroom() + 10.0)
        assert not d.admitted and "eq. (13)" in d.reason


# -- tenant churn: validation and the online episode -------------------------------

def test_tenant_events_validation_like_reference():
    for W, Sys, Spec in ((Workload, System, AdmissionSpec),
                         (JWorkload, JSystem, JAdmissionSpec)):
        ok = W(kind="tenant_churn", n_objects=N, alphas=(0.9, 1.0), round_requests=100,
               tenant_events=((0, "arrive", 0), (1, "arrive", 1), (2, "depart", 0)))
        assert ok.n_rounds == 3 and ok.events_by_round()[2] == [("depart", 0)]
        for kw, match in (
            (dict(alphas=(0.9,)), "round_requests"),
            (dict(tenant_events=((0, "depart", 0),), round_requests=100),
             "must depart in a later round"),
            (dict(tenant_events=((1, "arrive", 0), (1, "depart", 0)), round_requests=100),
             "must depart in a later round"),
            (dict(alphas=(0.9,), tenant_events=((0, "arrive", 0), (1, "arrive", 0)),
                  round_requests=100), "arrives twice"),
            (dict(alphas=(0.9,), tenant_events=((0, "arrive", 5),), round_requests=100),
             "out of range"),
        ):
            args = dict(kind="tenant_churn", n_objects=N, alphas=(0.9, 1.0))
            args.update(kw)
            with pytest.raises(ValueError, match=match):
                W(**args)
        wl = W(kind="tenant_churn", n_objects=N, alphas=(0.9, 1.0), round_requests=10)
        assert wl.events() == ((0, "arrive", 0), (0, "arrive", 1))
        with pytest.raises(ValueError, match="admission runner"):
            wl.sample(100, seed=0)
        with pytest.raises(ValueError, match="physical_capacity"):
            Sys(allocations=(20, 20), admission=Spec())
        with pytest.raises(ValueError, match="admission attribution"):
            Spec(attribution="full")
    sc = Scenario(name="x", workload=Workload(kind="tenant_churn", n_objects=N,
                                              alphas=(0.9, 1.0), round_requests=10),
                  system=System(allocations=(20, 20), physical_capacity=100), n_requests=1000)
    with pytest.raises(ValueError, match="admission"):
        sc.run(device=CPU)


def _episode(S, W, Sys, Spec, E, estimator="monte_carlo"):
    """tests/test_admission.py's episode at a tenth of its requests."""
    return S(name="episode",
             workload=W(kind="tenant_churn", n_objects=N, alphas=(0.9, 0.92, 0.94, 0.96),
                        tenant_events=((0, "arrive", 0), (1, "arrive", 1), (2, "arrive", 2),
                                       (3, "depart", 0), (4, "arrive", 3)),
                        round_requests=2_000),
             system=Sys(allocations=(40, 40, 40, 40), physical_capacity=110,
                        admission=Spec()),
             estimator=E(estimator), n_requests=6_000, seed=11)


@pytest.mark.parametrize("estimator", ["monte_carlo", "working_set"])
def test_admission_episode_equals_reference(estimator):
    """The online episode: the same decisions, the same admitted set, the
    same estimates (Monte-Carlo exactly, the working set within the solver
    tolerance), and the reference's own claims on the port's Report."""
    sc = _episode(Scenario, Workload, System, AdmissionSpec, Estimator, estimator)
    jsc = _episode(JScenario, JWorkload, JSystem, JAdmissionSpec, JEstimator, estimator)
    assert sc.to_dict() == jsc.to_dict() and Scenario.from_json(sc.to_json()) == sc
    rep, ref = sc.run(device=CPU), jsc.run()
    adm, jadm = rep.extras["admission"], ref.extras["admission"]
    _same_decisions(adm["decisions"], jadm["decisions"])
    assert adm["active_tenants"] == jadm["active_tenants"]
    np.testing.assert_allclose(list(adm["b_virtual"].values()),
                               list(jadm["b_virtual"].values()), rtol=RTOL)
    if estimator == "monte_carlo":
        back = Report.from_dict(ref.to_dict())
        assert back.same_estimates(rep) and rep.same_estimates(back)
    else:
        assert rep.converged
        np.testing.assert_allclose(rep.hit_prob, ref.hit_prob, rtol=RTOL, atol=5e-5)
    n_active = len(adm["active_tenants"])
    assert adm["overbooked"] and adm["overbooking_gain"] > 1.0
    assert n_active >= 3 > int(adm["capacity"]) // 40
    assert rep.hit_prob.shape == (n_active, N)
    actions = [d["action"] for d in adm["decisions"]]
    assert "admit" in actions and "depart" in actions
    rerun = dataclasses.replace(sc).run(device=CPU)
    assert rerun.same_estimates(rep)
