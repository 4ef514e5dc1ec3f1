"""The port's working-set solver and admission against the reference.

Both solve in float32 (the reference's precision: jax x64 is off) on the
same numpy inputs, J = 3 proxies over N = 64 objects. Tolerance: rtol
1e-4 on t and h. The two loops take the same steps; what differs is only
the order of float32 sums, which moves t by a few ulps.
"""

import numpy as np
import pytest
import torch

from repro.core import admission as jadm
from repro.core import irm as jirm
from repro.core import workingset as jws
from repro_torch.core import admission, irm
from repro_torch.core import workingset as ws

J, N = 3, 64
ALPHAS = (0.75, 0.5, 1.0)


def _problem():
    lam = jirm.rate_matrix(N, ALPHAS)
    lengths = np.random.default_rng(0).integers(1, 5, N).astype(np.float64)
    return lam, lengths


def test_irm_copy_matches_reference():
    lam = irm.rate_matrix(N, ALPHAS)
    np.testing.assert_array_equal(lam, jirm.rate_matrix(N, ALPHAS))
    a, b = irm.sample_trace(lam, 500, seed=3), jirm.sample_trace(lam, 500, seed=3)
    np.testing.assert_array_equal(a.proxies, b.proxies)
    np.testing.assert_array_equal(a.objects, b.objects)


@pytest.mark.parametrize("attribution", ["L1", "Lstar", "L2", "full"])
def test_solve_workingset_matches_reference(attribution):
    lam, lengths = _problem()
    b = np.array([0.15, 0.1, 0.05]) * lengths.sum()
    want = jws.solve_workingset(lam, lengths, b, attribution)
    got = ws.solve_workingset(lam, lengths, b, attribution, device="cpu")
    np.testing.assert_allclose(got.t, want.t, rtol=1e-4)
    np.testing.assert_allclose(got.h, want.h, rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(got.hit_rate, want.hit_rate, rtol=1e-4)
    assert got.converged == want.converged
    # the same damped steps: the stopping test compares delta with tol near
    # float32's resolution, so the step count may differ by one
    assert abs(got.iterations - want.iterations) <= 1
    assert got.h.shape == (J, N) and got.L.shape == (J, N)


def test_solve_workingset_unshared_matches_reference():
    lam, lengths = _problem()
    b = np.array([30.0, 20.0, 10.0])
    want = jws.solve_workingset_unshared(lam, lengths, b)
    got = ws.solve_workingset_unshared(lam, lengths, b, device="cpu")
    np.testing.assert_allclose(got.t, want.t, rtol=1e-4)
    np.testing.assert_allclose(got.h, want.h, rtol=1e-4, atol=1e-7)
    assert got.iterations == want.iterations


@pytest.mark.parametrize("attribution", ["L1", "Lstar", "L2", "full"])
def test_virtual_footprint_matches_reference(attribution):
    lam, lengths = _problem()
    h = jws.solve_workingset_unshared(lam, lengths, np.array([30.0, 20.0, 10.0])).h
    want = jws.virtual_footprint(h, lengths, attribution)
    got = ws.virtual_footprint(h, lengths, attribution, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_solver_checks_inputs_like_reference():
    lam, lengths = _problem()
    with pytest.raises(ValueError, match="eq. \\(9\\)"):
        ws.solve_workingset(lam, lengths, np.full(J, lengths.sum()), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        ws.solve_workingset(lam, lengths[:-1], np.ones(J), device="cpu")


def test_virtual_allocations_and_controller_match_reference():
    lam, lengths = _problem()
    b_star = np.array([0.2, 0.2, 0.1]) * lengths.sum()
    want_b, want_sol = jadm.virtual_allocations(lam, lengths, b_star)
    got_b, got_sol = admission.virtual_allocations(lam, lengths, b_star, device="cpu")
    np.testing.assert_allclose(got_b, want_b, rtol=1e-4)
    np.testing.assert_allclose(got_sol.t, want_sol.t, rtol=1e-4)

    ctrls = [
        jadm.AdmissionController(lengths.sum() * 0.6, lengths),
        admission.AdmissionController(lengths.sum() * 0.6, lengths, device="cpu"),
    ]
    for c in ctrls:
        for i, name in enumerate("abc"):
            c.admit(name, b_star[i], lam=lam[i])
        c.refresh()
    np.testing.assert_allclose(
        list(ctrls[1].allocations().values()),
        list(ctrls[0].allocations().values()),
        rtol=1e-4,
    )
    assert [d.action for d in ctrls[1].log] == [d.action for d in ctrls[0].log]
    assert ctrls[1].overbooking_gain == pytest.approx(ctrls[0].overbooking_gain, rel=1e-4)


TABLE2_GRID = np.array([(8, 8, 8), (8, 8, 64), (8, 64, 8), (8, 64, 64),
                        (64, 8, 8), (64, 8, 64), (64, 64, 8), (64, 64, 64)], float)


@pytest.mark.parametrize("attribution", ["L1", "Lstar", "L2", "full"])
def test_solve_workingset_batch_matches_reference(attribution):
    """The 8 combos of Table II, scaled to this catalogue, in float32: t
    and h per combo within the single solve's tolerances, and each combo
    takes exactly the steps of the port's own single solve (converged
    combos are frozen while the others go on)."""
    lam, lengths = _problem()
    grid = TABLE2_GRID * lengths.sum() / 1000 * 0.3
    want = jws.solve_workingset_batch(lam, lengths, grid, attribution)
    got = ws.solve_workingset_batch(lam, lengths, grid, attribution, device="cpu")
    assert len(got) == len(grid)
    for b, g, w in zip(grid, got, want):
        np.testing.assert_allclose(g.t, w.t, rtol=1e-4)
        np.testing.assert_allclose(g.h, w.h, rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(g.hit_rate, w.hit_rate, rtol=1e-4)
        assert g.converged == w.converged
        single = ws.solve_workingset(lam, lengths, b, attribution, device="cpu")
        assert g.iterations == single.iterations
        np.testing.assert_array_equal(g.t, single.t)


@pytest.mark.parametrize("attribution", ["L1", "L2"])
def test_solve_workingset_batch_iterations_match_reference_in_float64(attribution):
    """In float64 on both sides (tol = 1e-7 is far above the rounding of
    delta), every combo takes exactly the reference's number of steps."""
    import jax

    lam, lengths = _problem()
    grid = TABLE2_GRID * lengths.sum() / 1000 * 0.3
    with jax.enable_x64(True):
        want = jws.solve_workingset_batch(lam, lengths, grid, attribution)
    got = ws.solve_workingset_batch(lam, lengths, grid, attribution, device="cpu",
                                    dtype=torch.float64)
    assert [g.iterations for g in got] == [w.iterations for w in want]
    assert [g.converged for g in got] == [w.converged for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.t, w.t, rtol=1e-12)


def test_working_set_solvers_need_a_card_unless_cpu_is_named(monkeypatch):
    lam, lengths = _problem()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ws.solve_workingset_batch(lam, lengths, TABLE2_GRID[:2] * 0.1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ws.solve_workingset(lam, lengths, TABLE2_GRID[0] * 0.1)
