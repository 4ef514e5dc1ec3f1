r"""Working-set approximation for shared-object caches (paper Section IV).

Solves the J-dimensional fixed point (paper eq. (8))

    b_i = sum_k (1 - e^{-lambda_{i,k} t_i}) * L_{i,k},   i = 1..J

for the characteristic ("mean eviction") times ``t_i``, where ``L_{i,k}``
is the mean length of object ``k`` attributed to LRU-list ``i``:

* ``L1``   (paper eq. (5)):  l_k * E[ 1 / (1 + sum_{j!=i} Z_{j,k}) ] with
  independent Bernoulli(h_{j,k}) occupancies Z. Computed **exactly**: for
  S = sum of independent Bernoullis,

      E[1/(1+S)] = \int_0^1 E[x^S] dx = \int_0^1 prod_j (1 - h_j (1-x)) dx,

  a polynomial of degree J-1 integrated exactly by Gauss-Legendre
  quadrature with >= ceil(J/2) nodes.
* ``Lstar`` (eq. (14)): l_k / (1 + sum_{j!=i} h_{j,k})   (Jensen bound).
* ``L2``   (eq. (15)): l_k * h_{i,k} / (h_{i,k} + sum_{j!=i} h_{j,k}).
* ``full``: L = l_k — the classical (not-shared) Denning-Schwartz
  working-set approximation, used for the Table III baseline and for the
  SLA mapping b* <-> t* in the admission controller.

Solver: damped Jacobi outer iteration; inner step is a vectorized
bisection per proxy (the per-proxy residual is monotone increasing in
t_i for every attribution model). :func:`solve_workingset_batch` solves
K allocation vectors at once (the Table II grid), each combo stopping on
its own test. The torch solver keeps the reference's steps exactly — a not-shared warm start, 64 bracket doublings (x4),
``n_bisect`` bisections, damping and the stopping test
``it < n_outer and delta > tol`` — as a plain loop of tensor operations
on ``device`` (the CUDA card unless the caller names another) in
``dtype`` (float32 by default, the precision the reference computes in).
The stopping test reads ``delta`` on the host once per outer step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

ATTRIBUTIONS = ("L1", "Lstar", "L2", "full")


def hit_probabilities(lam: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """h_{i,k} = 1 - exp(-lambda_{i,k} * t_i)  (paper eq. (3))."""
    return -torch.expm1(-lam * t[..., None])


def _leggauss01(n_nodes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n_nodes)
    return (x + 1.0) / 2.0, w / 2.0


def _nodes(n_quad: int, like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x, w = _leggauss01(n_quad)
    return (
        torch.as_tensor(x, dtype=like.dtype, device=like.device),
        torch.as_tensor(w, dtype=like.dtype, device=like.device),
    )


def expected_inverse_one_plus(h_others: torch.Tensor, n_quad: int) -> torch.Tensor:
    """E[1/(1 + sum_j Z_j)] for independent Z_j ~ Bernoulli(h_others[j]).

    ``h_others``: (..., J-1) stacked success probabilities; returns (...).
    Exact for polynomial degree J-1 <= 2*n_quad - 1.
    """
    x, w = _nodes(n_quad, h_others)
    # terms: (..., J-1, Q) -> product over J-1 -> weighted sum over Q.
    terms = 1.0 - h_others[..., None] * (1.0 - x)
    return torch.prod(terms, dim=-2) @ w


def _l1_matrix(h: torch.Tensor, n_quad: int) -> torch.Tensor:
    """(..., J, N) matrix E_i,k = E[1/(1+sum_{j!=i} Z_{j,k})], leave-one-out.

    Uses the full product divided by the left-out factor; every factor
    ``1 - h (1-x)`` is >= x > 0 at interior quadrature nodes, so the
    division is always safe.
    """
    x, w = _nodes(n_quad, h)                                  # (Q,)
    terms = 1.0 - h.unsqueeze(-3) * (1.0 - x)[:, None, None]  # (..., Q, J, N) > 0
    full = torch.prod(terms, dim=-2, keepdim=True)            # (..., Q, 1, N)
    contribs = w[:, None, None] * full / terms                # (..., Q, J, N)
    return contribs.sum(dim=-3)


def _others_sum(h: torch.Tensor) -> torch.Tensor:
    """s_{i,k} = sum_{j != i} h_{j,k}."""
    return h.sum(dim=-2, keepdim=True) - h


def _l2_fraction(h_own: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    denom = h_own + s
    ok = denom > 0
    return torch.where(ok, h_own / torch.where(ok, denom, torch.ones_like(denom)), 1.0)


def attribution_matrix(
    h: torch.Tensor,
    lengths: torch.Tensor,
    kind: str,
    n_quad: int,
) -> torch.Tensor:
    """L_{i,k} per the selected model, given occupancy probabilities h."""
    if kind == "L1":
        return lengths[None, :] * _l1_matrix(h, n_quad)
    if kind == "Lstar":
        return lengths[None, :] / (1.0 + _others_sum(h))
    if kind == "L2":
        return lengths[None, :] * _l2_fraction(h, _others_sum(h))
    if kind == "full":
        return lengths[None, :].expand(h.shape)
    raise ValueError(f"unknown attribution {kind!r}; options: {ATTRIBUTIONS}")


@dataclass
class WorkingSetSolution:
    """Solution of eq. (8): characteristic times + derived quantities."""

    t: np.ndarray          # (J,) characteristic times
    h: np.ndarray          # (J, N) hit probabilities, eq. (3)
    L: np.ndarray          # (J, N) attributed lengths at the solution
    residual: np.ndarray   # (J,) b_i - sum_k h L   (should be ~0)
    iterations: int
    converged: bool

    @property
    def hit_rate(self) -> np.ndarray:
        """Per-proxy request-weighted hit rate: sum_k lambda_norm * h."""
        return self._hit_rate

    def with_rates(self, lam: np.ndarray) -> "WorkingSetSolution":
        lam = np.asarray(lam)
        w = lam / np.maximum(lam.sum(axis=1, keepdims=True), 1e-300)
        self._hit_rate = (w * self.h).sum(axis=1)
        return self


def _solve(
    lam: torch.Tensor,
    lengths: torch.Tensor,
    b: torch.Tensor,
    kind: str,
    n_quad: int,
    n_outer: int,
    n_bisect: int,
    damping: float,
    tol: float,
):
    """Damped Jacobi outer loop + vectorized inner bisection.

    ``b`` is (J,) for one solve or (K, J) for K allocation vectors over
    the same ``lam``; ``t``, ``h``, ``L`` and the residual get the same
    leading axis, ``iterations`` and ``delta`` one entry per combo. Each
    combo stops on its own test, ``it < n_outer and delta > tol``: once
    it turns false, the combo's ``t``, ``it`` and ``delta`` stay frozen
    while the others go on — what the batching rule of the reference's
    vmapped ``while_loop`` does, so the batch gives each combo the steps
    of its own solve.
    """
    J, N = lam.shape
    batch = b.shape[:-1]

    def frozen_lengths(h_frozen: torch.Tensor) -> torch.Tensor:
        """L for L1/Lstar/full depends only on the *other* proxies' h,
        which stay frozen during one inner solve."""
        if kind == "L1":
            return lengths[None, :] * _l1_matrix(h_frozen, n_quad)
        if kind == "Lstar":
            return lengths[None, :] / (1.0 + _others_sum(h_frozen))
        return lengths[None, :]

    def inner_solve(h_frozen: torch.Tensor) -> torch.Tensor:
        """g_i(t_i) = eq. (8) residual with the other proxies frozen; L2
        also depends on the proxy's own h, recomputed per candidate."""
        if kind == "L2":
            s = _others_sum(h_frozen)

            def residual(t_cand):
                h_own = hit_probabilities(lam, t_cand)
                L = lengths[None, :] * _l2_fraction(h_own, s)
                return (h_own * L).sum(dim=-1) - b
        else:
            L = frozen_lengths(h_frozen)

            def residual(t_cand):
                return (hit_probabilities(lam, t_cand) * L).sum(dim=-1) - b

        # Bracket: grow hi until the residual is positive (or cap).
        hi = torch.full(b.shape, 1e-2, dtype=lam.dtype, device=lam.device)
        for _ in range(64):
            hi = torch.where(residual(hi) < 0, hi * 4.0, hi)
        lo = torch.zeros_like(hi)
        for _ in range(n_bisect):
            mid = 0.5 * (lo + hi)
            neg = residual(mid) < 0
            lo = torch.where(neg, mid, lo)
            hi = torch.where(neg, hi, mid)
        return 0.5 * (lo + hi)

    dev = lam.device
    t = inner_solve(torch.zeros(batch + (J, N), dtype=lam.dtype, device=dev))  # not-shared warm start
    # delta stays a tensor so that ``tol`` is compared in ``dtype``.
    it = torch.zeros(batch, dtype=torch.int64, device=dev)
    delta = torch.full(batch, float("inf"), dtype=lam.dtype, device=dev)
    active = (it < n_outer) & (delta > tol)
    while bool(active.any()):
        t_new = inner_solve(hit_probabilities(lam, t))
        t_next = (1.0 - damping) * t + damping * t_new
        d = torch.amax(torch.abs(t_next - t) / torch.clamp(t, min=1e-12), dim=-1)
        t = torch.where(active[..., None], t_next, t)
        delta = torch.where(active, d, delta)
        it = it + active.to(torch.int64)
        active = (it < n_outer) & (delta > tol)
    h = hit_probabilities(lam, t)
    L = attribution_matrix(h, lengths, kind, n_quad)
    res = b - (h * L).sum(dim=-1)
    return t, h, L, res, it, delta


def _check_inputs(lam, lengths, b, attribution):
    J, N = lam.shape
    if lengths.shape != (N,) or b.shape[-1] != J:
        raise ValueError("shape mismatch between lam, lengths, b")
    if attribution not in ATTRIBUTIONS:
        raise ValueError(f"unknown attribution {attribution!r}")
    if attribution != "full" and np.any(b >= lengths.sum() / J):
        raise ValueError(
            "paper eq. (9) violated: some b_i >= sum(lengths)/J — the "
            "shared working-set fixed point need not exist"
        )
    if attribution == "full" and np.any(b >= lengths.sum()):
        raise ValueError("b_i >= total catalogue size: cache never evicts")


def _as_np(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def solve_workingset(
    lam,
    lengths,
    b,
    attribution: str = "L1",
    *,
    n_quad: int | None = None,
    n_outer: int = 200,
    n_bisect: int = 90,
    damping: float = 0.7,
    tol: float = 1e-7,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> WorkingSetSolution:
    """Solve eq. (8) for the characteristic times of every LRU-list.

    Parameters mirror the paper: ``lam`` (J, N) request rates, ``lengths``
    (N,) object lengths, ``b`` (J,) virtual allocations satisfying eq. (9)
    ``b_i < sum_k l_k / J`` (checked). ``attribution`` picks L1 / Lstar /
    L2 / full. The solve runs in ``dtype`` on ``device``.
    """
    lam = np.asarray(lam, dtype=np.float64)
    lengths = np.asarray(lengths, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    J, N = lam.shape
    if b.shape != (J,):
        raise ValueError("shape mismatch between lam, lengths, b")
    _check_inputs(lam, lengths, b, attribution)

    if n_quad is None:
        n_quad = max(8, (J + 1) // 2 + 1)

    dev = resolve_device(device)
    t, h, L, res, iters, delta = _solve(
        *(torch.as_tensor(x, dtype=dtype, device=dev) for x in (lam, lengths, b)),
        attribution, n_quad, n_outer, n_bisect, damping, tol,
    )
    sol = WorkingSetSolution(
        t=_as_np(t),
        h=_as_np(h),
        L=_as_np(L),
        residual=_as_np(res),
        iterations=int(iters),
        converged=bool(delta <= tol),
    )
    return sol.with_rates(lam)


def solve_workingset_unshared(lam, lengths, b, **kw) -> WorkingSetSolution:
    """Classical Denning-Schwartz (no sharing): eq. (2)-(3)."""
    return solve_workingset(lam, lengths, b, attribution="full", **kw)


def virtual_footprint(
    h,
    lengths,
    attribution: str = "L1",
    n_quad: int | None = None,
    *,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> np.ndarray:
    """Per-proxy memory footprint ``sum_k h_{i,k} L_{i,k}(h)`` (eq. (4)).

    Evaluates the attributed-length matrix at the given occupancy
    probabilities ``h`` (J, N) in ``dtype`` on ``device`` and contracts it
    against ``h`` on the host — the virtual allocation each proxy
    consumes under sharing. Evaluated at ``h* = h(t*)`` of the *unshared*
    working set at the SLA allocation ``b*``, this is exactly the minimal
    SLA-preserving virtual allocation of eq. (10); the admission
    controller (:mod:`repro_torch.core.admission`) uses it at every
    refresh.
    """
    h = np.asarray(h, dtype=np.float64)
    lengths = np.asarray(lengths, dtype=np.float64)
    if attribution not in ATTRIBUTIONS:
        raise ValueError(
            f"unknown attribution {attribution!r}; options: {ATTRIBUTIONS}"
        )
    J = h.shape[0]
    if n_quad is None:
        n_quad = max(8, (J + 1) // 2 + 1)
    dev = resolve_device(device)
    L = attribution_matrix(
        torch.as_tensor(h, dtype=dtype, device=dev),
        torch.as_tensor(lengths, dtype=dtype, device=dev),
        attribution,
        n_quad,
    )
    return (h * L.cpu().numpy()).sum(axis=1)


def solve_workingset_batch(
    lam,
    lengths,
    b_batch,
    attribution: str = "L1",
    *,
    n_quad: int | None = None,
    n_outer: int = 200,
    n_bisect: int = 90,
    damping: float = 0.7,
    tol: float = 1e-7,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> list:
    """Solve eq. (8) for a whole batch of allocation vectors at once.

    ``b_batch``: (K, J) — e.g. the 8 Table-II ``b``-combinations — over
    one ``lam`` and ``lengths``. One loop of batched tensor operations on
    ``device`` runs until the *slowest* combo converges; a combo whose
    stopping test has turned false is frozen (its ``t``, ``iterations``
    and final ``delta`` are those of its own solve, as the reference's
    vmapped ``while_loop`` gives them). Per-combo ``converged`` comes
    from its final delta.

    Returns a list of K :class:`WorkingSetSolution`.
    """
    lam = np.asarray(lam, dtype=np.float64)
    lengths = np.asarray(lengths, dtype=np.float64)
    b_batch = np.atleast_2d(np.asarray(b_batch, dtype=np.float64))
    J, N = lam.shape
    if b_batch.shape[1] != J:
        raise ValueError("b_batch must be (K, J)")
    for b in b_batch:
        _check_inputs(lam, lengths, b, attribution)

    if n_quad is None:
        n_quad = max(8, (J + 1) // 2 + 1)

    dev = resolve_device(device)
    t, h, L, res, iters, delta = _solve(
        *(torch.as_tensor(x, dtype=dtype, device=dev) for x in (lam, lengths, b_batch)),
        attribution, n_quad, n_outer, n_bisect, damping, tol,
    )
    t, h, L, res = (_as_np(x) for x in (t, h, L, res))
    iters, delta = iters.cpu().numpy(), delta.cpu()
    out = []
    for k in range(b_batch.shape[0]):
        sol = WorkingSetSolution(
            t=t[k],
            h=h[k],
            L=L[k],
            residual=res[k],
            iterations=int(iters[k]),
            converged=bool(delta[k] <= tol),
        )
        out.append(sol.with_rates(lam))
    return out
