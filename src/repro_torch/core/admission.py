"""Admission control and overbooking with shared objects (paper §IV-C).

The operator sells each tenant an SLA allocation ``b_i*`` = the memory it
would need *without* sharing to reach its hit probabilities. Under object
sharing the same hit probabilities are reached with a smaller *virtual*
allocation ``b_i <= b_i*`` (eq. (10)), so the operator can overbook:
``sum b_i <= B`` (eq. (11)) while ``sum b_i* > B`` (eq. (12)).

Key identity used throughout: with ``h = 1 - e^{-lambda t}`` the map
``t_i -> h_{i,.}`` is increasing, so "hit probabilities under sharing
match those of a dedicated b_i* cache" is exactly ``t_i = t_i*`` where
``t_i*`` solves the *unshared* working-set equation at ``b_i*``. The
minimal virtual allocation is then

    b_i = sum_k h*_{i,k} * L_{i,k}(h*)        (evaluate eq. (4) at t*)

computed by :func:`repro_torch.core.workingset.virtual_footprint`.

A new tenant J+1 is conservatively admitted iff
``b*_{J+1} <= B - sum_i b_i`` (eq. (13)); after admission its popularity
estimates are folded in and virtual allocations are recomputed.

:class:`AdmissionController` runs this loop *online*: tenants arrive
(:meth:`~AdmissionController.admit`), popularity estimates stream in
(:meth:`~AdmissionController.observe`, typically from a
:class:`~repro_torch.core.irm.PopularityEstimator`), allocations are
recomputed (:meth:`~AdmissionController.refresh`), tenants depart
(:meth:`~AdmissionController.depart` — footnote 1: departures force a
recomputation too, because the survivors lose sharing partners and
their minimal allocations *grow* back toward ``b*``), and — when that
regrowth overcommits the physical cache — the most recently admitted
tenants are evicted (:meth:`~AdmissionController.enforce`). Every
decision is appended to :attr:`~AdmissionController.log`, so an episode
can be replayed and validated against Monte-Carlo simulation (see
the reference package's ``repro.scenario`` ``admission_overbooking`` preset).

The module is pure NumPy at its interface; the torch work happens inside
the :mod:`repro_torch.core.workingset` solver it calls, on the device
passed as ``device`` (the CUDA card unless the caller names another).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.device import DeviceLike

from .workingset import (
    WorkingSetSolution,
    solve_workingset_unshared,
    virtual_footprint,
)


def virtual_allocations(
    lam: np.ndarray,
    lengths: np.ndarray,
    b_star: np.ndarray,
    *,
    attribution: str = "L1",
    n_quad: Optional[int] = None,
    device: DeviceLike = None,
) -> Tuple[np.ndarray, WorkingSetSolution]:
    """Minimal virtual allocations ``b`` matching the SLA targets ``b*``.

    Solves the unshared system at ``b*`` for ``t*``, then evaluates the
    shared attribution at ``h* = h(t*)`` (eq. (10)'s minimal ``b``).
    Returns ``(b, unshared_solution)``.
    """
    lam = np.asarray(lam, dtype=np.float64)
    lengths = np.asarray(lengths, dtype=np.float64)
    b_star = np.asarray(b_star, dtype=np.float64)
    sol_star = solve_workingset_unshared(lam, lengths, b_star, device=device)
    b = virtual_footprint(
        sol_star.h, lengths, attribution=attribution, n_quad=n_quad,
        device=device,
    )
    return b, sol_star


@dataclass
class Tenant:
    """One proxy/tenant tracked by the controller."""

    name: str
    b_star: float                 # SLA allocation (unshared-equivalent)
    b_virtual: float              # current virtual allocation (<= b_star)
    lam: Optional[np.ndarray] = None  # estimated request rates (N,)
    order: int = 0                # admission sequence number (LIFO evict)


@dataclass
class AdmissionDecision:
    """One entry of the controller's decision log."""

    action: str                  # "admit" | "reject" | "depart" | "evict"
    name: str
    admitted: bool
    reason: str
    b_star: float
    headroom_before: float
    headroom_after: float

    def to_dict(self) -> dict:
        return asdict(self)


class AdmissionController:
    """Operator-side controller implementing Section IV-C end to end.

    * ``admit()``: conservative test (eq. (13)) against current virtual
      allocations; on success the tenant starts with ``b = b*``.
    * ``observe()``: attach/update a tenant's popularity estimate.
    * ``refresh()``: recompute all virtual allocations via the
      working-set approximation from current estimates, shrinking ``b``
      toward the minimal SLA-preserving value and freeing headroom.
    * ``depart()``: remove a tenant and refresh (footnote 1 of the
      paper: allocations must be recomputed on departures too — the
      survivors' minimal allocations grow when sharing partners leave).
    * ``enforce()``: if a refresh leaves the cache overcommitted
      (``committed > B * (1 - safety_margin)``), evict the most recently
      admitted tenants until the commitment fits again.

    All decisions are appended to :attr:`log` in order.
    """

    def __init__(
        self,
        physical_capacity: float,
        lengths: np.ndarray,
        *,
        attribution: str = "L1",
        safety_margin: float = 0.0,
        device: DeviceLike = None,
    ) -> None:
        self.B = float(physical_capacity)
        self.lengths = np.asarray(lengths, dtype=np.float64)
        self.attribution = attribution
        self.safety_margin = float(safety_margin)
        self.device = device            # where refresh() runs the solver
        self.tenants: Dict[str, Tenant] = {}
        self.log: List[AdmissionDecision] = []
        self._order = 0

    # -- bookkeeping ---------------------------------------------------
    @property
    def committed(self) -> float:
        """sum of current virtual allocations (eq. (11) left-hand side)."""
        return sum(t.b_virtual for t in self.tenants.values())

    @property
    def committed_sla(self) -> float:
        """sum of SLA allocations — exceeding B means we are overbooked
        (eq. (12)), which is the point."""
        return sum(t.b_star for t in self.tenants.values())

    def headroom(self) -> float:
        return self.B * (1.0 - self.safety_margin) - self.committed

    @property
    def overbooked(self) -> bool:
        return self.committed_sla > self.B

    @property
    def overbooking_gain(self) -> float:
        """``sum b_i* / sum b_i`` over the admitted set — how much SLA
        memory is being served per unit of virtual commitment."""
        c = self.committed
        return self.committed_sla / c if c > 0 else 1.0

    # -- operations ------------------------------------------------------
    def admit(
        self, name: str, b_star: float, lam: Optional[np.ndarray] = None
    ) -> AdmissionDecision:
        """Conservative admission per eq. (13): admit iff ``b* <=
        headroom`` (boundary inclusive — eq. (13) is ``<=``)."""
        if name in self.tenants:
            raise ValueError(f"tenant {name!r} already admitted")
        before = self.headroom()
        if b_star <= before:
            self._order += 1
            self.tenants[name] = Tenant(
                name, float(b_star), b_virtual=float(b_star), order=self._order
            )
            if lam is not None:
                self.observe(name, lam)
            d = AdmissionDecision(
                "admit", name, True, "eq13-conservative", float(b_star),
                before, self.headroom(),
            )
        else:
            d = AdmissionDecision(
                "reject", name, False,
                f"b*={b_star:.1f} exceeds headroom {before:.1f} (eq. (13))",
                float(b_star), before, before,
            )
        self.log.append(d)
        return d

    def observe(self, name: str, lam: np.ndarray) -> None:
        """Attach estimated popularities (per-request rates) to a tenant."""
        self.tenants[name].lam = np.asarray(lam, dtype=np.float64)

    def depart(self, name: str) -> Dict[str, float]:
        """Remove a tenant, release its virtual allocation, and refresh
        the survivors (their minimal allocations grow — footnote 1).
        Returns the refreshed allocation map."""
        t = self.tenants.pop(name)
        before = self.headroom() - t.b_virtual  # headroom at decision time
        self.log.append(
            AdmissionDecision(
                "depart", name, False, "departure", t.b_star,
                before, self.headroom(),
            )
        )
        return self.refresh()

    def refresh(self) -> Dict[str, float]:
        """Recompute virtual allocations from current popularity
        estimates. Tenants without estimates keep ``b = b*`` (the
        conservative admission value); a lone estimated tenant has no
        sharing partner, so its minimal allocation *is* ``b*``. Returns
        the new ``{name: b_virtual}`` map."""
        est = [t for t in self.tenants.values() if t.lam is not None]
        if len(est) == 1:
            est[0].b_virtual = est[0].b_star
        elif len(est) >= 2:
            lam = np.stack([t.lam for t in est])
            b_star = np.array([t.b_star for t in est])
            b_new, _ = virtual_allocations(
                lam, self.lengths, b_star, attribution=self.attribution,
                device=self.device,
            )
            for t, b in zip(est, b_new):
                # b is minimal; never grow beyond the SLA value.
                t.b_virtual = float(min(b, t.b_star))
        return self.allocations()

    def enforce(self) -> List[str]:
        """Evict most-recently-admitted tenants until ``committed`` fits
        inside ``B * (1 - safety_margin)`` again (LIFO: the earliest
        admissions keep their SLAs). Returns the evicted names —
        normally empty; overcommitment only arises when departures make
        the survivors' minimal allocations grow past the capacity their
        admission was justified against."""
        evicted: List[str] = []
        while self.headroom() < 0 and len(self.tenants) > 1:
            victim = max(self.tenants.values(), key=lambda t: t.order)
            before = self.headroom()
            del self.tenants[victim.name]
            self.log.append(
                AdmissionDecision(
                    "evict", victim.name, False,
                    f"overcommitted: headroom {before:.1f} < 0",
                    victim.b_star, before, self.headroom(),
                )
            )
            evicted.append(victim.name)
            self.refresh()
        return evicted

    def allocations(self) -> Dict[str, float]:
        return {t.name: t.b_virtual for t in self.tenants.values()}
