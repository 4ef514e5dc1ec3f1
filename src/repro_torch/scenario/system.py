"""The System and Estimator axes of a :class:`repro_torch.scenario.Scenario`.

:class:`System` declares the cache under test — sharing variant, virtual
allocations, RRE configuration, ghost retention, which execution backend
runs it, and (optionally) an online :class:`AdmissionSpec` that turns
the static per-proxy allocations into SLA targets managed by the
Section IV-C admission controller. :class:`Estimator` declares how hit
probabilities are obtained: Monte-Carlo simulation or the working-set
fixed point of paper Section IV. All three are plain frozen dataclasses
that round-trip through JSON, so an experiment is reproducible from its
artifact alone.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, replace
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.cluster import EXECUTORS, FaultSpec
from repro_torch.core.fastsim import SimParams
from repro_torch.core.workingset import ATTRIBUTIONS

VARIANTS = ("lru", "slru", "noshare", "pooled")
# "auto" runs the lane engine on the device the run is given (the card by
# default) where it applies — flat LRU, no delayed batching, inside its
# int32 envelope, not a cluster — and a host engine elsewhere (C loop when
# a compiler exists, else the inlined Python loop); "cuda" forces the lane
# engine; "c" / "flat" / "generic" force a host engine; "reference"
# drives the hookable executable-spec classes (slow — small runs and
# debugging only).
BACKENDS = ("auto", "c", "flat", "generic", "cuda", "reference")
ESTIMATORS = ("monte_carlo", "working_set")


@dataclass(frozen=True)
class AdmissionSpec:
    """Online admission-control configuration (paper Section IV-C).

    Attaching an ``AdmissionSpec`` to a :class:`System` reinterprets the
    system's ``allocations`` as per-tenant **SLA allocations** ``b*``
    (the memory each tenant was sold, unshared-equivalent) and requires
    an explicit ``physical_capacity`` ``B`` — the point of overbooking
    is ``sum b* > B``. The scenario runner then replays the workload's
    tenant-churn event stream through an
    :class:`~repro_torch.core.admission.AdmissionController`: arrivals are
    admitted or rejected by the conservative eq. (13) test, popularity
    estimates stream in per round, virtual allocations are recomputed
    via the eq. (10) working-set mapping, departures trigger the
    footnote-1 recomputation, and overcommitment evicts the most
    recently admitted tenants.

    Fields
    ------
    attribution:
        Length-attribution model used for the eq. (10) virtual-
        allocation evaluation — one of ``L1`` (exact eq. (5)),
        ``Lstar`` (eq. (14)), ``L2`` (eq. (15)).
    safety_margin:
        Fraction of ``B`` held back from the eq. (13) headroom test
        (``headroom = B * (1 - safety_margin) - committed``); guards the
        estimate-driven refresh against popularity-estimation noise.
    laplace:
        Laplace smoothing added to the per-round popularity estimates
        (see :meth:`repro_torch.core.irm.PopularityEstimator.rates`).
    decay:
        Exponential forgetting factor applied to the popularity counts
        once per round (1.0 = never forget — the stationary-IRM
        default; < 1 tracks non-stationary demand).
    refresh_on_reject:
        When an arrival fails the conservative test, refresh the
        virtual allocations from the current estimates (freeing the
        sharing surplus) and retry the admission once — the paper's
        intended use of the working-set approximation ("to facilitate
        admission control").
    evict_on_overcommit:
        Run :meth:`~repro_torch.core.admission.AdmissionController.enforce`
        after every refresh, evicting most-recently-admitted tenants
        while the total virtual commitment exceeds
        ``B * (1 - safety_margin)`` (only reachable after departures
        make the survivors' allocations regrow).
    """

    attribution: str = "L1"
    safety_margin: float = 0.0
    laplace: float = 0.0
    decay: float = 1.0
    refresh_on_reject: bool = True
    evict_on_overcommit: bool = True

    def __post_init__(self) -> None:
        # "full" is excluded: without a sharing term, eq. (10) returns
        # b = b* exactly and the controller degenerates to static
        # partitioning — never what an admission spec means.
        shared = tuple(a for a in ATTRIBUTIONS if a != "full")
        if self.attribution not in shared:
            raise ValueError(
                f"unknown admission attribution {self.attribution!r}; "
                f"options: {shared}"
            )
        if not 0.0 <= self.safety_margin < 1.0:
            raise ValueError("safety_margin must be in [0, 1)")
        if not 0.0 <= self.decay <= 1.0:
            raise ValueError("decay must be in [0, 1]")
        if self.laplace < 0.0:
            raise ValueError("laplace must be nonnegative")

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "AdmissionSpec":
        return AdmissionSpec(**d)


@dataclass(frozen=True)
class System:
    """Declarative cache-system configuration.

    Fields
    ------
    variant:
        ``lru`` — the paper's flat shared LRU-lists (Section III);
        ``slru`` — memcached-style Segmented LRU under sharing
        (Section VII); ``noshare`` — independent full-length-charging
        LRUs (the Table III baseline); ``pooled`` — one collective LRU
        over the merged demand.
    allocations:
        Per-proxy virtual allocations ``b_i`` (in object-length units).
        With ``admission`` set these are the per-tenant *SLA* targets
        ``b*`` instead, and the runner manages the actual virtual
        allocations online.
    physical_capacity:
        Physical cache size ``B``. Defaults to ``sum(allocations)`` (or
        ``sum(b_hat)`` when slack is configured, so the slack is
        actually backed by memory). Required explicitly when
        ``admission`` is set.
    ghost_retention:
        Keep evicted-from-list objects resident while another list still
        holds them (the paper's ghost semantics).
    slack_frac / ripple_allocations / batch_interval:
        RRE (Section IV-D): ``slack_frac`` > 0 derives ripple thresholds
        ``b_hat = ceil(b * (1 + slack_frac))`` unless an explicit
        ``ripple_allocations`` overrides it; ``batch_interval`` > 0 adds
        delayed batch eviction every that-many set operations.
    hot_frac / warm_frac:
        S-LRU segment split (``variant="slru"`` only).
    backend:
        Execution engine: ``auto`` (the lane engine on the run's device,
        ``Scenario.run(device=...)``, for a flat-LRU Monte-Carlo run
        without delayed batching inside its int32 envelope; otherwise,
        and always for a cluster, the C loop when a compiler exists, else
        the inlined Python loop), ``c``, ``flat``, ``generic``, ``cuda``
        (the lane engine, forced), or ``reference`` (the hookable
        executable-spec classes — slow, small runs and debugging only).
    admission:
        Optional :class:`AdmissionSpec` enabling the online Section
        IV-C admission-control loop (tenant-churn workloads only).
    nodes:
        Number of MCD-OS nodes behind the consistent-hash ring
        (:mod:`repro_torch.core.cluster`). ``1`` (default) is the paper's
        single-server prototype; ``K > 1`` shards the object space
        across K homogeneous nodes, each a full shared cache with these
        ``allocations``.
    faults:
        Optional :class:`~repro_torch.core.cluster.FaultSpec` fault-injection
        schedule (scheduled + seeded-random ``fail`` / ``recover`` /
        ``add`` / ``remove`` events, failover retry budget, recovery
        windows). Setting it — even empty — routes the run through the
        cluster simulator; per-phase hit rates, remap fractions and
        recovery time land in ``Report.extras["cluster"]``.
    executor:
        How the cluster's per-node feeding pass runs: ``sequential``
        (default — the reference path) or ``parallel`` (a
        :class:`~repro_torch.core.cluster.ClusterExecutor` process pool;
        bit-identical results, one worker process per node subset).
        Setting ``parallel`` routes the run through the cluster
        simulator even at ``nodes=1``.
    workers:
        Process count for ``executor="parallel"`` (default:
        ``os.cpu_count()``, capped at the node count). Never affects
        results — only wall-clock time.
    """

    variant: str = "lru"
    allocations: Tuple[int, ...] = ()
    physical_capacity: Optional[int] = None
    ghost_retention: bool = True
    slack_frac: float = 0.0
    ripple_allocations: Optional[Tuple[int, ...]] = None
    batch_interval: int = 0
    hot_frac: float = 0.32
    warm_frac: float = 0.32
    backend: str = "auto"
    admission: Optional[AdmissionSpec] = None
    nodes: int = 1
    faults: Optional[FaultSpec] = None
    executor: str = "sequential"
    workers: Optional[int] = None

    def __post_init__(self) -> None:
        if self.variant not in VARIANTS:
            raise ValueError(
                f"unknown variant {self.variant!r}; options: {VARIANTS}"
            )
        if self.backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {self.backend!r}; options: {BACKENDS}"
            )
        if not self.allocations:
            raise ValueError("system needs per-proxy allocations")
        if self.slack_frac < 0:
            raise ValueError("slack_frac must be nonnegative")
        if self.admission is not None:
            if self.physical_capacity is None:
                raise ValueError(
                    "admission-controlled systems need an explicit "
                    "physical_capacity (allocations are SLA targets; "
                    "overbooking means sum b* > B)"
                )
            if self.variant != "lru":
                raise ValueError(
                    "admission control models the flat shared-LRU "
                    "system (variant='lru')"
                )
        if self.nodes < 1:
            raise ValueError("nodes must be >= 1")
        if self.executor not in EXECUTORS:
            raise ValueError(
                f"unknown executor {self.executor!r}; options: {EXECUTORS}"
            )
        if self.workers is not None:
            if self.executor != "parallel":
                raise ValueError(
                    "workers applies to executor='parallel' only"
                )
            if self.workers < 1:
                raise ValueError("workers must be >= 1")
        if self.is_cluster:
            if self.variant != "lru":
                raise ValueError(
                    "cluster simulation models the flat shared-LRU "
                    "system (variant='lru')"
                )
            if self.backend not in ("auto", "c", "flat"):
                raise ValueError(
                    "cluster systems run on the chunk-fed fastsim "
                    "backends: backend must be 'auto', 'c' or 'flat'"
                )
            if self.admission is not None:
                raise ValueError(
                    "admission control and cluster fault injection "
                    "cannot be combined (one scenario axis at a time)"
                )

    @property
    def is_cluster(self) -> bool:
        """Whether this system runs through the cluster simulator."""
        return (
            self.nodes > 1
            or self.faults is not None
            or self.executor != "sequential"
        )

    @property
    def n_proxies(self) -> int:
        return len(self.allocations)

    def b_hat(self) -> Optional[Tuple[int, ...]]:
        """Effective RRE ripple allocations (None = no slack)."""
        if self.ripple_allocations is not None:
            return tuple(int(x) for x in self.ripple_allocations)
        if self.slack_frac > 0:
            return tuple(
                int(np.ceil(b * (1.0 + self.slack_frac)))
                for b in self.allocations
            )
        return None

    def capacity(self) -> int:
        if self.physical_capacity is not None:
            return int(self.physical_capacity)
        b_hat = self.b_hat()
        return sum(b_hat) if b_hat is not None else sum(self.allocations)

    def to_sim_params(self) -> SimParams:
        return SimParams(
            allocations=tuple(int(x) for x in self.allocations),
            physical_capacity=self.capacity(),
            ghost_retention=self.ghost_retention,
            ripple_allocations=self.b_hat(),
            variant=self.variant,
            hot_frac=self.hot_frac,
            warm_frac=self.warm_frac,
            batch_interval=self.batch_interval,
        )

    def scaled(self, catalogue: float) -> "System":
        if catalogue == 1.0:
            return self
        kw = {
            "allocations": tuple(
                max(1, round(b * catalogue)) for b in self.allocations
            )
        }
        if self.physical_capacity is not None:
            kw["physical_capacity"] = max(
                1, round(self.physical_capacity * catalogue)
            )
        if self.ripple_allocations is not None:
            kw["ripple_allocations"] = tuple(
                max(1, round(b * catalogue)) for b in self.ripple_allocations
            )
        return replace(self, **kw)

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "System":
        d = dict(d)
        for key in ("allocations", "ripple_allocations"):
            if d.get(key) is not None:
                d[key] = tuple(d[key])
        if d.get("admission") is not None:
            d["admission"] = AdmissionSpec.from_dict(d["admission"])
        if d.get("faults") is not None:
            d["faults"] = FaultSpec.from_dict(d["faults"])
        return System(**d)


@dataclass(frozen=True)
class Estimator:
    """How hit probabilities are produced.

    ``monte_carlo`` simulates the system trajectory (exact semantics,
    PASTA residence-time occupancy estimator); ``working_set`` solves the
    paper's eq. (8) fixed point under the selected length-attribution
    model — no trace, milliseconds instead of minutes, approximate.

    Fields
    ------
    kind:
        ``monte_carlo`` or ``working_set``.
    attribution:
        Working-set length-attribution model: ``L1`` (exact eq. (5)
        expectation), ``Lstar`` (eq. (14) Jensen bound), ``L2``
        (eq. (15)), or ``full`` (classical Denning-Schwartz, no
        sharing). Ignored by ``monte_carlo``.
    n_quad:
        Gauss-Legendre nodes for the exact L1 expectation (default
        ``max(8, ceil((J+1)/2))`` — exact for the degree-(J-1)
        polynomial integrand).
    n_outer / n_bisect / damping / tol:
        Fixed-point solver knobs: damped-Jacobi outer iterations, inner
        bisection steps per proxy, damping factor, and relative
        convergence tolerance on the characteristic times.
    streaming:
        Monte-Carlo memory mode. ``True`` feeds the trace through the
        engine in ``chunk_size`` pieces (``Workload.iter_chunks`` ->
        ``fastsim.simulate_chunks``) and reports occupancy as a sparse
        touched-set, so peak memory is O(chunk + engine state) instead
        of O(n_requests + J*N); ``False`` forces the one-shot dense
        path; ``None`` (default) picks streaming automatically once
        ``n_requests * J >= 12M`` or ``J * n_objects >= 4M`` (the
        runner's ``STREAMING_REQUEST_CELLS`` / ``STREAMING_STATE_CELLS``
        thresholds — the Section VI-C full-catalogue regime). Results
        are bit-identical either way — streaming only changes the
        memory footprint and the occupancy representation.
    chunk_size:
        Requests per streamed chunk (streaming mode only).
    replications:
        Monte-Carlo only: number of independent ensemble replicas R.
        ``1`` (default) runs the classic single trajectory. ``R > 1``
        runs R replicas on independent trace substreams (replica 0 uses
        the scenario's own trace seed, so its results are bit-identical
        to a ``replications=1`` run) and the Report aggregates them —
        ``hit_prob`` / ``hit_rate`` become cross-replica means and the
        per-replica estimates land in ``Report.ensemble``, enabling the
        ``hit_prob_ci()`` / ``hit_rate_ci()`` confidence-band
        accessors. On ``backend="cuda"`` all replicas run batched, one
        lane each, in one kernel launch per chunk
        (:func:`repro_torch.core.fastsim_cuda.simulate_ensemble`); other
        backends run them sequentially with identical per-replica
        results.
    """

    kind: str = "monte_carlo"
    attribution: str = "L1"  # working_set only
    n_quad: Optional[int] = None
    n_outer: int = 200
    n_bisect: int = 90
    damping: float = 0.7
    tol: float = 1e-7
    streaming: Optional[bool] = None  # monte_carlo only; None = auto by size
    chunk_size: int = 250_000  # requests per streamed chunk
    replications: int = 1  # monte_carlo only; R > 1 = ensemble run

    def __post_init__(self) -> None:
        if self.kind not in ESTIMATORS:
            raise ValueError(
                f"unknown estimator {self.kind!r}; options: {ESTIMATORS}"
            )
        if self.attribution not in ATTRIBUTIONS:
            raise ValueError(
                f"unknown attribution {self.attribution!r}; "
                f"options: {ATTRIBUTIONS}"
            )
        if self.chunk_size < 1:
            raise ValueError("chunk_size must be positive")
        if self.replications < 1:
            raise ValueError("replications must be >= 1")
        if self.replications > 1 and self.kind != "monte_carlo":
            raise ValueError(
                "replications apply to the monte_carlo estimator only "
                "(working_set is deterministic)"
            )

    def to_dict(self) -> dict:
        return asdict(self)

    @staticmethod
    def from_dict(d: dict) -> "Estimator":
        return Estimator(**d)
