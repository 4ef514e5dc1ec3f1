"""Named scenario presets for every paper experiment.

Each preset is a factory returning a :class:`Scenario` at **paper
scale** (the sizes of the source paper's tables/figures); callers dial
them down with :meth:`Scenario.scaled` — that is how the benchmark
harness maps its ``--quick`` / default / ``REPRO_FULL`` fidelity modes
onto one definition instead of per-benchmark env-var forks.

    from repro_torch.scenario import get_preset, list_presets

    sc = get_preset("table1", b=(8, 8, 64)).scaled(requests=0.15)
    report = sc.run()
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from repro_torch.core.cluster import FaultSpec

from .scenario import Scenario
from .system import AdmissionSpec, Estimator, System
from .workload import Workload

# The paper's Section V setup (Tables I-III): J=3 lists over a B=1000
# physical cache, unit objects, Zipf alphas (0.75, 0.5, 1.0), N=1000
# (calibrated against Table II), 10M requests per combo at full scale.
SECTION5_ALPHAS = (0.75, 0.5, 1.0)
SECTION5_N = 1000
SECTION5_B = 1000
SECTION5_REQUESTS = 10_000_000

# Section VI-C workload (Fig. 2 / Table V): J=9 proxies, Zipf
# 0.5+0.5(i-1), 1e6 items of 100 kB (1 unit), B=3 GB, allocations
# 3x100 MB + 3x200 MB + 3x700 MB in 100 kB units, 3M requests.
FIG2_ALPHAS = tuple(0.5 + 0.5 * i for i in range(9))
FIG2_B_UNITS = (1000, 1000, 1000, 2000, 2000, 2000, 7000, 7000, 7000)
FIG2_N = 1_000_000
FIG2_REQUESTS = 3_000_000


def _section5_workload() -> Workload:
    return Workload(kind="irm", n_objects=SECTION5_N, alphas=SECTION5_ALPHAS)


def table1(b: Tuple[int, int, int] = (64, 64, 64), seed: int = 7) -> Scenario:
    return Scenario(
        name="table1",
        description=(
            "Paper Table I: empirical per-object hit probabilities of the "
            f"shared J=3 cache at b={tuple(b)} (Monte-Carlo, PASTA "
            "occupancy estimator)."
        ),
        workload=_section5_workload(),
        system=System(
            variant="lru",
            allocations=tuple(b),
            physical_capacity=SECTION5_B,
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=SECTION5_REQUESTS,
        seed=seed,
    )


def table3_noshare(
    b: Tuple[int, int, int] = (64, 64, 8), seed: int = 11
) -> Scenario:
    return Scenario(
        name="table3_noshare",
        description=(
            "Paper Table III: the not-shared baseline — J independent "
            f"full-length-charging LRUs at b={tuple(b)}."
        ),
        workload=_section5_workload(),
        system=System(variant="noshare", allocations=tuple(b)),
        estimator=Estimator("monte_carlo"),
        n_requests=SECTION5_REQUESTS,
        seed=seed,
    )


def fig2_ripple(seed: int = 23) -> Scenario:
    return Scenario(
        name="fig2_ripple",
        description=(
            "Paper Fig. 2 (Section VI-C): evictions-per-set histogram of "
            "the J=9 heterogeneous-Zipf workload (1e6 objects, 3 GB "
            "cache in 100 kB units)."
        ),
        workload=Workload(kind="irm", n_objects=FIG2_N, alphas=FIG2_ALPHAS),
        system=System(
            variant="lru",
            allocations=FIG2_B_UNITS,
            physical_capacity=sum(FIG2_B_UNITS),
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=FIG2_REQUESTS,
        warmup=FIG2_REQUESTS // 10,
        seed=seed,
    )


def rre(slack_frac: float = 0.25, batch_interval: int = 0, seed: int = 31) -> Scenario:
    n = FIG2_REQUESTS // 3
    return Scenario(
        name="rre",
        description=(
            "Section IV-D Reducing Ripple Evictions: the Fig.-2 system "
            f"with slack thresholds (slack={slack_frac}) and delayed "
            f"batch evictions (interval={batch_interval})."
        ),
        workload=Workload(kind="irm", n_objects=FIG2_N, alphas=FIG2_ALPHAS),
        system=System(
            variant="lru",
            allocations=FIG2_B_UNITS,
            slack_frac=slack_frac,
            batch_interval=batch_interval,
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=n,
        warmup=n // 10,
        ripple_from=0,
        seed=seed,
    )


def slru(b: Tuple[int, int, int] = (64, 64, 64), seed: int = 13) -> Scenario:
    return Scenario(
        name="slru",
        description=(
            "Section VII: memcached Segmented-LRU (HOT/WARM/COLD) under "
            f"object sharing at b={tuple(b)} — compare against the "
            "'table1' flat-LRU preset on the same seed."
        ),
        workload=_section5_workload(),
        system=System(
            variant="slru",
            allocations=tuple(b),
            physical_capacity=SECTION5_B,
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=SECTION5_REQUESTS,
        seed=seed,
    )


def j2_bounds(seed: int = 5) -> Scenario:
    return Scenario(
        name="j2_bounds",
        description=(
            "Section V J=2 discussion: simulate alphas (0.75, 1.0) at "
            "b=(32, 32); solving the same scenario with "
            "with_estimator('working_set', attribution=...) under "
            "L1/Lstar/L2 brackets the truth."
        ),
        workload=Workload(
            kind="irm", n_objects=SECTION5_N, alphas=(0.75, 1.0)
        ),
        system=System(
            variant="lru",
            allocations=(32, 32),
            physical_capacity=SECTION5_N,
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=SECTION5_REQUESTS,
        seed=seed,
    )


def shot_noise(seed: int = 41) -> Scenario:
    n = SECTION5_REQUESTS
    return Scenario(
        name="shot_noise",
        description=(
            "Non-stationary catalogue churn (shot-noise style, cf. Olmos "
            "et al.): the Section-V system under per-phase popularity "
            "rotation — the estimator-vs-simulator comparison off the "
            "stationary IRM."
        ),
        workload=Workload(
            kind="shot_noise",
            n_objects=SECTION5_N,
            alphas=SECTION5_ALPHAS,
            phase_requests=n // 20,
            phase_shift=50,
        ),
        system=System(
            variant="lru",
            allocations=(64, 64, 64),
            physical_capacity=SECTION5_B,
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=n,
        seed=seed,
    )


def admission_overbooking(
    b_star: int = 64, n_tenants: int = 8, seed: int = 47
) -> Scenario:
    """Section IV-C as an online episode.

    ``n_tenants`` similar-but-not-identical Zipf tenants (high demand
    overlap — the regime sharing targets) ask for ``b* = 64`` each
    against a physical cache sized for only six unshared tenants
    (``B = 384``): tenants 0-5 arrive one per round, tenant 2 departs,
    then tenants 6-7 arrive into the freed + overbooked headroom. The
    runner validates the final admitted set by simulating it at its
    virtual allocations and comparing per-tenant hit rates against the
    unshared eq. (10) SLA prediction.
    """
    alphas = tuple(0.9 + 0.02 * i for i in range(n_tenants))
    if n_tenants == 8:
        events = tuple((r, "arrive", r) for r in range(6)) + (
            (6, "depart", 2),
            (7, "arrive", 6),
            (8, "arrive", 7),
        )
        churn = "with arrivals, one departure, "
    else:
        # generic fallback: one arrival per round, no churn tail
        events = tuple((r, "arrive", r) for r in range(n_tenants))
        churn = "with one arrival per round, "
    return Scenario(
        name="admission_overbooking",
        description=(
            "Paper Section IV-C online: admission control + overbooking "
            f"episode — {n_tenants} tenants at b*={b_star} against "
            f"B={6 * b_star} (room for 6 unshared), {churn}"
            "eq. (13) admissions, eq. (10) virtual-allocation "
            "refreshes, and a final realized-vs-predicted SLA check."
        ),
        workload=Workload(
            kind="tenant_churn",
            n_objects=SECTION5_N,
            alphas=alphas,
            tenant_events=events,
            round_requests=200_000,
        ),
        system=System(
            variant="lru",
            allocations=(b_star,) * n_tenants,
            physical_capacity=6 * b_star,
            admission=AdmissionSpec(),
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=2_000_000,
        seed=seed,
    )


def serving_multitenant(
    n_tenants: int = 6, shared_frac: float = 0.75, seed: int = 61
) -> Scenario:
    """Multi-tenant KV prefix-cache serving with gated onboarding.

    ``n_tenants`` tenants share a paged KV-block store sized for only
    four dedicated tenants (``B = 4 b*`` against ``sum b* = 6 b*``):
    each serves Zipf traffic over 512 prompts whose system-prompt /
    few-shot prefixes (16 blocks) are drawn from a
    ``shared_frac``-shared pool, followed by 2 user-suffix blocks from
    4 per-prompt variants. Onboarding runs through the eq. (13) test on
    the declared rates — later tenants are admitted into the sharing
    surplus the earlier ones free up — and the admitted set drives a
    10M-block-event trace through the fastsim engine. Blocks are priced
    with the qwen3-1.7b paged-KV layout (16 tokens/block);
    ``Report.extras["serving"]`` carries the hit/FLOPs/bytes-shared
    economics and the onboarding record.
    """
    b_star = 2048
    return Scenario(
        name="serving_multitenant",
        description=(
            "Multi-tenant KV prefix-cache serving: "
            f"{n_tenants} Zipf tenants x 512 prompts, "
            f"{shared_frac:.0%}-shared 16-block prefixes + 2-block "
            f"suffix tails, b*={b_star} blocks each against "
            f"B={4 * b_star} (room for 4 unshared) with eq. (13) "
            "admission-gated onboarding; blocks priced via the "
            "qwen3-1.7b paged-KV layout."
        ),
        workload=Workload(
            kind="serving",
            alphas=tuple(0.8 + 0.05 * i for i in range(n_tenants)),
            proxy_rates=tuple(1.0 + 0.25 * i for i in range(n_tenants)),
            n_prompts=512,
            shared_frac=shared_frac,
            prefix_blocks=16,
            suffix_blocks=2,
            suffix_choices=4,
            kv_arch="qwen3-1.7b",
            block_tokens=16,
        ),
        system=System(
            variant="lru",
            allocations=(b_star,) * n_tenants,
            physical_capacity=4 * b_star,
            admission=AdmissionSpec(),
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=10_000_000,
        seed=seed,
    )


def cluster_failover(nodes: int = 4, seed: int = 53) -> Scenario:
    """Fault-tolerant cluster scenario: kill-and-recover one of K nodes.

    The Fig.-2 workload (J=9 heterogeneous Zipf proxies over 1e6
    objects) sharded across ``nodes`` homogeneous MCD-OS nodes behind a
    64-vnode consistent-hash ring. Node 1 fails at 40% of the trace and
    recovers warm at 60%; in between, the failover client walks the
    ring (budget 2) and exhausted requests degrade to misses. The
    per-phase hit rates, remap fractions, retry counts, and recovery
    time-to-baseline land in ``Report.extras["cluster"]``.
    """
    return Scenario(
        name="cluster_failover",
        description=(
            f"Fault-tolerant MCD-OS cluster: the Fig.-2 workload across "
            f"K={nodes} nodes behind a consistent-hash ring; node 1 "
            "fails at 40% of the trace, recovers warm at 60% — "
            "failover routing, graceful degradation, and "
            "recovery-to-baseline telemetry."
        ),
        workload=Workload(kind="irm", n_objects=FIG2_N, alphas=FIG2_ALPHAS),
        system=System(
            variant="lru",
            allocations=FIG2_B_UNITS,
            physical_capacity=sum(FIG2_B_UNITS),
            nodes=nodes,
            faults=FaultSpec(
                events=((0.4, "fail", 1), (0.6, "recover", 1)),
            ),
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=FIG2_REQUESTS,
        warmup=FIG2_REQUESTS // 10,
        seed=seed,
    )


def quickstart(seed: int = 1) -> Scenario:
    return Scenario(
        name="quickstart",
        description=(
            "Small Section-V demo (400k requests at b=(64, 64, 8)) used "
            "by examples/quickstart.py."
        ),
        workload=_section5_workload(),
        system=System(
            variant="lru",
            allocations=(64, 64, 8),
            physical_capacity=SECTION5_B,
        ),
        estimator=Estimator("monte_carlo"),
        n_requests=400_000,
        seed=seed,
    )


# Table II is the working-set view of the Table-I system; expressing it
# via with_estimator keeps the two presets structurally identical.
def _table2_ws(
    b: Tuple[int, int, int] = (64, 64, 64), attribution: str = "L1"
) -> Scenario:
    sc = table1(b).with_estimator("working_set", attribution=attribution)
    return dataclasses.replace(
        sc,
        name="table2_ws",
        description=(
            "Paper Table II: working-set approximation (eq. (8) with "
            f"{attribution} attribution) of the Table-I system at "
            f"b={tuple(b)}."
        ),
    )


PRESETS: Dict[str, Callable[..., Scenario]] = {
    "table1": table1,
    "table2_ws": _table2_ws,
    "table3_noshare": table3_noshare,
    "fig2_ripple": fig2_ripple,
    "rre": rre,
    "slru": slru,
    "j2_bounds": j2_bounds,
    "shot_noise": shot_noise,
    "admission_overbooking": admission_overbooking,
    "serving_multitenant": serving_multitenant,
    "cluster_failover": cluster_failover,
    "quickstart": quickstart,
}


def list_presets() -> Dict[str, str]:
    """{name: one-line description} for every registered preset."""
    return {name: fn().description for name, fn in PRESETS.items()}


def get_preset(name: str, **kwargs) -> Scenario:
    """Instantiate a named preset at paper scale.

    Keyword arguments are forwarded to the preset factory (e.g.
    ``get_preset("table1", b=(8, 8, 64))``). Scale down with
    :meth:`Scenario.scaled`.
    """
    try:
        fn = PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {', '.join(sorted(PRESETS))}"
        ) from None
    return fn(**kwargs)
