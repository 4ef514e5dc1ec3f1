"""``repro_torch.scenario`` — one declarative entry point over workloads,
systems, and estimators.

The paper's pipeline is "pick a workload -> pick a sharing policy ->
estimate hit probabilities (Monte-Carlo or working-set) -> feed
admission control". This package turns that into a single serializable
object::

    from dataclasses import replace

    from repro_torch.scenario import get_preset

    sc = get_preset("table1", b=(64, 64, 8)).scaled(requests=0.1)
    sim = sc.run()                                   # Monte-Carlo Report
    ws = sc.with_estimator("working_set").run()      # same Report type, on the card
    on = replace(sc, system=replace(sc.system, backend="cuda"))
    gpu = on.run()                  # Monte-Carlo on the CUDA lane engine
    cpu = on.run(device="cpu")      # the same step body, built for the host

``run(device=None)`` takes the device of the runs that use one: the
lane engine (``backend="cuda"``) and the working-set solve. ``None`` is
the CUDA card and raises without one. The device is not part of the
scenario: it never enters ``System`` or the scenario's JSON.

Axes
----
* :class:`Workload` — stationary IRM/Zipf (per-proxy heterogeneous
  alphas), shot-noise/non-stationary popularity churn, explicit trace
  replay, a ``tenant_churn`` admission episode, or a ``serving``
  multi-tenant KV prefix-cache scenario; object-size distributions via
  :class:`LengthSpec`.
* :class:`System` — flat shared LRU, S-LRU, not-shared, pooled; ghost
  retention, RRE slack/batch config; backend selection across the
  reference ``SharedLRUCache``, the fastsim Python/C drivers and the
  CUDA lane engine (``backend="cuda"``);
  optional online admission control via :class:`AdmissionSpec`; and
  K-node consistent-hash cluster simulation with seeded fault
  injection via ``System(nodes=K, faults=FaultSpec(...))`` —
  per-phase hit rates, remap fractions, retry counts, and recovery
  time-to-baseline land in ``Report.extras["cluster"]``.
* :class:`Estimator` — ``monte_carlo`` vs ``working_set`` (L1 / Lstar /
  L2 / full attribution), both returning one :class:`Report`. Large
  Monte-Carlo runs stream automatically (chunk-fed engine + sparse
  touched-set occupancy) past the runner's size thresholds
  (``n_requests * J >= 12M`` or ``J * n_objects >= 4M``); results are
  bit-identical to the one-shot dense path. ``replications=R`` turns
  any Monte-Carlo run into an R-replica ensemble (replica 0
  bit-identical to the single run; batched in one CUDA launch per chunk
  on ``backend="cuda"``) whose Report carries cross-replica means plus the
  ``hit_prob_ci()`` / ``hit_rate_ci()`` confidence-band accessors.

Admission control (Section IV-C)
--------------------------------
An admission scenario is declarative like everything else — a
``tenant_churn`` workload (tenants + arrival/departure events +
estimation traffic per round) over a ``System`` whose ``allocations``
are the per-tenant SLA targets ``b*`` and whose ``admission`` spec
drives the online controller::

    from repro_torch.scenario import (
        AdmissionSpec, Estimator, Scenario, System, Workload,
    )

    sc = Scenario(
        name="overbook",
        workload=Workload(
            kind="tenant_churn",
            n_objects=1000,
            alphas=(0.9, 0.92, 0.94, 0.96),       # one per tenant
            tenant_events=(
                (0, "arrive", 0), (1, "arrive", 1),
                (2, "arrive", 2), (3, "depart", 0),
                (4, "arrive", 3),
            ),
            round_requests=50_000,                 # estimation traffic
        ),
        system=System(
            allocations=(64, 64, 64, 64),          # SLA targets b*
            physical_capacity=192,                 # B < sum b*: overbook
            admission=AdmissionSpec(attribution="L1"),
        ),
        estimator=Estimator("monte_carlo"),        # validation estimator
        n_requests=500_000,                        # validation trace
        seed=7,
    )
    rep = sc.run()
    rep.extras["admission"]["decisions"]           # admit/reject/... log
    rep.extras["admission"]["overbooking_gain"]    # sum b* / sum b
    rep.extras["admission"]["realized_hit_rate"]   # vs predicted_sla_hit_rate

The episode replays arrivals/departures through the eq. (13) test,
refreshes eq. (10) virtual allocations from online popularity
estimates, and finally *validates* the admitted set by running it at
its virtual allocations with the configured estimator — the returned
:class:`Report` is that validation run, with the full episode under
``extras["admission"]``. The ``admission_overbooking`` preset packages
the paper-scale version.

Serving workloads (KV prefix caching)
-------------------------------------
``Workload(kind="serving")`` declares a multi-tenant LLM-serving
prompt-stream model — per-tenant Zipf popularity over a prompt
catalogue whose system-prompt/few-shot prefixes come from a partially
shared pool, plus per-prompt user-suffix variants — and compiles it to
a (tenant, KV-block) trace: every block-aligned prefix extension is one
chained-key object, so prefix-block residency runs through the same
fastsim engines as every other workload (millions of requests/s)
instead of the per-call reference ``SharedPrefixCache``::

    sc = get_preset("serving_multitenant").scaled(requests=0.1)
    rep = sc.run()
    rep.serving["prefix_hit_token_ratio"]   # tokens served from cache
    rep.serving["prefill_flops_saved"]      # priced via kv_arch
    rep.serving["admission"]                # gated onboarding record

The trace compiler is proven block-for-block equivalent to driving
``SharedPrefixCache.lookup/insert`` per request
(``tests/test_serving_trace.py``); :class:`ServingReport` documents
every derived metric. With ``System(admission=AdmissionSpec())``,
tenant onboarding is gated by the eq. (13) predicted-SLA test before
the trace runs.

Named presets cover every paper experiment (``list_presets()``); the
older entry points (``SimParams``/``simulate_trace``,
``solve_workingset``, ``MCDOSServer.run_trace``) remain supported as the
low-level layer this package drives.
"""

from repro_torch.core.cluster import FaultSpec  # noqa: F401

from .report import Report, ServingReport  # noqa: F401
from .scenario import Scenario  # noqa: F401
from .system import AdmissionSpec, Estimator, System  # noqa: F401
from .workload import LengthSpec, Workload  # noqa: F401
from .presets import PRESETS, get_preset, list_presets  # noqa: F401

__all__ = [
    "AdmissionSpec",
    "Estimator",
    "FaultSpec",
    "LengthSpec",
    "PRESETS",
    "Report",
    "Scenario",
    "ServingReport",
    "System",
    "Workload",
    "get_preset",
    "list_presets",
]
