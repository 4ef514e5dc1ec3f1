"""`Scenario` — the single declarative entry point over workloads,
systems, and estimators.

One object describes a full experiment of the paper's pipeline (pick a
workload -> pick a sharing policy -> estimate hit probabilities) and
``scenario.run()`` produces one :class:`~repro_torch.scenario.report.Report`
whichever estimator is selected, so Monte-Carlo simulation and the
working-set analytics are interchangeable::

    from repro_torch.scenario import Scenario, System, Workload, Estimator

    sc = Scenario(
        name="demo",
        workload=Workload(alphas=(0.75, 0.5, 1.0), n_objects=1000),
        system=System(allocations=(64, 64, 8), physical_capacity=1000),
        estimator=Estimator("monte_carlo"),
        n_requests=1_000_000,
    )
    sim = sc.run()
    ws = sc.with_estimator("working_set").run()

Scenarios round-trip through JSON (``to_json`` / ``from_json`` /
``save`` / ``load``): rerunning a loaded scenario with the same seed
reproduces the same Report estimates bit for bit.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import Optional

from repro_torch.device import DeviceLike

from .report import Report
from .system import Estimator, System
from .workload import Workload

SCHEMA_VERSION = 1


@dataclass(frozen=True)
class Scenario:
    """A named, serializable experiment specification."""

    name: str
    workload: Workload
    system: System
    estimator: Estimator = field(default_factory=Estimator)
    n_requests: int = 0       # 0 + trace workload = replay the full trace
    warmup: Optional[int] = None      # None = default_warmup heuristic
    ripple_from: Optional[int] = None  # None = warmup
    seed: int = 0
    description: str = ""

    def __post_init__(self) -> None:
        if self.workload.kind != "trace" and self.n_requests < 1:
            if self.estimator.kind == "monte_carlo":
                raise ValueError("monte_carlo scenarios need n_requests >= 1")
        wj = self.workload.n_proxies
        sj = self.system.n_proxies
        if wj != sj:
            raise ValueError(
                f"workload has {wj} proxies but system has {sj} allocations"
            )

    # ------------------------------------------------------------------
    def run(self, device: DeviceLike = None) -> Report:
        """Produce a Report with the configured estimator.

        ``device`` is where the runs that use one go: the CUDA lane
        engine (``backend="cuda"``, and ``"auto"`` on a flat-LRU
        Monte-Carlo run) and the working-set solve. ``None`` is the CUDA
        card (raises without one); ``"cpu"`` runs the same code on the
        host. Host backends ignore it. It is not part of the scenario and
        never enters its JSON."""
        from .runner import run_scenario

        return run_scenario(self, device=device)

    # ------------------------------------------------------------------
    def with_estimator(self, kind: str, **kw) -> "Scenario":
        """Same experiment, different estimator (e.g. swap ``monte_carlo``
        for ``working_set`` to compare Table I against Table II)."""
        return replace(self, estimator=Estimator(kind=kind, **kw))

    def scaled(self, requests: float = 1.0, catalogue: float = 1.0) -> "Scenario":
        """Shrink (or grow) the experiment while keeping its shape.

        ``requests`` scales the trace length (and warmup, when pinned);
        ``catalogue`` scales the object population together with every
        allocation/capacity so the b/N operating regime is preserved.
        This is what replaces the old ``REPRO_FULL``/``REPRO_QUICK``
        per-benchmark forks: presets are defined at paper scale and the
        harness dials them down.

        Trace-replay workloads cannot be rescaled (their catalogue and
        request stream are fixed recordings): catalogue scaling would
        shrink the system against an unshrunk trace, so it raises, as
        does requests scaling of a full-trace (``n_requests=0``) replay
        — set ``n_requests`` to a prefix length explicitly instead.
        """
        if self.workload.kind == "trace":
            if catalogue != 1.0:
                raise ValueError(
                    "cannot catalogue-scale a trace-replay scenario: the "
                    "recorded trace keeps its object population"
                )
            if requests != 1.0 and not self.n_requests:
                raise ValueError(
                    "cannot requests-scale a full-trace replay "
                    "(n_requests=0); set n_requests to a prefix length"
                )
        kw = {}
        if requests != 1.0:
            if self.n_requests:
                kw["n_requests"] = max(1, round(self.n_requests * requests))
            if self.warmup is not None:
                kw["warmup"] = max(0, round(self.warmup * requests))
            if self.ripple_from is not None and self.ripple_from > 0:
                kw["ripple_from"] = max(0, round(self.ripple_from * requests))
        wl = self.workload.scaled(requests, catalogue)
        sy = self.system.scaled(catalogue)
        if wl is not self.workload:
            kw["workload"] = wl
        if sy is not self.system:
            kw["system"] = sy
        return replace(self, **kw) if kw else self

    # ------------------------------------------------------------------
    # JSON round-trip
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema": SCHEMA_VERSION,
            "name": self.name,
            "description": self.description,
            "workload": self.workload.to_dict(),
            "system": self.system.to_dict(),
            "estimator": self.estimator.to_dict(),
            "n_requests": self.n_requests,
            "warmup": self.warmup,
            "ripple_from": self.ripple_from,
            "seed": self.seed,
        }

    @staticmethod
    def from_dict(d: dict) -> "Scenario":
        schema = d.get("schema", SCHEMA_VERSION)
        if schema != SCHEMA_VERSION:
            raise ValueError(f"unsupported scenario schema {schema}")
        return Scenario(
            name=d["name"],
            description=d.get("description", ""),
            workload=Workload.from_dict(d["workload"]),
            system=System.from_dict(d["system"]),
            estimator=Estimator.from_dict(d.get("estimator") or {}),
            n_requests=int(d.get("n_requests", 0)),
            warmup=d.get("warmup"),
            ripple_from=d.get("ripple_from"),
            seed=int(d.get("seed", 0)),
        )

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @staticmethod
    def from_json(s: str) -> "Scenario":
        return Scenario.from_dict(json.loads(s))

    def save(self, path) -> Path:
        path = Path(path)
        path.write_text(self.to_json() + "\n")
        return path

    @staticmethod
    def load(path) -> "Scenario":
        return Scenario.from_json(Path(path).read_text())
