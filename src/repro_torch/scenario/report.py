"""The unified result type every scenario run returns.

Whether hit probabilities come from a Monte-Carlo trajectory or from the
working-set fixed point, downstream code (benchmarks, tests, the
EXPERIMENTS.md generator) consumes one :class:`Report`: per-proxy and
per-object hit probabilities, demand-weighted hit rates, ripple/eviction
statistics (simulation only), and throughput. Reports serialize to plain
JSON dicts — that is what ``benchmarks/artifacts/`` records.

Field notes
-----------
* ``hit_prob`` is a dense ``(J, N)`` matrix, except for streaming
  Monte-Carlo runs where it is a
  :class:`~repro_torch.core.fastsim.SparseOccupancy` (indices, values) pair
  over the touched objects — ``dense_hit_prob()`` densifies when N is
  small, ``hit_prob_at_ranks`` probes without densifying.
* ``hit_rate`` (estimated from occupancy, PASTA) and
  ``realized_hit_rate`` (counted hits, Monte-Carlo only; NaN for
  zero-request proxies) are both demand-weighted per proxy.
* ``extras`` carries estimator- and path-specific payloads:
  ``streaming``/``chunk_size`` for streamed runs, solver diagnostics
  for working-set runs, and the full ``admission`` episode (decision
  log, virtual allocations, overbooking gain, predicted-vs-realized
  SLA hit rates) for ``System(admission=...)`` scenarios.
* ``ensemble`` (Monte-Carlo with ``Estimator(replications=R)``) carries
  the per-replica estimates — the main fields become cross-replica
  means and ``hit_prob_ci()`` / ``hit_rate_ci()`` /
  ``overall_hit_rate_ci()`` derive normal-approximation confidence
  bands from it.
* ``same_estimates`` is the round-trip identity check used by the
  JSON tests: estimates must match bit for bit (including the
  per-replica ensemble payload), timing fields are excluded (wall
  clock is not part of a result's identity).
"""

from __future__ import annotations

import statistics as _statistics
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.fastsim import SparseOccupancy


def _z_value(level: float) -> float:
    """Two-sided normal critical value for a confidence ``level``."""
    if not 0.0 < level < 1.0:
        raise ValueError("confidence level must be in (0, 1)")
    return _statistics.NormalDist().inv_cdf(0.5 + level / 2.0)


@dataclass
class ServingReport:
    """Serving-side translation of a block-trace run's counters.

    Built by the serving runner and stored as a plain dict in
    ``Report.extras["serving"]`` (read it back with
    :meth:`Report.serving`). All byte/FLOP figures use the workload's
    ``kv_arch`` KV layout and prefill pricing; with ``kv_arch=None``
    they are in block/"FLOP-unit" terms (1 block = 1 byte = 1 unit).
    """

    tenants: int                     # declared tenants T
    active_tenants: Tuple[int, ...]  # onboarded (all, without admission)
    blocks_per_request: int
    block_tokens: int
    bytes_per_block: float
    kv_arch: Optional[str]
    n_block_events: int              # driven block events (whole trace)
    n_serving_requests: float        # block events / blocks_per_request
    # hit economics
    prefix_hit_block_ratio: float    # resident-block ratio over the trace
    prefix_hit_token_ratio: float    # == block ratio (whole-block hits)
    prefill_tokens_saved: float
    flops_per_token: float
    prefill_flops_saved: float
    # sharing economics (expected, from steady-state occupancy)
    bytes_shared_lb: float           # sum_k l_k * max(0, sum_i occ - 1)
    unshared_equivalent_bytes: float  # sum_{i,k} occ * l_k
    final_virtual_bytes: Optional[Tuple[float, ...]]  # per tenant
    # latency proxy (single-chip roofline prefill of expected miss tokens)
    latency_mean_s: float
    latency_p99_s: float
    latency_cold_s: float            # fully-cold request (no cached prefix)
    admission: Optional[dict] = None  # onboarding episode, when gated

    def to_dict(self) -> dict:
        return {
            "tenants": int(self.tenants),
            "active_tenants": [int(t) for t in self.active_tenants],
            "blocks_per_request": int(self.blocks_per_request),
            "block_tokens": int(self.block_tokens),
            "bytes_per_block": float(self.bytes_per_block),
            "kv_arch": self.kv_arch,
            "n_block_events": int(self.n_block_events),
            "n_serving_requests": float(self.n_serving_requests),
            "prefix_hit_block_ratio": float(self.prefix_hit_block_ratio),
            "prefix_hit_token_ratio": float(self.prefix_hit_token_ratio),
            "prefill_tokens_saved": float(self.prefill_tokens_saved),
            "flops_per_token": float(self.flops_per_token),
            "prefill_flops_saved": float(self.prefill_flops_saved),
            "bytes_shared_lb": float(self.bytes_shared_lb),
            "unshared_equivalent_bytes": float(
                self.unshared_equivalent_bytes
            ),
            "final_virtual_bytes": (
                None
                if self.final_virtual_bytes is None
                else [float(v) for v in self.final_virtual_bytes]
            ),
            "latency_mean_s": float(self.latency_mean_s),
            "latency_p99_s": float(self.latency_p99_s),
            "latency_cold_s": float(self.latency_cold_s),
            "admission": self.admission,
        }


@dataclass
class Report:
    """Unified output of :meth:`repro_torch.scenario.Scenario.run`."""

    scenario: dict               # the spec that produced this report
    estimator: str               # "monte_carlo" | "working_set"
    backend: str                 # engine that ran ("c", "flat", "cuda", ..., "torch-ws")
    # (J, N) per-proxy per-object hit probability; streaming Monte-Carlo
    # runs carry a SparseOccupancy (indices, values) pair instead —
    # densify with ``dense_hit_prob()`` when N is small. Ensemble runs
    # (Estimator.replications > 1) carry the cross-replica mean here and
    # the per-replica estimates in ``ensemble``.
    hit_prob: "np.ndarray | SparseOccupancy"
    hit_rate: np.ndarray         # (J,) demand-weighted overall hit rate
    overall_hit_rate: float      # request-rate-weighted across proxies
    n_requests: int              # simulated requests (0 for working_set)
    warmup: int
    elapsed_s: float
    throughput_rps: float        # requests/sec through the engine (MC only)
    realized_hit_rate: Optional[np.ndarray] = None  # (J,) counted hits (MC)
    ripple: Optional[dict] = None       # eviction statistics (MC only)
    final_vlen: Optional[np.ndarray] = None
    converged: Optional[bool] = None    # working_set only
    # Ensemble payload (replications > 1): {"replications": R,
    # "batched": bool, "hit_rate": (R, J), "overall_hit_rate": (R,),
    # "realized_hit_rate": (R, J) | None, "hit_prob": (R, J, N) | None
    # (omitted for sparse/streaming runs)}. Main-field estimates are
    # the cross-replica means.
    ensemble: Optional[Dict[str, object]] = None
    extras: Dict[str, object] = field(default_factory=dict)

    # ------------------------------------------------------------------
    # Ensemble accessors (replications > 1)
    # ------------------------------------------------------------------
    @property
    def replications(self) -> int:
        """Ensemble size R (1 for a classic single-trajectory run)."""
        if self.ensemble is None:
            return 1
        return int(self.ensemble["replications"])

    def _require_ensemble(self, what: str) -> None:
        if self.ensemble is None or self.replications < 2:
            raise ValueError(
                f"{what} needs an ensemble run — rerun the scenario with "
                "Estimator(replications=R) for R >= 2"
            )

    def hit_rate_std(self) -> np.ndarray:
        """(J,) cross-replica sample std of the per-proxy hit rates."""
        self._require_ensemble("hit_rate_std()")
        return np.asarray(self.ensemble["hit_rate"], dtype=np.float64).std(
            axis=0, ddof=1
        )

    def hit_rate_ci(
        self, level: float = 0.95
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(mean, lo, hi) normal-approximation CI bands for the
        per-proxy hit rates (each (J,)) — the same shape every CI
        accessor returns."""
        self._require_ensemble("hit_rate_ci()")
        half = (
            _z_value(level)
            * self.hit_rate_std()
            / np.sqrt(self.replications)
        )
        return self.hit_rate, self.hit_rate - half, self.hit_rate + half

    def overall_hit_rate_ci(
        self, level: float = 0.95
    ) -> Tuple[float, float, float]:
        """(mean, lo, hi) for the overall demand-weighted hit rate."""
        self._require_ensemble("overall_hit_rate_ci()")
        vals = np.asarray(
            self.ensemble["overall_hit_rate"], dtype=np.float64
        )
        half = (
            _z_value(level) * vals.std(ddof=1) / np.sqrt(self.replications)
        )
        m = float(vals.mean())
        return m, m - half, m + half

    def hit_prob_std(self) -> np.ndarray:
        """(J, N) cross-replica sample std of per-object hit probs.

        Needs the stacked per-replica ``hit_prob`` in the ensemble
        payload — dropped when the densified ``(R, J, N)`` stack would
        exceed the runner's retention cap (huge-catalogue streaming
        runs), where only the per-proxy statistics are kept.
        """
        self._require_ensemble("hit_prob_std()")
        stack = self.ensemble.get("hit_prob")
        if stack is None:
            raise ValueError(
                "per-replica hit_prob was not retained (the (R, J, N) "
                "stack exceeds the runner's cap) — only per-proxy CI "
                "accessors are available"
            )
        return np.asarray(stack, dtype=np.float64).std(axis=0, ddof=1)

    def hit_prob_ci(
        self, level: float = 0.95
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(mean, lo, hi) per-(proxy, object) hit-probability bands,
        each (J, N) — normal approximation over the R replicas."""
        half = (
            _z_value(level)
            * self.hit_prob_std()
            / np.sqrt(self.replications)
        )
        mean = self.dense_hit_prob()
        return mean, mean - half, mean + half

    # ------------------------------------------------------------------
    @property
    def serving(self) -> Optional[dict]:
        """The serving-metrics payload (``extras["serving"]``), or None
        for non-serving scenarios. See :class:`ServingReport` for the
        field semantics."""
        return self.extras.get("serving")

    @property
    def hit_prob_is_sparse(self) -> bool:
        return isinstance(self.hit_prob, SparseOccupancy)

    def dense_hit_prob(self) -> np.ndarray:
        """The full ``(J, N)`` hit-probability matrix (materializes a
        sparse streaming result — use only when N is small)."""
        if isinstance(self.hit_prob, SparseOccupancy):
            return self.hit_prob.densify()
        return self.hit_prob

    def hit_prob_at_ranks(self, proxy: int, ranks) -> list:
        """Hit probabilities of rank-``r`` objects (1-based, paper style)."""
        if isinstance(self.hit_prob, SparseOccupancy):
            return [
                float(x)
                for x in self.hit_prob.lookup(proxy, [r - 1 for r in ranks])
            ]
        return [float(self.hit_prob[proxy, r - 1]) for r in ranks]

    def to_dict(self) -> dict:
        """JSON-serializable dict (numpy arrays become nested lists)."""
        if isinstance(self.hit_prob, SparseOccupancy):
            hit_prob = {
                "sparse": True,
                "n_objects": int(self.hit_prob.n_objects),
                "indices": self.hit_prob.indices.tolist(),
                "values": self.hit_prob.values.tolist(),
            }
        else:
            hit_prob = self.hit_prob.tolist()
        d = {
            "scenario": self.scenario,
            "estimator": self.estimator,
            "backend": self.backend,
            "hit_prob": hit_prob,
            "hit_rate": self.hit_rate.tolist(),
            "overall_hit_rate": float(self.overall_hit_rate),
            "n_requests": int(self.n_requests),
            "warmup": int(self.warmup),
            "elapsed_s": float(self.elapsed_s),
            "throughput_rps": float(self.throughput_rps),
            "realized_hit_rate": (
                None
                if self.realized_hit_rate is None
                else self.realized_hit_rate.tolist()
            ),
            "ripple": self.ripple,
            "final_vlen": (
                None if self.final_vlen is None else self.final_vlen.tolist()
            ),
            "converged": self.converged,
            "ensemble": (
                None
                if self.ensemble is None
                else {
                    k: (v.tolist() if isinstance(v, np.ndarray) else v)
                    for k, v in self.ensemble.items()
                }
            ),
            "extras": self.extras,
        }
        return d

    @staticmethod
    def from_dict(d: dict) -> "Report":
        def arr(x):
            return None if x is None else np.asarray(x, dtype=np.float64)

        hp = d["hit_prob"]
        if isinstance(hp, dict):
            hit_prob = SparseOccupancy(
                n_objects=int(hp["n_objects"]),
                indices=np.asarray(hp["indices"], dtype=np.int64),
                values=np.asarray(hp["values"], dtype=np.float64),
            )
        else:
            hit_prob = np.asarray(hp, dtype=np.float64)
        ens = d.get("ensemble")
        if ens is not None:
            ens = dict(ens)
            for key in (
                "hit_rate",
                "overall_hit_rate",
                "realized_hit_rate",
                "hit_prob",
            ):
                if ens.get(key) is not None:
                    ens[key] = np.asarray(ens[key], dtype=np.float64)
        return Report(
            scenario=d["scenario"],
            estimator=d["estimator"],
            backend=d["backend"],
            hit_prob=hit_prob,
            hit_rate=np.asarray(d["hit_rate"], dtype=np.float64),
            overall_hit_rate=float(d["overall_hit_rate"]),
            n_requests=int(d["n_requests"]),
            warmup=int(d["warmup"]),
            elapsed_s=float(d["elapsed_s"]),
            throughput_rps=float(d["throughput_rps"]),
            realized_hit_rate=arr(d.get("realized_hit_rate")),
            ripple=d.get("ripple"),
            final_vlen=arr(d.get("final_vlen")),
            converged=d.get("converged"),
            ensemble=ens,
            extras=d.get("extras") or {},
        )

    def same_estimates(self, other: "Report") -> bool:
        """True when the two reports carry identical estimates — the
        round-trip guarantee (timing fields are excluded: wall clock is
        not part of a result's identity)."""
        if self.estimator != other.estimator:
            return False
        a, b = self.hit_prob, other.hit_prob
        if isinstance(a, SparseOccupancy) or isinstance(b, SparseOccupancy):
            sparse = [x for x in (a, b) if isinstance(x, SparseOccupancy)]
            if len(sparse) == 2:
                if not (
                    a.n_objects == b.n_objects
                    and np.array_equal(a.indices, b.indices)
                    and np.array_equal(a.values, b.values)
                ):
                    return False
            else:
                # mixed dense/sparse: compare through densification
                da = a.densify() if isinstance(a, SparseOccupancy) else a
                db = b.densify() if isinstance(b, SparseOccupancy) else b
                if not np.array_equal(da, db):
                    return False
        elif not np.array_equal(a, b):
            return False
        if not np.array_equal(self.hit_rate, other.hit_rate):
            return False
        if self.realized_hit_rate is not None or other.realized_hit_rate is not None:
            if (
                self.realized_hit_rate is None
                or other.realized_hit_rate is None
                # equal_nan: zero-request proxies report NaN by contract
                or not np.array_equal(
                    self.realized_hit_rate,
                    other.realized_hit_rate,
                    equal_nan=True,
                )
            ):
                return False
        if (self.ensemble is None) != (other.ensemble is None):
            return False
        if self.ensemble is not None:
            a, b = self.ensemble, other.ensemble
            if int(a["replications"]) != int(b["replications"]):
                return False
            for key in (
                "hit_rate",
                "overall_hit_rate",
                "realized_hit_rate",
                "hit_prob",
            ):
                va, vb = a.get(key), b.get(key)
                if (va is None) != (vb is None):
                    return False
                if va is not None and not np.array_equal(
                    np.asarray(va, dtype=np.float64),
                    np.asarray(vb, dtype=np.float64),
                    equal_nan=True,
                ):
                    return False
        return self.ripple == other.ripple
