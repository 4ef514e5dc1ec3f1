"""The Workload axis of a :class:`repro_torch.scenario.Scenario`.

A :class:`Workload` declaratively describes the request process and the
object-size population that drive an experiment:

* ``kind="irm"`` — the paper's stationary Independent Reference Model:
  per-proxy Zipf popularity (heterogeneous ``alphas``, optional
  ``proxy_rates``) over one shared object ranking.
* ``kind="shot_noise"`` — non-stationary catalogue churn in the spirit of
  shot-noise traffic models (cf. Olmos et al., "Cache Miss Estimation for
  Non-Stationary Request Processes"): the per-proxy Zipf *profile* is
  fixed but the identity of the popular objects rotates by
  ``phase_shift`` ranks every ``phase_requests`` requests, so fresh
  objects keep displacing the head of the popularity curve.
* ``kind="trace"`` — explicit replay of a recorded (proxy, object)
  stream; request rates for the analytic estimator are recovered
  empirically from the trace itself.
* ``kind="tenant_churn"`` — a multi-tenant *episode* for the Section
  IV-C admission-control runner: each entry of ``alphas`` is one
  prospective tenant, and ``tenant_events`` is a stream of
  ``(round, "arrive" | "depart", tenant)`` events. Each round, the
  active tenants generate ``round_requests`` IRM requests that feed the
  operator's online popularity estimates. Requires
  ``System(admission=...)`` — the event stream is driven by the
  admission runner, not by ``sample()``.
* ``kind="serving"`` — multi-tenant LLM prompt streams compiled to a
  block trace (see :mod:`repro_torch.serving.trace`): each tenant (one entry
  of ``alphas`` = its Zipf exponent over a per-tenant prompt catalogue)
  draws prompts whose hottest ``shared_frac`` fraction are shared
  system-prompt/few-shot prefixes; every request expands to
  ``prefix_blocks + suffix_blocks`` chained block objects, so prefix
  residency runs on the fastsim backends. ``n_objects`` is *derived*
  from the geometry; ``n_requests`` counts block events. Lengths are
  whole blocks (unit); byte/FLOP metrics come from ``kv_arch``'s KV
  layout in ``Report.extras["serving"]``.

Object lengths come from a :class:`LengthSpec` (unit, fixed, Zipf-ranked,
lognormal, or explicit), sampled deterministically from the scenario
seed. Everything is JSON-serializable via ``to_dict``/``from_dict``.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field, replace
from functools import cached_property
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.irm import (
    IRMTrace,
    rate_matrix,
    sample_trace,
    sample_trace_chunks,
)
from repro_torch.serving.trace import (
    ServingLayout,
    compile_trace,
    iter_event_batches,
    serving_rates,
)

LENGTH_KINDS = ("unit", "fixed", "zipf", "lognormal", "explicit")
WORKLOAD_KINDS = ("irm", "shot_noise", "trace", "tenant_churn", "serving")
TENANT_ACTIONS = ("arrive", "depart")


@dataclass(frozen=True)
class LengthSpec:
    """Object-size population l_1..l_N.

    * ``unit`` — every object has length 1 (the paper's Section V setup).
    * ``fixed`` — every object has length ``value``.
    * ``zipf`` — length falls with popularity rank:
      ``l_k = clip(round(max_len * k^-beta), 1, max_len)`` (popular
      objects big — the adversarial case for sharing).
    * ``lognormal`` — i.i.d. ``round(exp(N(mu, sigma)))`` clipped to
      ``[1, max_len]``, seeded from the scenario seed.
    * ``explicit`` — ``values`` gives one length per object.
    """

    kind: str = "unit"
    value: int = 1
    beta: float = 0.5
    max_len: int = 8
    mu: float = 0.0
    sigma: float = 0.5
    values: Optional[Tuple[int, ...]] = None

    def __post_init__(self) -> None:
        if self.kind not in LENGTH_KINDS:
            raise ValueError(
                f"unknown length kind {self.kind!r}; options: {LENGTH_KINDS}"
            )
        if self.kind == "explicit" and not self.values:
            raise ValueError("explicit length spec needs values")

    def materialize(self, n_objects: int, seed: int) -> np.ndarray:
        """(N,) positive int64 lengths, deterministic in (spec, seed)."""
        if self.kind == "unit":
            return np.ones(n_objects, dtype=np.int64)
        if self.kind == "fixed":
            if self.value < 1:
                raise ValueError("fixed length must be positive")
            return np.full(n_objects, int(self.value), dtype=np.int64)
        if self.kind == "zipf":
            ranks = np.arange(1, n_objects + 1, dtype=np.float64)
            l = np.round(self.max_len * ranks ** (-self.beta))
            return np.clip(l, 1, self.max_len).astype(np.int64)
        if self.kind == "lognormal":
            rng = np.random.default_rng(seed ^ 0x5EED1E)
            l = np.round(np.exp(rng.normal(self.mu, self.sigma, n_objects)))
            return np.clip(l, 1, self.max_len).astype(np.int64)
        values = np.asarray(self.values, dtype=np.int64)
        if len(values) != n_objects:
            raise ValueError(
                f"explicit lengths: {len(values)} values for {n_objects} objects"
            )
        if (values < 1).any():
            raise ValueError("object lengths must be positive")
        return values


@dataclass(frozen=True)
class Workload:
    """Declarative request process over ``n_objects`` shared objects.

    Fields
    ------
    kind:
        ``irm``, ``shot_noise``, ``trace``, or ``tenant_churn`` (see the
        module docstring for the semantics of each).
    n_objects:
        Catalogue size N; all proxies draw from the same object ranking
        (that is what makes objects shareable).
    alphas:
        Per-proxy Zipf exponents — one entry per proxy (``irm`` /
        ``shot_noise``) or per prospective tenant (``tenant_churn``).
    proxy_rates:
        Optional per-proxy total request-rate scaling (default: every
        proxy has rate 1, the paper's normalized setting).
    lengths:
        Object-size population (:class:`LengthSpec`), sampled
        deterministically from the scenario seed.
    phase_requests / phase_shift:
        ``shot_noise`` only — stationary-phase length (requests) and
        per-phase popularity-rank rotation.
    trace_proxies / trace_objects / trace_proxy_count:
        ``trace`` replay only — the recorded (proxy, object) stream;
        ``trace_proxy_count`` declares the true number of proxies when
        the highest-numbered ones are silent in the recording (default:
        max observed id + 1).
    tenant_events:
        ``tenant_churn`` only — tuple of ``(round, action, tenant)``
        events with ``action`` in ``("arrive", "depart")``; defaults to
        every tenant arriving at round 0. Each tenant arrives at most
        once and may depart at most once, strictly after its arrival
        round.
    round_requests:
        ``tenant_churn`` only — estimation requests sampled from the
        active tenants each round (the traffic the operator's
        :class:`~repro_torch.core.irm.PopularityEstimator` sees).
    n_prompts / shared_frac / prefix_blocks / suffix_blocks /
    suffix_choices:
        ``serving`` only — per-tenant prompt-catalogue size, fraction of
        it (the head ranks) drawn from the shared prefix pool, blocks
        per prompt-prefix chain, blocks per user-suffix tail, and the
        finite per-(tenant, prompt) suffix population. ``n_objects`` is
        derived from this geometry (every block-aligned chain position
        is one object); construction overwrites whatever was passed.
    kv_arch / block_tokens:
        ``serving`` only — model architecture name (``repro_torch.configs``)
        and tokens per KV block, used by the serving report to price
        blocks in bytes (``kv_layout``) and cached tokens in prefill
        FLOPs. ``kv_arch=None`` keeps unit pricing (1 block = 1 byte =
        1 FLOP-unit).
    """

    kind: str = "irm"
    n_objects: int = 1000
    alphas: Tuple[float, ...] = (0.75, 0.5, 1.0)
    proxy_rates: Optional[Tuple[float, ...]] = None
    lengths: LengthSpec = field(default_factory=LengthSpec)
    # shot_noise only: stationary-phase length and per-phase rank rotation
    phase_requests: int = 0
    phase_shift: int = 0
    # trace replay only; trace_proxy_count declares the true number of
    # proxies when the highest-numbered ones are silent in the recording
    # (default: max observed id + 1)
    trace_proxies: Optional[Tuple[int, ...]] = None
    trace_objects: Optional[Tuple[int, ...]] = None
    trace_proxy_count: Optional[int] = None
    # tenant_churn only: (round, action, tenant) events + estimation
    # traffic per round
    tenant_events: Optional[Tuple[Tuple[int, str, int], ...]] = None
    round_requests: int = 0
    # serving only: prompt-stream geometry (n_objects is derived)
    n_prompts: int = 0
    shared_frac: float = 0.0
    prefix_blocks: int = 0
    suffix_blocks: int = 0
    suffix_choices: int = 1
    kv_arch: Optional[str] = None
    block_tokens: int = 16

    def __post_init__(self) -> None:
        if self.kind not in WORKLOAD_KINDS:
            raise ValueError(
                f"unknown workload kind {self.kind!r}; options: {WORKLOAD_KINDS}"
            )
        if self.n_objects < 1:
            raise ValueError("need at least one object")
        if self.kind == "shot_noise" and (
            self.phase_requests < 1 or self.phase_shift < 1
        ):
            raise ValueError(
                "shot_noise needs phase_requests >= 1 and phase_shift >= 1"
            )
        if self.kind == "tenant_churn":
            if self.round_requests < 1:
                raise ValueError("tenant_churn needs round_requests >= 1")
            self._check_tenant_events()
        if self.kind == "serving":
            if self.lengths.kind != "unit":
                raise ValueError(
                    "serving workloads account in whole KV blocks (unit "
                    "lengths); byte metrics come from kv_arch's layout "
                    "in the serving report"
                )
            if self.kv_arch is not None:
                from repro_torch.configs import get_config

                get_config(self.kv_arch)   # raises on unknown arch
                if self.block_tokens < 1:
                    raise ValueError("block_tokens must be >= 1")
            # geometry validation + the derived catalogue size
            object.__setattr__(
                self, "n_objects", self.serving_layout().n_objects
            )
        if self.kind == "trace":
            if self.trace_proxies is None or self.trace_objects is None:
                raise ValueError("trace workload needs trace_proxies/objects")
            if len(self.trace_proxies) != len(self.trace_objects):
                raise ValueError("trace proxies/objects length mismatch")
            # Range-check here, not in the engines: the C drive loop
            # indexes raw ids without bounds checks, so a corrupt
            # artifact must be rejected at construction. (The upper
            # proxy bound is the system's to enforce — Scenario matches
            # n_proxies against the allocation vector.)
            if self.trace_proxies and min(self.trace_proxies) < 0:
                raise ValueError("trace proxy ids must be nonnegative")
            if self.trace_objects and not (
                0 <= min(self.trace_objects)
                and max(self.trace_objects) < self.n_objects
            ):
                raise ValueError(
                    f"trace object ids must be in [0, {self.n_objects})"
                )
            if self.trace_proxy_count is not None:
                observed = (
                    max(self.trace_proxies) + 1 if self.trace_proxies else 0
                )
                if self.trace_proxy_count < observed:
                    raise ValueError(
                        f"trace_proxy_count={self.trace_proxy_count} < "
                        f"{observed} observed proxies"
                    )
        elif not self.alphas:
            raise ValueError("need at least one proxy alpha")

    def _check_tenant_events(self) -> None:
        """Validate the tenant_churn event stream at construction."""
        T = len(self.alphas)
        arrived: Dict[int, int] = {}
        departed: Dict[int, int] = {}
        for ev in self.events():
            r, action, tenant = ev
            if action not in TENANT_ACTIONS:
                raise ValueError(
                    f"unknown tenant action {action!r}; "
                    f"options: {TENANT_ACTIONS}"
                )
            if not 0 <= tenant < T:
                raise ValueError(
                    f"tenant id {tenant} out of range [0, {T})"
                )
            if r < 0:
                raise ValueError("event rounds must be nonnegative")
            if action == "arrive":
                if tenant in arrived:
                    raise ValueError(f"tenant {tenant} arrives twice")
                arrived[tenant] = r
            else:
                if tenant in departed:
                    raise ValueError(f"tenant {tenant} departs twice")
                # strictly after the arrival round: a same-round pair
                # would be reordered by events_by_round (departures
                # first) and the departure silently dropped.
                if tenant not in arrived or r <= arrived[tenant]:
                    raise ValueError(
                        f"tenant {tenant} must depart in a later round "
                        "than it arrives"
                    )
                departed[tenant] = r

    # ------------------------------------------------------------------
    @property
    def n_proxies(self) -> int:
        if self.kind == "trace":
            if self.trace_proxy_count is not None:
                return int(self.trace_proxy_count)
            return int(max(self.trace_proxies)) + 1 if self.trace_proxies else 1
        return len(self.alphas)

    # -- serving geometry ----------------------------------------------
    def serving_layout(self) -> ServingLayout:
        """Object-space geometry of a ``serving`` workload (validates)."""
        if self.kind != "serving":
            raise ValueError(f"not a serving workload: kind={self.kind!r}")
        return ServingLayout(
            n_tenants=len(self.alphas),
            n_prompts=self.n_prompts,
            shared_frac=self.shared_frac,
            prefix_blocks=self.prefix_blocks,
            suffix_blocks=self.suffix_blocks,
            suffix_choices=self.suffix_choices,
        )

    # -- tenant_churn episode structure --------------------------------
    def events(self) -> Tuple[Tuple[int, str, int], ...]:
        """The normalized tenant-event stream, sorted by round (stable:
        ties keep their declared order). Default: every tenant arrives
        at round 0."""
        if self.tenant_events is None:
            return tuple((0, "arrive", t) for t in range(len(self.alphas)))
        return tuple(
            sorted(
                ((int(r), a, int(t)) for r, a, t in self.tenant_events),
                key=lambda ev: ev[0],
            )
        )

    @property
    def n_rounds(self) -> int:
        """Number of episode rounds (last event round + 1)."""
        evs = self.events()
        return (max(ev[0] for ev in evs) + 1) if evs else 0

    def events_by_round(self) -> Dict[int, List[Tuple[str, int]]]:
        """{round: [(action, tenant), ...]} with departures ordered
        before arrivals inside each round (departures free headroom the
        same-round arrivals may need)."""
        out: Dict[int, List[Tuple[str, int]]] = {}
        for r, action, tenant in self.events():
            out.setdefault(r, []).append((action, tenant))
        for evs in out.values():
            evs.sort(key=lambda e: 0 if e[0] == "depart" else 1)
        return out

    def rates(self) -> np.ndarray:
        """(J, N) stationary request-rate matrix.

        For ``irm`` this is the exact Zipf rate matrix; for ``trace`` the
        empirical per-(proxy, object) request frequencies; ``shot_noise``
        has no single stationary matrix — use :meth:`mean_rates`. The
        matrix is computed once per Workload instance and cached (the
        runner needs it both to sample the trace and to weight hit
        rates; at Fig.-2 scale it is a 9x1e6 array). Treat it as
        read-only.
        """
        return self._rates

    @cached_property
    def _rates(self) -> np.ndarray:
        if self.kind == "trace":
            return self._empirical_rates(len(self.trace_proxies))
        if self.kind == "serving":
            return serving_rates(
                self.serving_layout(), self.alphas, self.proxy_rates
            )
        return rate_matrix(self.n_objects, list(self.alphas), self.proxy_rates)

    def _empirical_rates(self, n: int) -> np.ndarray:
        """Per-(proxy, object) request frequencies over the first ``n``
        requests of the embedded trace."""
        J, N = self.n_proxies, self.n_objects
        lam = np.zeros((J, N), dtype=np.float64)
        np.add.at(
            lam,
            (
                np.asarray(self.trace_proxies[:n]),
                np.asarray(self.trace_objects[:n]),
            ),
            1.0,
        )
        return lam / max(n, 1)

    def mean_rates(self, n_requests: int) -> np.ndarray:
        """Time-average (J, N) rate matrix over ``n_requests`` requests.

        Equals :meth:`rates` for the stationary IRM. For ``trace`` it
        counts frequencies over exactly the replayed prefix (a replay of
        half the trace is weighted by the mix it actually saw). For
        ``shot_noise`` it averages the rotated per-phase matrices — the
        input the working-set estimator sees (it approximates the churn
        by its long-run popularity mixture).
        """
        if self.kind == "trace":
            n = min(n_requests, len(self.trace_proxies))
            if n == len(self.trace_proxies):
                return self.rates()
            return self._empirical_rates(n)
        lam = self.rates()
        if self.kind != "shot_noise":
            return lam
        n_requests = max(n_requests, 1)
        n_phases = -(-n_requests // self.phase_requests)
        N = self.n_objects
        acc = np.zeros_like(lam)
        for p in range(n_phases):
            # duration-weighted: the last phase may be partial
            dur = min(self.phase_requests, n_requests - p * self.phase_requests)
            acc += (dur / n_requests) * np.roll(
                lam, (p * self.phase_shift) % N, axis=1
            )
        return acc

    # ------------------------------------------------------------------
    def _rotate(self, objects: np.ndarray, start: int) -> np.ndarray:
        """Apply the shot-noise per-phase rank rotation in place."""
        phases = (start + np.arange(len(objects))) // self.phase_requests
        return (objects + phases * self.phase_shift) % self.n_objects

    def sample(self, n_requests: int, seed: int) -> IRMTrace:
        """Materialize a merged trace of ``n_requests`` requests.

        The most recent (n_requests, seed) draw is cached on the
        instance, so sweeps that rerun many systems over one shared
        workload (e.g. ``benchmarks/bench_rre.py``) sample once. Treat
        the returned trace as read-only.
        """
        key = (n_requests, seed)
        if self.__dict__.get("_trace_key") == key:
            return self.__dict__["_trace_val"]
        t = self._sample(n_requests, seed)
        self.__dict__["_trace_key"] = key
        self.__dict__["_trace_val"] = t
        return t

    def _sample(self, n_requests: int, seed: int) -> IRMTrace:
        if self.kind == "tenant_churn":
            raise ValueError(
                "tenant_churn workloads are driven round-by-round by the "
                "admission runner (System(admission=...)); they have no "
                "single merged trace"
            )
        if self.kind == "trace":
            P = np.asarray(self.trace_proxies, dtype=np.int32)
            O = np.asarray(self.trace_objects, dtype=np.int64)
            if n_requests > len(P):
                raise ValueError(
                    f"trace has {len(P)} requests, {n_requests} asked"
                )
            return IRMTrace(P[:n_requests], O[:n_requests])
        if self.kind == "serving":
            p, o = compile_trace(
                self.serving_layout(), self.alphas, self.proxy_rates,
                n_requests, seed,
            )
            return IRMTrace(p, o)
        t = sample_trace(self.rates(), n_requests, seed=seed)
        if self.kind == "shot_noise":
            return IRMTrace(t.proxies, self._rotate(t.objects, 0))
        return t

    def iter_chunks(
        self, n_requests: int, seed: int, *, chunk_size: int = 1_000_000
    ) -> Iterator[IRMTrace]:
        """Stream the same trace as :meth:`sample` in bounded-memory
        chunks (see :func:`repro_torch.core.irm.sample_trace_chunks`)."""
        if self.kind == "tenant_churn":
            raise ValueError(
                "tenant_churn workloads are driven round-by-round by the "
                "admission runner; they have no single merged trace"
            )
        if self.kind == "trace":
            P = np.asarray(self.trace_proxies, dtype=np.int32)
            O = np.asarray(self.trace_objects, dtype=np.int64)
            if n_requests > len(P):
                raise ValueError(
                    f"trace has {len(P)} requests, {n_requests} asked"
                )
            for s in range(0, n_requests, chunk_size):
                e = min(s + chunk_size, n_requests)
                yield IRMTrace(P[s:e], O[s:e])
            return
        if self.kind == "serving":
            # re-slice the canonical request batches to chunk_size: the
            # stream is identical to sample() whatever the chunking.
            buf_p: List[np.ndarray] = []
            buf_o: List[np.ndarray] = []
            buffered = 0
            for p, o in iter_event_batches(
                self.serving_layout(), self.alphas, self.proxy_rates,
                n_requests, seed,
            ):
                buf_p.append(p)
                buf_o.append(o)
                buffered += len(p)
                while buffered >= chunk_size:
                    P = np.concatenate(buf_p)
                    O = np.concatenate(buf_o)
                    yield IRMTrace(P[:chunk_size], O[:chunk_size])
                    buf_p, buf_o = [P[chunk_size:]], [O[chunk_size:]]
                    buffered -= chunk_size
            if buffered:
                yield IRMTrace(np.concatenate(buf_p), np.concatenate(buf_o))
            return
        start = 0
        for chunk in sample_trace_chunks(
            self.rates(), n_requests, chunk_size=chunk_size, seed=seed
        ):
            if self.kind == "shot_noise":
                chunk = IRMTrace(
                    chunk.proxies, self._rotate(chunk.objects, start)
                )
            start += len(chunk)
            yield chunk

    def object_lengths(self, seed: int) -> np.ndarray:
        return self.lengths.materialize(self.n_objects, seed)

    # ------------------------------------------------------------------
    def scaled(self, requests: float, catalogue: float) -> "Workload":
        """Scale the catalogue (and phase length, with requests)."""
        kw = {}
        if catalogue != 1.0 and self.kind == "serving":
            # n_objects is derived; the catalogue knob is the prompt pool
            kw["n_prompts"] = max(1, round(self.n_prompts * catalogue))
        elif catalogue != 1.0 and self.kind != "trace":
            if self.lengths.kind == "explicit":
                raise ValueError(
                    "cannot catalogue-scale a workload with explicit "
                    "per-object lengths; resample the length vector at "
                    "the new size instead"
                )
            kw["n_objects"] = max(1, round(self.n_objects * catalogue))
            if self.kind == "shot_noise":
                kw["phase_shift"] = max(1, round(self.phase_shift * catalogue))
        if requests != 1.0 and self.kind == "shot_noise":
            kw["phase_requests"] = max(
                1, round(self.phase_requests * requests)
            )
        if requests != 1.0 and self.kind == "tenant_churn":
            kw["round_requests"] = max(
                1, round(self.round_requests * requests)
            )
        return replace(self, **kw) if kw else self

    def to_dict(self) -> dict:
        d = asdict(self)
        d["lengths"] = asdict(self.lengths)
        return d

    @staticmethod
    def from_dict(d: dict) -> "Workload":
        d = dict(d)
        lengths = d.pop("lengths", None) or {}
        if lengths.get("values") is not None:
            lengths["values"] = tuple(lengths["values"])
        for key in ("alphas", "proxy_rates", "trace_proxies", "trace_objects"):
            if d.get(key) is not None:
                d[key] = tuple(d[key])
        if d.get("tenant_events") is not None:
            d["tenant_events"] = tuple(
                (int(r), str(a), int(t)) for r, a, t in d["tenant_events"]
            )
        return Workload(lengths=LengthSpec(**lengths), **d)
