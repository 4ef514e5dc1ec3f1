"""Independent Reference Model (IRM) request streams with Zipf popularity.

The paper's Section V experiments draw per-proxy requests under the IRM:
proxy ``i`` requests object ``k`` with probability ``lambda_{i,k}``
proportional to ``1 / k^{alpha_i}`` (each proxy has its own Zipf exponent
but the *same* object ranking — that is what makes objects shareable).

Trace generation is vectorized numpy (inverse-CDF sampling); popularity
estimation is a simple empirical-rate counter used by the admission
controller (Section IV-C: "once admitted, the object popularities can be
estimated and fed into our working-set approximation").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np


def zipf_popularities(n_objects: int, alpha: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 1..N: p_k ∝ 1/k^alpha, sum = 1."""
    ranks = np.arange(1, n_objects + 1, dtype=np.float64)
    w = ranks ** (-float(alpha))
    return w / w.sum()


def rate_matrix(
    n_objects: int,
    alphas: Sequence[float],
    proxy_rates: Optional[Sequence[float]] = None,
) -> np.ndarray:
    """``lambda[i, k]``: request rate of object k by proxy i.

    ``proxy_rates`` scales each proxy's total rate (default: 1 each, the
    paper's setting — rates normalized per proxy).
    """
    J = len(alphas)
    if proxy_rates is None:
        proxy_rates = [1.0] * J
    lam = np.stack([zipf_popularities(n_objects, a) for a in alphas])
    return lam * np.asarray(proxy_rates, dtype=np.float64)[:, None]


@dataclass
class IRMTrace:
    """A merged multi-proxy IRM trace: arrays of (proxy, object) pairs."""

    proxies: np.ndarray  # (M,) int32
    objects: np.ndarray  # (M,) int64, 0-based object ids (rank-1 == id 0)

    def __len__(self) -> int:
        return len(self.proxies)

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        return zip(self.proxies.tolist(), self.objects.tolist())


def _flat_cdf(lam: np.ndarray) -> np.ndarray:
    """CDF over the flattened (proxy, object) cells of the rate matrix.

    ``P(cell i*N+k) = lam[i,k] / lam.sum()`` factorizes as P(proxy) *
    P(object | proxy), so one ``searchsorted`` over this CDF draws the
    merged-trace pair in a single vectorized pass (no per-proxy loop).
    """
    flat = np.asarray(lam, dtype=np.float64).ravel()
    if flat.size == 0 or np.any(flat < 0) or flat.sum() <= 0:
        raise ValueError("rate matrix must be nonnegative with positive sum")
    cdf = np.cumsum(flat)
    cdf /= cdf[-1]
    cdf[-1] = 1.0
    return cdf


def sample_trace_chunks(
    lam: np.ndarray,
    n_requests: int,
    *,
    chunk_size: int = 1_000_000,
    seed: int = 0,
) -> Iterator[IRMTrace]:
    """Stream a merged IRM trace as :class:`IRMTrace` chunks.

    Identical request stream to :func:`sample_trace` with the same seed
    (successive uniform draws from one ``default_rng`` concatenate to the
    one-shot draw), but peak memory is O(chunk_size) instead of
    O(n_requests) — the ROADMAP Section VI-C memory item for N >> 1e6
    catalogues where the full trace would not fit.
    """
    if chunk_size < 1:
        raise ValueError("chunk_size must be positive")
    lam = np.asarray(lam, dtype=np.float64)
    J, N = lam.shape
    cdf = _flat_cdf(lam)
    rng = np.random.default_rng(seed)
    done = 0
    while done < n_requests:
        m = min(chunk_size, n_requests - done)
        idx = np.searchsorted(cdf, rng.random(m), side="right")
        np.clip(idx, 0, J * N - 1, out=idx)
        yield IRMTrace(
            proxies=(idx // N).astype(np.int32),
            objects=(idx % N).astype(np.int64),
        )
        done += m


def sample_trace(
    lam: np.ndarray,
    n_requests: int,
    seed: int = 0,
) -> IRMTrace:
    """Sample a merged IRM trace of ``n_requests`` from rate matrix ``lam``.

    Poisson-merged: each request comes from proxy i w.p. proportional to
    its total rate, then the object is drawn from proxy i's popularity —
    drawn jointly via one inverse-CDF ``searchsorted`` over the flattened
    (proxy, object) cells: O(M log(J*N)), fully vectorized, no per-proxy
    Python loop. Use :func:`sample_trace_chunks` to stream the same trace
    without materializing all M requests at once.
    """
    lam = np.asarray(lam, dtype=np.float64)
    J, N = lam.shape
    cdf = _flat_cdf(lam)
    rng = np.random.default_rng(seed)
    idx = np.searchsorted(cdf, rng.random(n_requests), side="right")
    np.clip(idx, 0, J * N - 1, out=idx)
    return IRMTrace(
        proxies=(idx // N).astype(np.int32),
        objects=(idx % N).astype(np.int64),
    )


class PopularityEstimator:
    """Online empirical request-rate estimator (per proxy × object).

    ``lam_hat[i, k] = count[i, k] / n[i]`` — the admission controller
    feeds this into the working-set solver (Section IV-C: "once admitted,
    the object popularities can be estimated and fed into our working-set
    approximation").

    The estimator is designed for *online* operation under tenant churn:

    * :meth:`observe` / :meth:`observe_trace` fold new requests in
      incrementally (counts accumulate across calls);
    * :meth:`decay` exponentially forgets old traffic, so the estimate
      tracks non-stationary popularity instead of averaging over the
      whole history;
    * :meth:`reset_proxy` clears one tenant's row when it departs, so a
      later re-admission under the same proxy id starts fresh.

    Counts are float64 so decayed (fractional) counts stay exact.
    """

    def __init__(self, n_proxies: int, n_objects: int) -> None:
        self.counts = np.zeros((n_proxies, n_objects), dtype=np.float64)
        self.totals = np.zeros(n_proxies, dtype=np.float64)

    def observe(self, proxy: int, obj: int) -> None:
        self.counts[proxy, obj] += 1
        self.totals[proxy] += 1

    def observe_trace(self, trace: IRMTrace) -> None:
        np.add.at(self.counts, (trace.proxies, trace.objects), 1)
        np.add.at(self.totals, trace.proxies, 1)

    def decay(self, factor: float) -> None:
        """Exponential forgetting: scale all counts by ``factor``.

        Called once per estimation window, ``factor = gamma`` gives each
        window weight ``gamma^age`` — the standard EWMA popularity
        tracker for non-stationary demand (cf. shot-noise churn).
        """
        if not 0.0 <= factor <= 1.0:
            raise ValueError("decay factor must be in [0, 1]")
        self.counts *= factor
        self.totals *= factor

    def reset_proxy(self, proxy: int) -> None:
        """Forget everything observed for one proxy (tenant departure)."""
        self.counts[proxy, :] = 0.0
        self.totals[proxy] = 0.0

    def rates(self, laplace: float = 0.0) -> np.ndarray:
        """Estimated per-request rates, optionally Laplace-smoothed.

        Rows are normalized by the **true** (possibly decayed) total, so
        every observed row sums to exactly 1 whatever :meth:`decay`
        schedule preceded it. The previous ``max(totals, 1)`` guard
        silently deflated rows once EWMA forgetting pushed a tenant's
        total weight below 1 (100 observations after 60 rounds of
        ``decay(0.9)`` leave a total of ~0.18, i.e. rates summing to
        0.18) — deep in that regime the eq. (10) working-set solve
        degenerates (the bracketed characteristic time blows up as
        1/total) and virtual footprints collapse toward zero, making
        the eq. (13) admission test over-admit. Only the all-zero row
        (nothing observed, or fully reset) keeps a guard and reports
        uniformly zero rates.
        """
        J, N = self.counts.shape
        if laplace > 0.0:
            # Smoothed rows always normalize (an unobserved row is the
            # uniform prior 1/N) — the denominator is strictly positive.
            return (self.counts + laplace) / (
                self.totals[:, None] + laplace * N
            )
        tot = np.where(self.totals > 0.0, self.totals, 1.0)[:, None]
        return self.counts / tot
