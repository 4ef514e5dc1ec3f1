"""Serving workload -> (proxy, object) block-trace compiler.

The declarative model behind ``Workload(kind="serving")``: T tenants
(the paper's proxies) send prompt streams. Each prompt is a chain of
block-aligned prefix extensions — exactly the objects
:class:`~repro_torch.cacheblocks.prefix_cache.SharedPrefixCache` keys by
rolling hash — followed by a per-(tenant, prompt) user-suffix tail:

* every tenant draws from a catalogue of ``n_prompts`` prompts under
  its own Zipf popularity (rank r gets weight ``r**-alpha``);
* the hottest ``round(shared_frac * n_prompts)`` catalogue entries are
  **shared** system-prompt/few-shot prefixes: all tenants referencing
  shared entry r produce the *same* chain of prefix objects, so their
  blocks collide into shareable objects (the paper's ``|P(n)| > 1``);
* the remaining entries are tenant-private prompts (distinct chains,
  never shared);
* each request extends its prompt's ``prefix_blocks``-block prefix with
  ``suffix_blocks`` blocks of user suffix, drawn uniformly from a
  finite per-(tenant, prompt) population of ``suffix_choices`` tails
  (suffixes are tenant-private by construction).

**Compilation** maps every chain position to a dense integer object id
such that two chain positions get the same id iff their full token
prefixes are equal — the bijection the equivalence tests verify against
the reference cache's chained hashes. One request becomes
``blocks_per_request = prefix_blocks + suffix_blocks`` consecutive
(proxy, object) events in chain order, so residency can be driven
through the ``fastsim`` backends at millions of requests per second.

Sampling is **canonically batched**: the request stream is generated in
fixed-size batches, each seeded independently from ``(seed, batch)``,
so any chunking of the event stream (``sample`` vs ``iter_chunks`` at
any ``chunk_size``) reproduces the identical trace bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Iterator, Sequence, Tuple

import numpy as np

# Requests per canonical sampling batch. Fixed forever: changing it
# changes every sampled serving trace under a given seed.
REQUEST_BATCH = 65536


@dataclass(frozen=True)
class ServingLayout:
    """Static geometry of a serving workload's object space."""

    n_tenants: int
    n_prompts: int                # catalogue entries per tenant
    shared_frac: float            # head fraction of the catalogue shared
    prefix_blocks: int            # blocks per prompt prefix chain
    suffix_blocks: int            # blocks per user-suffix tail
    suffix_choices: int           # finite suffix population per prompt

    def __post_init__(self) -> None:
        if self.n_tenants < 1 or self.n_prompts < 1:
            raise ValueError("need at least one tenant and one prompt")
        if not 0.0 <= self.shared_frac <= 1.0:
            raise ValueError(f"shared_frac {self.shared_frac} not in [0, 1]")
        if self.prefix_blocks < 1:
            raise ValueError("prefix_blocks must be >= 1")
        if self.suffix_blocks < 0 or self.suffix_choices < 1:
            raise ValueError("suffix_blocks >= 0, suffix_choices >= 1")

    # -- derived geometry ------------------------------------------------
    @property
    def n_shared(self) -> int:
        return int(round(self.shared_frac * self.n_prompts))

    @property
    def n_private(self) -> int:
        return self.n_prompts - self.n_shared

    @property
    def blocks_per_request(self) -> int:
        return self.prefix_blocks + self.suffix_blocks

    @property
    def n_prefix_objects(self) -> int:
        chains = self.n_shared + self.n_tenants * self.n_private
        return chains * self.prefix_blocks

    @property
    def n_suffix_objects(self) -> int:
        return (self.n_tenants * self.n_prompts * self.suffix_choices
                * self.suffix_blocks)

    @property
    def n_objects(self) -> int:
        return self.n_prefix_objects + self.n_suffix_objects

    # -- object-id mapping ----------------------------------------------
    # Shared entry r (< n_shared), depth d:   r * P + d
    # Private entry r of tenant t:            (n_shared + t*n_private +
    #                                          (r - n_shared)) * P + d
    # Suffix (t, r, c), depth e:  n_prefix_objects +
    #                             ((t*n_prompts + r)*suffix_choices + c)
    #                              * suffix_blocks + e
    # Every id determines its full chain, which is what makes the dense
    # ids equivalent to the reference cache's chained prefix hashes.

    def prefix_chain_start(self, tenants: np.ndarray,
                           entries: np.ndarray) -> np.ndarray:
        """Object id of depth-0 prefix block per (tenant, entry)."""
        t = np.asarray(tenants, dtype=np.int64)
        r = np.asarray(entries, dtype=np.int64)
        shared = r < self.n_shared
        chain = np.where(
            shared, r,
            self.n_shared + t * self.n_private + (r - self.n_shared),
        )
        return chain * self.prefix_blocks

    def suffix_chain_start(self, tenants: np.ndarray, entries: np.ndarray,
                           choices: np.ndarray) -> np.ndarray:
        """Object id of depth-0 suffix block per (tenant, entry, choice)."""
        t = np.asarray(tenants, dtype=np.int64)
        r = np.asarray(entries, dtype=np.int64)
        c = np.asarray(choices, dtype=np.int64)
        idx = (t * self.n_prompts + r) * self.suffix_choices + c
        return self.n_prefix_objects + idx * self.suffix_blocks

    def request_objects(self, tenants: np.ndarray, entries: np.ndarray,
                        choices: np.ndarray) -> np.ndarray:
        """(n, blocks_per_request) object ids in chain order."""
        p0 = self.prefix_chain_start(tenants, entries)[:, None]
        cols = [p0 + np.arange(self.prefix_blocks, dtype=np.int64)]
        if self.suffix_blocks:
            s0 = self.suffix_chain_start(tenants, entries, choices)[:, None]
            cols.append(s0 + np.arange(self.suffix_blocks, dtype=np.int64))
        return np.concatenate(cols, axis=1)

    def request_tokens(self, tenant: int, entry: int, choice: int,
                       block_tokens: int) -> np.ndarray:
        """Token ids realizing one request for the reference cache.

        Block j of the chain carries ``block_tokens`` copies of its
        object id, so equal chains produce equal token prefixes (equal
        rolling-hash keys) and diverging chains diverge at the first
        differing block — the id <-> key bijection the equivalence
        tests rely on."""
        objs = self.request_objects(
            np.array([tenant]), np.array([entry]), np.array([choice])
        )[0]
        return np.repeat(objs, block_tokens)


def popularity(layout: ServingLayout,
               alphas: Sequence[float]) -> np.ndarray:
    """(T, n_prompts) per-tenant Zipf catalogue popularities.

    Rank r (0-based) gets weight ``(r+1)**-alpha_t``; rows sum to 1.
    Shared entries occupy the head ranks, so overlapping tenants share
    their *hottest* prompts."""
    if len(alphas) != layout.n_tenants:
        raise ValueError(
            f"{len(alphas)} alphas for {layout.n_tenants} tenants"
        )
    ranks = np.arange(1, layout.n_prompts + 1, dtype=np.float64)
    w = ranks[None, :] ** -np.asarray(alphas, dtype=np.float64)[:, None]
    return w / w.sum(axis=1, keepdims=True)


def _mix_weights(layout: ServingLayout,
                 mix: Sequence[float] | None) -> np.ndarray:
    if mix is None:
        m = np.full(layout.n_tenants, 1.0 / layout.n_tenants)
    else:
        m = np.asarray(mix, dtype=np.float64)
        if m.shape != (layout.n_tenants,):
            raise ValueError(
                f"mix shape {m.shape} != ({layout.n_tenants},)"
            )
        if (m < 0).any() or m.sum() <= 0:
            raise ValueError("mix weights must be nonnegative, sum > 0")
        m = m / m.sum()
    return m


def serving_rates(layout: ServingLayout, alphas: Sequence[float],
                  mix: Sequence[float] | None = None) -> np.ndarray:
    """Stationary per-event (tenant, object) request-rate matrix.

    Each request is ``blocks_per_request`` events, so a prefix object at
    (entry r, any depth) carries ``share_t * p_r / B`` of tenant t's
    event mass and each suffix object ``share_t * p_r / (choices * B)``.
    Rows sum to the tenant's traffic share — the exact IRM marginal of
    the compiled event stream, which is what the working-set estimator
    and demand-weighted hit rates consume."""
    T, B = layout.n_tenants, layout.blocks_per_request
    share = _mix_weights(layout, mix)
    p = popularity(layout, alphas)
    lam = np.zeros((T, layout.n_objects), dtype=np.float64)
    entries = np.arange(layout.n_prompts, dtype=np.int64)
    depth = np.arange(layout.prefix_blocks, dtype=np.int64)
    for t in range(T):
        starts = layout.prefix_chain_start(np.full_like(entries, t), entries)
        ids = (starts[:, None] + depth[None, :]).ravel()
        np.add.at(lam[t], ids,
                  np.repeat(p[t] * share[t] / B, layout.prefix_blocks))
        if layout.suffix_blocks:
            choices = np.arange(layout.suffix_choices, dtype=np.int64)
            e = np.arange(layout.suffix_blocks, dtype=np.int64)
            s0 = layout.suffix_chain_start(
                np.repeat(np.full_like(entries, t), layout.suffix_choices),
                np.repeat(entries, layout.suffix_choices),
                np.tile(choices, layout.n_prompts),
            )
            sids = (s0[:, None] + e[None, :]).ravel()
            sw = np.repeat(p[t] * share[t] / (layout.suffix_choices * B),
                           layout.suffix_choices * layout.suffix_blocks)
            np.add.at(lam[t], sids, sw)
    return lam


# ---------------------------------------------------------------------------
# Canonically-batched sampling.

def _batch_rng(seed: int, batch: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), batch]))


def _sample_request_batch(
    layout: ServingLayout, cdf_mix: np.ndarray, cdf_pop: np.ndarray,
    m: int, rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """m requests: (tenants, catalogue entries, suffix choices)."""
    tenants = np.searchsorted(
        cdf_mix, rng.random(m), side="right"
    ).astype(np.int64)
    u = rng.random(m)
    entries = np.empty(m, dtype=np.int64)
    for t in range(layout.n_tenants):
        mask = tenants == t
        if mask.any():
            entries[mask] = np.searchsorted(
                cdf_pop[t], u[mask], side="right"
            )
    np.clip(entries, 0, layout.n_prompts - 1, out=entries)
    choices = rng.integers(0, layout.suffix_choices, size=m, dtype=np.int64)
    return tenants, entries, choices


def iter_event_batches(
    layout: ServingLayout,
    alphas: Sequence[float],
    mix: Sequence[float] | None,
    n_events: int,
    seed: int,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield the canonical event stream as (proxies, objects) batches.

    Batch b holds the events of requests ``[b*REQUEST_BATCH,
    (b+1)*REQUEST_BATCH)``, each seeded from ``(seed, b)`` alone — the
    stream is a pure function of ``(layout, alphas, mix, seed)`` and
    truncation point, never of how callers re-chunk it. The final batch
    may cut a request mid-chain; a chain prefix is itself a valid
    request prefix, so the truncated trace stays well formed."""
    if n_events <= 0:
        return
    B = layout.blocks_per_request
    share = _mix_weights(layout, mix)
    cdf_mix = np.cumsum(share)
    cdf_mix[-1] = 1.0 + 1e-12
    cdf_pop = np.cumsum(popularity(layout, alphas), axis=1)
    cdf_pop[:, -1] = 1.0 + 1e-12

    n_requests = -(-n_events // B)          # ceil
    emitted = 0
    for b in range(-(-n_requests // REQUEST_BATCH)):
        m = min(REQUEST_BATCH, n_requests - b * REQUEST_BATCH)
        rng = _batch_rng(seed, b)
        tenants, entries, choices = _sample_request_batch(
            layout, cdf_mix, cdf_pop, m, rng
        )
        objects = layout.request_objects(tenants, entries, choices).ravel()
        proxies = np.repeat(tenants.astype(np.int32), B)
        take = min(len(objects), n_events - emitted)
        emitted += take
        yield proxies[:take], objects[:take]
        if emitted >= n_events:
            return


def compile_trace(
    layout: ServingLayout,
    alphas: Sequence[float],
    mix: Sequence[float] | None,
    n_events: int,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize the first ``n_events`` events of the canonical stream."""
    parts = list(iter_event_batches(layout, alphas, mix, n_events, seed))
    if not parts:
        return (np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int64))
    return (np.concatenate([p for p, _ in parts]),
            np.concatenate([o for _, o in parts]))


def sample_request_stream(
    layout: ServingLayout,
    alphas: Sequence[float],
    mix: Sequence[float] | None,
    n_requests: int,
    seed: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First ``n_requests`` whole requests (tenants, entries, choices).

    The request-level view of the same canonical stream
    :func:`iter_event_batches` compiles — used by the equivalence tests
    to drive the reference :class:`SharedPrefixCache` per request."""
    share = _mix_weights(layout, mix)
    cdf_mix = np.cumsum(share)
    cdf_mix[-1] = 1.0 + 1e-12
    cdf_pop = np.cumsum(popularity(layout, alphas), axis=1)
    cdf_pop[:, -1] = 1.0 + 1e-12
    ts, rs, cs = [], [], []
    for b in range(-(-n_requests // REQUEST_BATCH)):
        m = min(REQUEST_BATCH, n_requests - b * REQUEST_BATCH)
        rng = _batch_rng(seed, b)
        t, r, c = _sample_request_batch(layout, cdf_mix, cdf_pop, m, rng)
        ts.append(t)
        rs.append(r)
        cs.append(c)
    return np.concatenate(ts), np.concatenate(rs), np.concatenate(cs)
