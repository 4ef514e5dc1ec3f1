"""The one general generator of the traffic mixes (``traffic/<mix>.json``).

Training (``"kind": "train"``): :class:`TokenFeed`, batch k of B
sequences of T + 1 tokens drawn on the device from (seed, k) under a Zipf
unigram law, the same on every run; every batch is new, so no two steps
see the same rows.

Serving (``"kind": "serve"``): :class:`ServeStream`, the request stream
of a multi-tenant shared-prefix workload. The sampling of (tenant,
catalogue entry) per request is a frozen copy of
``repro_torch/serving/trace.py`` (``ServingLayout``'s ``popularity``,
``_mix_weights``, ``_batch_rng``, ``_sample_request_batch`` and
``sample_request_stream``): per-tenant Zipf popularity over a catalogue
whose hottest ``shared_frac`` entries are shared by every tenant, the
stream drawn in canonical batches seeded by (seed, batch). A prompt's
tokens are drawn from (seed, chain), so two requests for one shared
entry carry the same tokens, whatever their tenant; each request's user
suffix is drawn from (seed, request index) and is its own. With
``unique_prompts`` every request's prompt is its own chain. The lengths
are fixed by the mix: the seed draws token ids, tenants and order only.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

# requests per canonical sampling batch (trace.py's REQUEST_BATCH)
REQUEST_BATCH = 65536


@contextmanager
def deterministic():
    """PyTorch's deterministic algorithms within the block. The draw's
    cumulative sum over the vocabulary needs them: on a card the default
    scan over more than one tile (qwen3's 151,936 ids) adds in an order
    that changes from run to run, and so does the batch."""
    was, warn = (torch.are_deterministic_algorithms_enabled(),
                 torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)


class TokenFeed:
    """Training batches {"tokens", "labels"} (B, T) int64 on ``device``."""

    def __init__(self, seed: int, vocab: int, batch: int, seq: int, zipf_alpha: float,
                 device) -> None:
        self.seed, self.B, self.T, self.device = int(seed), batch, seq, device
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
        self.p = (ranks ** -zipf_alpha).float()
        self.k = 0

    def batch(self, k: int) -> dict:
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + 7919 * k + 17) % (1 << 63))
        with deterministic():
            toks = torch.multinomial(self.p, self.B * (self.T + 1), replacement=True,
                                     generator=gen).reshape(self.B, self.T + 1)
        return {"tokens": toks[:, :-1].contiguous(), "labels": toks[:, 1:].contiguous()}

    def next(self) -> dict:
        out = self.batch(self.k)
        self.k += 1
        return out


# -- frozen copy of repro_torch/serving/trace.py's sampling ---------------

def popularity(n_prompts: int, alphas: Sequence[float]) -> np.ndarray:
    """(T, n_prompts) per-tenant Zipf catalogue popularities: rank r
    (0-based) gets weight (r+1)**-alpha_t; rows sum to 1."""
    ranks = np.arange(1, n_prompts + 1, dtype=np.float64)
    w = ranks[None, :] ** -np.asarray(alphas, dtype=np.float64)[:, None]
    return w / w.sum(axis=1, keepdims=True)


def _mix_weights(n_tenants: int, mix: Sequence[float] | None) -> np.ndarray:
    if mix is None:
        return np.full(n_tenants, 1.0 / n_tenants)
    m = np.asarray(mix, dtype=np.float64)
    return m / m.sum()


def _batch_rng(seed: int, batch: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([int(seed), batch]))


def _sample_request_batch(n_tenants: int, n_prompts: int, cdf_mix: np.ndarray,
                          cdf_pop: np.ndarray, m: int, rng: np.random.Generator
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """m requests: (tenants, catalogue entries). The reference draws a
    suffix choice after them, which is left out here: a request's suffix
    is its own."""
    tenants = np.searchsorted(cdf_mix, rng.random(m), side="right").astype(np.int64)
    u = rng.random(m)
    entries = np.empty(m, dtype=np.int64)
    for t in range(n_tenants):
        mask = tenants == t
        if mask.any():
            entries[mask] = np.searchsorted(cdf_pop[t], u[mask], side="right")
    np.clip(entries, 0, n_prompts - 1, out=entries)
    return tenants, entries


def sample_request_stream(n_prompts: int, alphas: Sequence[float], mix: Sequence[float],
                          n_requests: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """The first ``n_requests`` requests (tenants, entries)."""
    n_tenants = len(alphas)
    cdf_mix = np.cumsum(_mix_weights(n_tenants, mix))
    cdf_mix[-1] = 1.0 + 1e-12
    cdf_pop = np.cumsum(popularity(n_prompts, alphas), axis=1)
    cdf_pop[:, -1] = 1.0 + 1e-12
    ts, rs = [], []
    for b in range(-(-n_requests // REQUEST_BATCH)):
        m = min(REQUEST_BATCH, n_requests - b * REQUEST_BATCH)
        t, r = _sample_request_batch(n_tenants, n_prompts, cdf_mix, cdf_pop, m,
                                     _batch_rng(seed, b))
        ts.append(t)
        rs.append(r)
    return np.concatenate(ts), np.concatenate(rs)


# -- the serving stream ----------------------------------------------------

@dataclass(frozen=True)
class ServeRequest:
    index: int
    tenant: int
    chain: int                # prompt chain: equal chains, equal prompt tokens
    tokens: np.ndarray        # prompt + user suffix, int64


class ServeStream:
    """Requests of a serving mix ``mix`` (the parsed ``traffic/<mix>.json``)
    over a vocabulary of ``vocab`` ids, from ``seed``."""

    N_PLANNED = 4096          # requests sampled ahead (a window serves far fewer)

    def __init__(self, mix: dict, vocab: int, seed: int) -> None:
        self.mix, self.vocab, self.seed = mix, vocab, int(seed)
        n_t = len(mix["tenants"])
        self.tenants, entries = sample_request_stream(
            mix["n_prompts"], mix["alphas"], mix["mix"], self.N_PLANNED, self.seed)
        n_shared = int(round(mix["shared_frac"] * mix["n_prompts"]))
        n_private = mix["n_prompts"] - n_shared
        if mix.get("unique_prompts"):
            self.chains = np.arange(self.N_PLANNED, dtype=np.int64)
        else:   # shared entry r: chain r; private entry r of tenant t: its own
            self.chains = np.where(entries < n_shared, entries,
                                   n_shared + self.tenants * n_private + (entries - n_shared))
        self.n_tenants = n_t
        self._prompts: dict = {}

    def prompt(self, chain: int) -> np.ndarray:
        p = self._prompts.get(chain)
        if p is None:
            rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0x50524F, int(chain)]))
            p = self._prompts[chain] = rng.integers(0, self.vocab, self.mix["prompt_tokens"],
                                                    dtype=np.int64)
        return p

    def request(self, i: int) -> ServeRequest:
        if i >= self.N_PLANNED:
            raise IndexError(f"request {i} past the {self.N_PLANNED} planned")
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, 0x535546, i]))
        suffix = rng.integers(0, self.vocab, self.mix["suffix_tokens"], dtype=np.int64)
        chain = int(self.chains[i])
        return ServeRequest(i, int(self.tenants[i]), chain,
                            np.concatenate([self.prompt(chain), suffix]))

    def requests(self, n: int) -> List[ServeRequest]:
        return [self.request(i) for i in range(n)]
