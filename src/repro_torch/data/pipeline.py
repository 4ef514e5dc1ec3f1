"""Deterministic, checkpointable data pipelines (a host copy of the
reference's ``repro.data.pipeline``: NumPy only, the same batches from the
same seed and the same ``state()`` / ``restore()``).

* :class:`SyntheticLMData` — seeded synthetic token stream with Zipf
  unigram statistics and injected n-gram structure (so a trained model
  has something learnable and loss decreases measurably).
* :class:`FileTokenData` — memory-mapped binary token file (uint16/32),
  sharded by host, sequential with deterministic shuffle windows.

Both expose ``state()`` / ``restore(state)`` so a resumed training run
continues on the exact batch it would have seen (fault-tolerance tests
assert this), and ``shard(host_id, n_hosts)`` for multi-host use.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


class SyntheticLMData:
    def __init__(
        self,
        vocab_size: int,
        seq_len: int,
        batch_size: int,
        *,
        seed: int = 0,
        zipf_alpha: float = 1.1,
        ngram_boost: int = 64,
        host_id: int = 0,
        n_hosts: int = 1,
    ) -> None:
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._step = 0
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = ranks ** (-zipf_alpha)
        self._p = p / p.sum()
        # deterministic "grammar": token t is often followed by succ[t]
        rng = np.random.default_rng(seed + 1234)
        self._succ = rng.integers(0, vocab_size, size=vocab_size)
        self._boost = ngram_boost

    def _batch_rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed, step, self.host_id, 0xDA7A)
        )

    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = self._batch_rng(self._step)
        self._step += 1
        B, T = self.batch_size, self.seq_len
        toks = rng.choice(self.vocab_size, size=(B, T + 1), p=self._p)
        # inject learnable bigram structure: with prob .5 follow succ[t]
        follow = rng.random((B, T)) < 0.5
        toks[:, 1:][follow] = self._succ[toks[:, :-1][follow]]
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "mask": np.ones((B, T), bool),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- checkpointable state -------------------------------------------
    def state(self) -> Dict[str, int]:
        return {"step": self._step, "seed": self.seed}

    def restore(self, state: Dict[str, int]) -> None:
        assert state["seed"] == self.seed, "data seed changed across restore"
        self._step = int(state["step"])


class FileTokenData:
    """Sequential batches from a flat binary token file (np.memmap)."""

    def __init__(
        self,
        path: str | Path,
        vocab_size: int,
        seq_len: int,
        batch_size: int,
        *,
        dtype=np.uint16,
        host_id: int = 0,
        n_hosts: int = 1,
    ) -> None:
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.host_id = host_id
        self.n_hosts = n_hosts
        self._cursor = host_id * batch_size * seq_len
        n_needed = batch_size * (seq_len + 1)
        if len(self.tokens) < n_needed * n_hosts:
            raise ValueError("token file too small for one global batch")

    def next_batch(self) -> Dict[str, np.ndarray]:
        B, T = self.batch_size, self.seq_len
        span = B * (T + 1)
        stride = span * self.n_hosts
        if self._cursor + span > len(self.tokens):
            self._cursor = self.host_id * span  # wrap epoch
        chunk = np.asarray(
            self.tokens[self._cursor : self._cursor + span], dtype=np.int32
        ).reshape(B, T + 1)
        self._cursor += stride
        chunk = chunk % self.vocab_size
        return {
            "tokens": chunk[:, :-1],
            "labels": chunk[:, 1:],
            "mask": np.ones((B, T), bool),
        }

    def state(self) -> Dict[str, int]:
        return {"cursor": int(self._cursor)}

    def restore(self, state: Dict[str, int]) -> None:
        self._cursor = int(state["cursor"])


def make_pipeline(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticLMData(**kw)
    if kind == "file":
        return FileTokenData(**kw)
    raise ValueError(f"unknown pipeline kind {kind!r}")
