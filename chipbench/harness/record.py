"""What a run leaves for the metric readers: its set-up and window on the
host clock, spans and counters of the window, the work the yardstick
counts, and, in a traced run, the profile."""

from __future__ import annotations

import dataclasses
import gc
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .profiling import Profile


@dataclass
class Record:
    cell: str
    kind: str                                   # "train" or "serve"
    setup_s: float = 0.0
    window_s: float = 0.0
    spans: Dict[str, List[float]] = field(default_factory=dict)     # seconds, host clock
    counters: Dict[str, float] = field(default_factory=dict)
    work: Dict[str, float] = field(default_factory=dict)            # from the yardstick
    profile: Optional[Profile] = None           # a traced run's sessions
    checks: Dict[str, dict] = field(default_factory=dict)           # {name: {value, limit}}
    notes: Dict[str, str] = field(default_factory=dict)             # where a check read it
    correct: bool = False
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0


def check(rec: Record, name: str, value: float, limit: float, note: str = "") -> None:
    """One number compared: correct while value <= limit (NaN fails)."""
    rec.checks[name] = {"value": float(value), "limit": float(limit)}
    if note:
        rec.notes[name] = note


def passed(rec: Record) -> bool:
    return bool(rec.checks) and all(c["value"] <= c["limit"] for c in rec.checks.values())


def merge(recs: List[Record], split_work: bool) -> Record:
    """One record of a cell's ranks (``recs`` in rank order; one rank: its
    own record). The longest set-up and window; the fullest card's memory
    peak, and of each counter with "peak" in its name the largest; the
    other counters, ``attempted`` and the spans summed (spans joined) where
    the ranks do different work (``split_work``), rank 0's where they do
    the same; ``failed`` summed or the most; ``work`` and the profile rank
    0's. Each check holds its worst value over the ranks (NaN if any reads
    NaN), and the run is correct only if every rank's is."""
    if len(recs) == 1:
        return recs[0]
    r0 = recs[0]
    counters: Dict[str, float] = {}
    for k in dict.fromkeys(k for r in recs for k in r.counters):
        vals = [r.counters[k] for r in recs if k in r.counters]
        counters[k] = (max(vals) if "peak" in k else sum(vals) if split_work
                       else r0.counters.get(k, vals[0]))
    spans = r0.spans
    if split_work:
        spans = {k: [x for r in recs for x in r.spans.get(k, [])]
                 for k in dict.fromkeys(k for r in recs for k in r.spans)}
    out = dataclasses.replace(
        r0, setup_s=max(r.setup_s for r in recs), window_s=max(r.window_s for r in recs),
        counters=counters, spans=spans, checks={}, notes={},
        attempted=sum(r.attempted for r in recs) if split_work else r0.attempted,
        failed=sum(r.failed for r in recs) if split_work else max(r.failed for r in recs),
        memory_peak_bytes=max(r.memory_peak_bytes for r in recs))
    for name in dict.fromkeys(k for r in recs for k in r.checks):
        have = [(i, r) for i, r in enumerate(recs) if name in r.checks]
        vals = [r.checks[name]["value"] for _, r in have]
        if any(math.isnan(v) for v in vals):
            at = next(j for j, v in enumerate(vals) if math.isnan(v))
        else:
            at = max(range(len(vals)), key=vals.__getitem__)
        i, worst = have[at]
        out.checks[name] = {"value": vals[at], "limit": worst.checks[name]["limit"]}
        out.notes[name] = f"{worst.notes[name]}, rank {i}" if name in worst.notes else f"rank {i}"
    out.correct = all(r.correct for r in recs) and passed(out)
    return out


def log(msg: str, t_start: float) -> None:
    """A phase of the run on standard error, with the seconds since its start."""
    print(f"[chipbench {time.perf_counter() - t_start:8.2f} s] {msg}", file=sys.stderr, flush=True)


def free(device) -> None:
    """Hands the memory of what the caller dropped back to the card."""
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
