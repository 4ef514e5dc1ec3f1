"""What a run leaves for the metric readers: its set-up and window on the
host clock, spans and counters of the window, the work the yardstick
counts, and, in a traced run, the profile."""

from __future__ import annotations

import gc
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


def log(msg: str, t_start: float) -> None:
    """A phase of the run on standard error, with the seconds since its start."""
    print(f"[chipbench {time.perf_counter() - t_start:8.2f} s] {msg}", file=sys.stderr, flush=True)


def free(device) -> None:
    """Hands the memory of what the caller dropped back to the card."""
    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()
