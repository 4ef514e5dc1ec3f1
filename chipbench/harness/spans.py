"""The port's request records of a serving run's window, for the readers of
the prefix cache's spans (``repro_torch.tracing``: one record a call to
``engine.submit``).

A traced run leaves its window's ``requests`` records followed by one of
each profiled request (a prefill under the profiler each), and nothing
after them: the window's are the last ``requests + profiled`` records less
the last ``profiled``. None where the run left none to read: an untraced
run, a port without ``repro_torch.tracing``, fewer records kept than the
window, or no span of that name in them.
"""

from __future__ import annotations

from typing import List, Optional


def window_records(rec) -> Optional[List]:
    if rec.kind != "serve" or rec.profile is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    n, k = int(rec.counters.get("requests", 0)), len(rec.profile.parts("prefill"))
    kept = tracing.records(n + k)
    if n == 0 or len(kept) < n + k:
        return None
    return kept[:n]


def mean_ms(rec, name: str) -> Optional[float]:
    """Mean host ms a window request spends in its spans ``name``, summed."""
    rs = window_records(rec)
    if not rs or not all(name in r.spans for r in rs):
        return None
    return 1e3 * sum(r.seconds(name) for r in rs) / len(rs)
