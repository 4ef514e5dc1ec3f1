#!/usr/bin/env python3
"""What the port's spans and counters (``repro_torch.tracing``) cost on the
host, with no profiler open and with one collecting.

    python3 scripts/time_spans.py [--n 200000]

Prints one JSON line of microseconds: an empty ``span``; a
``record_function`` range entered with no profiler open (what the train
step's two ranges cost before they went through ``span``); a ``count``;
one request's worth (a ``request`` record holding the serving path's four
spans and five counters); and an empty ``span`` and a request's worth
while ``torch.profiler`` collects (CPU, and CUDA where there is a card).
Each the median of five timed loops of ``--n`` (a tenth of it under the
profiler). Runs on the CPU alone too; a card only adds its activity to
the profiler.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def per_call_us(body, n: int) -> float:
    """Median over five loops of ``n`` calls, less an empty loop's cost."""
    def loop(f):
        t = time.perf_counter_ns()
        for _ in range(n):
            f()
        return (time.perf_counter_ns() - t) / n / 1e3

    empty = statistics.median(loop(lambda: None) for _ in range(5))
    return statistics.median(loop(body) for _ in range(5)) - empty


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import tracing

    def empty_span():
        with tracing.span("bench.span"):
            pass

    def empty_range():
        with record_function("bench.range"):
            pass

    def one_request():
        with tracing.request():
            with tracing.span("bench.lookup"):
                with tracing.span("bench.keys"):
                    pass
                tracing.count("bench.a", 16)
            tracing.count("bench.b", 3)
            tracing.count("bench.c", 1)
            with tracing.span("bench.insert"):
                with tracing.span("bench.keys"):
                    pass
                tracing.count("bench.a", 16)
            tracing.count("bench.d", 13)
            tracing.count("bench.e", 13)

    out = {"device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
           "span_us": per_call_us(empty_span, args.n),
           "record_function_no_profiler_us": per_call_us(empty_range, args.n),
           "count_us": per_call_us(lambda: tracing.count("bench.count"), args.n),
           "request_us": per_call_us(one_request, args.n // 4)}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        out["span_profiled_us"] = per_call_us(empty_span, args.n // 10)
        out["request_profiled_us"] = per_call_us(one_request, args.n // 40)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
