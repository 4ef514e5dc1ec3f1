"""A stand-in cell for the launcher's tests: ``chipbench/run.py``'s own
launch (``run.launch``) and rank entry (``run.run_rank``) driving
:class:`Probe`, a driver of its own, with no cell of ``BENCHMARK.json``.

    python3 chipbench/tests/launch_probe.py --mode ok [--ranks 2] [--split 0|1] [--limit S]

Started without ``--rank`` it is the launcher: it starts ``--ranks``
ranks of itself and ends them after ``--limit`` seconds. Each rank runs
on ``cuda:<rank>`` over NCCL where the machine has cards, else on the
CPU over gloo. Each rank's record reads rank-dependent numbers, so the
result line shows how the ranks were merged (``--split 1``: the ranks'
work counted as different work). Modes: ``ok``; ``fail1``, rank 1's check
over its limit; ``raise``, rank 1 raises in set-up; ``sleep``, rank 1
sleeps past the limit; ``allreduce``, each rank all-reduces rank + 1 (held
to the sum) and a 256 MiB buffer on a card, timed: the collective smoke at
the machine's card count.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import torch  # noqa: E402

from chipbench import run  # noqa: E402
from chipbench.harness.manifest import Cell  # noqa: E402
from chipbench.harness.record import Record, check, passed  # noqa: E402

MODES = ("ok", "fail1", "raise", "sleep", "allreduce")


class Probe:
    """The driver: rank r's record reads window_s 1 + r, tokens 10 (r + 1),
    a peak of 100 (r + 1) bytes, memory 1000 (r + 1), attempted 5 + r,
    failed r, check ``gap`` 0.1 (r + 1) under 1; the window runs until
    rank 0 has made 3 steps (rank r would make 3 + r)."""

    def __init__(self, mode: str) -> None:
        self.mode = mode

    def run(self, cell, seed, seconds, trace, device, t_start, hooks=None) -> Record:
        ranks = cell.ranks
        r = ranks.rank
        print(f"probe rank {r} pid {os.getpid()}", file=sys.stderr, flush=True)
        print(f"probe rank {r}: a line on standard output", flush=True)
        if r == 1 and self.mode == "raise":
            raise RuntimeError("probe: rank 1 fails in set-up")
        if r == 1 and self.mode == "sleep":
            time.sleep(3600)
        ranks.barrier()
        rec = Record(cell.name, "probe")
        rec.setup_s = time.perf_counter() - t_start
        rec.counters["rank_up_s"] = time.perf_counter() - T0
        steps = 0
        while True:
            steps += 1
            if ranks.any(steps >= 3 + r):
                break
        ranks.barrier()
        rec.window_s = 1.0 + r
        rec.counters.update(window_steps=steps, window_tokens=10 * (r + 1),
                            window_peak_bytes=100 * (r + 1))
        rec.memory_peak_bytes, rec.attempted, rec.failed = 1000 * (r + 1), 5 + r, r
        check(rec, "gap", 5.0 if (r == 1 and self.mode == "fail1") else 0.1 * (r + 1), 1.0,
              "probe")
        if self.mode == "allreduce":
            allreduce(rec, ranks, device)
        rec.correct = passed(rec)
        return rec


def allreduce(rec: Record, ranks, device) -> None:
    import torch.distributed as dist

    t = torch.full((1,), float(ranks.rank + 1), device=device)
    dist.all_reduce(t)
    check(rec, "allreduce_gap", abs(float(t) - ranks.world * (ranks.world + 1) / 2), 0.0)
    if device.type == "cuda":
        buf = torch.ones(1 << 26, device=device)            # 256 MiB of f32
        for _ in range(3):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        t0, n = time.perf_counter(), 10
        for _ in range(n):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        sec = (time.perf_counter() - t0) / n
        # ring all-reduce's bus bandwidth: 2 (w - 1) / w of the buffer a rank
        w = ranks.world
        rec.counters["allreduce_busbw_gbps"] = buf.numel() * 4 * 2 * (w - 1) / w / sec / 1e9
        rec.counters["allreduce_ms"] = sec * 1e3


def read_metrics(rec) -> dict:
    out = {"setup_s": rec.setup_s, "window_s": rec.window_s, **rec.counters}
    return {k: {"value": float(v), "unit": "s" if k.endswith("_s") else "1"}
            for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--split", type=int, choices=(0, 1), default=0)
    ap.add_argument("--limit", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--trace", type=int, default=0)
    run.add_rank_args(ap)
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    if args.rank is None:
        return run.launch([sys.executable, str(Path(__file__).resolve())] + argv, args.ranks,
                          timeout_s=args.limit, t0=T0)
    cell = Cell(name="probe", config_name="probe", traffic_name="probe", chips=args.world,
                config={}, traffic={"kind": "probe"}, limits={})
    device = (torch.device("cuda", args.rank) if torch.cuda.is_available()
              else torch.device("cpu"))
    return run.run_rank(cell, Probe(args.mode), args, device, read_metrics, bool(args.split))


if __name__ == "__main__":
    sys.exit(main())
