"""Runs one cell of ``BENCHMARK.json`` on the card(s) of the machine it is
started on.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit,
which the last lines on standard error repeat. Exits with another code,
and prints no result, without a card (or with fewer than the cell asks
for), or when JAX or the JAX package (``repro``) is loaded once the
window has closed.

The cell's driver is the module ``harness/<kind>_cell.py`` of its traffic
mix's ``kind``. A cell on one chip runs in this process on ``cuda:0``,
with no process group. A cell on ``chips`` > 1 runs as one process a
card (:func:`launch`): each rank takes ``cuda:<rank>``, joins the NCCL
default group and runs the driver; rank 0 gathers the ranks' records,
merges them (``harness/record.py``'s ``merge``) and prints the line,
which this process passes on once every rank has exited 0. A rank that
fails, or a run that outlives ``RANK_TIMEOUT_S``, ends every rank and
the run exits nonzero with no line. Set-up is timed from this process's
start on every rank (``time.perf_counter`` is one monotonic clock for
every process of the machine).

Every cache the program builds stays in the checkout: the port's nvcc
libraries in ``src/repro_torch/kernels/_build/`` and any Triton or CUDA
cache under ``chipbench/.cache/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from datetime import timedelta  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a cell's first run in a checkout builds and compiles, and may take 1200 s
RANK_TIMEOUT_S = 1140.0
PR_SET_PDEATHSIG = 1        # prctl(2): the signal a process gets when its parent dies


def forbidden_modules(names=None) -> list:
    """Modules of ``names`` (default: the loaded ones) whose top-level name
    is JAX's, jaxlib's, flax's or the JAX package's (whole names:
    ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def result_line(rec, metrics: dict, device, trace: bool, recs=None) -> dict:
    """The result of ``rec``, merged from the ranks' records ``recs`` (by
    default ``rec`` alone): the device's busy seconds averaged over the
    ranks, the traced window the longest rank's."""
    import torch

    recs = recs or [rec]
    cuda = device.type == "cuda"
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": len(recs), "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": bool(rec.correct), "attempted": int(rec.attempted),
           "failed": int(rec.failed), "metrics": metrics, "device": dev}
    if trace and rec.profile is not None:
        traced = [r.profile for r in recs if r.profile is not None]
        dev["busy_s"] = float(sum(p.busy_s() for p in traced) / len(traced))
        dev["window_s"] = float(max(p.wall_s() for p in traced))
        out["breakdown"] = rec.profile.breakdown()
    # a number that is not finite (a failed comparison) is written as the
    # largest double, which strict JSON can hold
    out["checks"] = {k: {n: (v if math.isfinite(v) else sys.float_info.max) for n, v in c.items()}
                     for k, c in rec.checks.items()}
    return out


def add_rank_args(ap: argparse.ArgumentParser) -> None:
    """The arguments :func:`launch` hands each rank it starts."""
    for flag, kind in (("--rank", int), ("--world", int), ("--addr", str), ("--t0", float),
                       ("--timeout", float)):
        ap.add_argument(flag, type=kind, default=None, help=argparse.SUPPRESS)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmd: list, world: int, timeout_s: float = RANK_TIMEOUT_S, t0: float = T_START) -> int:
    """Runs ``cmd`` once a rank on this machine, each with ``--rank r
    --world world --addr <tcp store> --t0 t0 --timeout timeout_s``, each in
    a session of its own and killed if this process dies. Rank 0's
    standard output is held back and passed on only when every rank has
    exited 0; the others' goes to standard error. A rank that exits
    nonzero, ranks still running ``timeout_s`` after the start, or a
    SIGTERM to this process end every rank (and what it started): the
    return is then nonzero. Returns once every rank has ended."""
    import ctypes

    prctl = ctypes.CDLL(None, use_errno=True).prctl
    addr = f"tcp://127.0.0.1:{free_port()}"
    deadline = time.perf_counter() + timeout_s
    procs: list = []
    sys.stdout.flush()
    sys.stderr.flush()
    term = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    with tempfile.TemporaryFile() as out0:
        try:
            for r in range(world):
                procs.append(subprocess.Popen(
                    cmd + ["--rank", str(r), "--world", str(world), "--addr", addr,
                           "--t0", repr(t0), "--timeout", repr(timeout_s)],
                    stdout=out0 if r == 0 else sys.stderr.fileno(), start_new_session=True,
                    preexec_fn=lambda: prctl(PR_SET_PDEATHSIG, signal.SIGKILL)))
            rc = wait_ranks(procs, deadline)
        finally:
            end_ranks(procs)
            signal.signal(signal.SIGTERM, term)
        if rc != 0:
            return rc
        found = forbidden_modules()
        if found:
            print(f"chipbench: the launcher loaded {found} (JAX or the JAX package)",
                  file=sys.stderr)
            return 3
        out0.seek(0)
        sys.stdout.buffer.write(out0.read())
        sys.stdout.flush()
    return 0


def wait_ranks(procs: list, deadline: float) -> int:
    """0 once every rank has exited 0; the code of the first that did not
    (1 for a signal), or 124 at ``deadline``."""
    while True:
        codes = [p.poll() for p in procs]
        bad = next(((r, c) for r, c in enumerate(codes) if c not in (None, 0)), None)
        if bad is not None:
            print(f"chipbench: rank {bad[0]} exited with {bad[1]}; ending the others",
                  file=sys.stderr, flush=True)
            return bad[1] if bad[1] > 0 else 1
        if all(c == 0 for c in codes):
            return 0
        if time.perf_counter() > deadline:
            print(f"chipbench: ranks {[r for r, c in enumerate(codes) if c is None]} still "
                  "running at the run's time limit; ending them", file=sys.stderr, flush=True)
            return 124
        time.sleep(0.1)


def end_ranks(procs: list) -> None:
    """Kills each rank's session (the rank and what it started) and waits
    for each rank."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    for p in procs:
        p.wait()


def join(cell, args, device) -> None:
    """This process as rank ``args.rank`` of ``args.world`` (none: 0 of 1)
    on ``device``: the device made current, ``cell.ranks`` set, and with
    more than one rank the default process group joined at ``args.addr``
    (NCCL on a card, gloo on the CPU); with one rank there is none."""
    import torch

    from chipbench.harness.ranks import Ranks

    rank, world = args.rank or 0, args.world or 1
    if device.type == "cuda":
        torch.cuda.set_device(device)
    cell.ranks = Ranks(rank, world, device)
    if world > 1:
        import torch.distributed as dist

        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=args.addr, rank=rank, world_size=world,
                                timeout=timedelta(seconds=args.timeout or RANK_TIMEOUT_S))


def run_rank(cell, driver, args, device, read_metrics, split_work: bool) -> int:
    """One rank of a cell (:func:`join`): ``driver.run`` on ``device``, then
    on rank 0 the ranks' records merged, their metrics read
    (``read_metrics(record)``) and the result printed. Returns the exit
    code: 3 when a rank loaded JAX or the JAX package."""
    from chipbench.harness.record import log, merge

    join(cell, args, device)
    rank, world = cell.ranks.rank, cell.ranks.world
    t_start = T_START if args.t0 is None else args.t0
    try:
        rec = driver.run(cell, args.seed, args.seconds, bool(args.trace), device, t_start)
        found = forbidden_modules()
        gathered = cell.ranks.gather((rec, found))
    except BaseException:
        if world == 1:
            raise
        # a rank's failure leaves the others in a collective: end at once
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        return 3 if found else 0
    recs = [r for r, _ in gathered]
    rec = merge(recs, split_work)
    metrics = read_metrics(rec)
    loaded = {r: f for r, (_, f) in enumerate(gathered) if f}
    if forbidden_modules():
        loaded[0] = forbidden_modules()
    if loaded:
        print(f"chipbench: loaded JAX or the JAX package: {loaded} (by rank)", file=sys.stderr)
        return 3
    line = result_line(rec, metrics, device, bool(args.trace), recs)
    log(f"work {json.dumps(rec.work)}", t_start)
    for name, c in rec.checks.items():
        note = f" ({rec.notes[name]})" if name in rec.notes else ""
        print(f"check {name} {c['value']!r} limit {c['limit']!r}{note}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def driver_of(cell):
    """The driver of a cell: ``harness/<kind>_cell.py`` of its mix's kind."""
    return importlib.import_module(f"chipbench.harness.{cell.traffic['kind']}_cell")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    add_rank_args(ap)
    args = ap.parse_args(argv)
    cache = ROOT / "chipbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch

    from chipbench import archs
    from chipbench.harness import manifest

    m = manifest.load(ROOT)
    cell = manifest.cell(m, args.workload, ROOT)
    if args.rank is None:                   # the process the run was started as
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"chipbench: {args.workload} needs {cell.chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
                  file=sys.stderr)
            return 2
        if cell.chips > 1:
            return launch([sys.executable, str(Path(__file__).resolve())] + argv, cell.chips)
    elif args.world != cell.chips:
        print(f"chipbench: rank of a world of {args.world}; {args.workload} asks for "
              f"{cell.chips} chips", file=sys.stderr)
        return 2
    kind = "per_layer" if args.trace else "end_to_end"
    return run_rank(cell, driver_of(cell), args, torch.device("cuda", args.rank or 0),
                    lambda rec: manifest.read_metrics(m, cell.name, kind, rec, ROOT),
                    archs.of(cell.config).SPLIT_WORK)


if __name__ == "__main__":
    sys.exit(main())
