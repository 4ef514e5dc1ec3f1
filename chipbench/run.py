"""Runs one cell of ``BENCHMARK.json`` on the card it is started on.

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` also
``breakdown``, and last ``checks``: each number compared with its limit,
which the last lines on standard error repeat. Exits with another code,
and prints no result, without a card (or with fewer than the cell asks
for), or when JAX or the JAX package (``repro``) is loaded once the
window has closed.

Every cache the program builds stays in the checkout: the port's nvcc
libraries in ``src/repro_torch/kernels/_build/`` and any Triton or CUDA
cache under ``chipbench/.cache/``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Modules of ``names`` (default: the loaded ones) whose top-level name
    is JAX's, jaxlib's, flax's or the JAX package's (whole names:
    ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def result_line(rec, metrics: dict, device, trace: bool) -> dict:
    import torch

    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": 1, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    out = {"correct": bool(rec.correct), "attempted": int(rec.attempted),
           "failed": int(rec.failed), "metrics": metrics, "device": dev}
    if trace and rec.profile is not None:
        dev["busy_s"] = float(rec.profile.busy_s())
        dev["window_s"] = float(rec.profile.wall_s())
        out["breakdown"] = rec.profile.breakdown()
    # a number that is not finite (a failed comparison) is written as the
    # largest double, which strict JSON can hold
    out["checks"] = {k: {n: (v if math.isfinite(v) else sys.float_info.max) for n, v in c.items()}
                     for k, c in rec.checks.items()}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, hooks=None):
    """The cell's record: its driver run on ``device``, its metrics read."""
    from chipbench.harness import manifest, serve_cell, train_cell

    m = manifest.load(ROOT)
    cell = manifest.cell(m, name, ROOT)
    driver = {"train": train_cell, "serve": serve_cell}[cell.traffic["kind"]]
    rec = driver.run(cell, seed, seconds, trace, device, T_START, hooks)
    kind = "per_layer" if trace else "end_to_end"
    return rec, manifest.read_metrics(m, name, kind, rec, ROOT), cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / "chipbench" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))

    import torch

    from chipbench.harness import manifest

    chips = manifest.cell(manifest.load(ROOT), args.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec, metrics, _ = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"chipbench: the process loaded {found} (JAX or the JAX package)", file=sys.stderr)
        return 3
    line = result_line(rec, metrics, device, bool(args.trace))
    for name, c in rec.checks.items():
        note = f" ({rec.notes[name]})" if name in rec.notes else ""
        print(f"check {name} {c['value']!r} limit {c['limit']!r}{note}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
