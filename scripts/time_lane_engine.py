#!/usr/bin/env python3
"""Times the lane engine (E1) of one source tree on one NVIDIA card.

    python3 scripts/time_lane_engine.py [--src TREE/src] [--dists 4,8,16,32]

Imports ``repro_torch`` from ``--src`` (this repository's ``src`` by
default), builds its lane engine with ``nvcc`` and prints the ptxas report
and, where the toolkit has ``cuobjdump``, the memory instructions of each
kernel's SASS (shared ``LDS``/``STS``, generic ``LD``/``ST``, global
``LDG``/``STG``, prefetches ``CCTL``, atomics ``ATOMS``/``ATOMG``/``RED``/``REDG``,
address-space tests ``QSPC``). The device-memory route's prefetch
distance is a constant of ``lane_engine.cu``; for each distance of
``--dists`` the script builds a copy of the kernel with
``-DLE_PREFETCH=<d>`` into ``kernels/_build/prefetch/`` (ignored by git),
one ``nvcc`` each, in parallel. Then, with CUDA events (median of the
timed chunks, each after the runner's own synchronize):

- the Table I system (J=3, N=1000, Zipf 0.75/0.5/1.0, its 8 b-combos x 4
  replicas = 32 sweep lanes, warmed by 200,000 requests a lane): chunks of
  65,536 requests a lane on the shared route and on the device-memory
  route forced, at each prefetch distance of ``--dists``, and a launch of
  one tile (256 requests) on the shared route, whose time is mostly the
  lane's copy into shared memory and back;
- the Fig. 2 system (J=9, N=1e6, 3x1000 + 3x2000 + 3x7000 units, Zipf
  0.5..4.5, 16 lanes warmed by ``--fig2-warm`` requests): chunks of 16,384
  on the device-memory route at each distance.

Every setting has runners of its own, fed the same requests in turn, so
each chunk is timed on lanes in the same state; the runners' states are
held equal after every chunk. Two trees, e.g. a commit and its parent
unpacked with ``git archive``, are compared in turns, one process each.
Prints the card's name and power limit first. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
TABLE1_GRID = ((8, 8, 8), (8, 8, 64), (8, 64, 8), (8, 64, 64),
               (64, 8, 8), (64, 8, 64), (64, 64, 8), (64, 64, 64))
FIG2_ALLOCS = (1000, 1000, 1000, 2000, 2000, 2000, 7000, 7000, 7000)
SASS_OPS = ("LDS", "STS", "LD", "ST", "LDG", "STG", "CCTL", "BAR", "ATOMS", "ATOMG", "RED",
            "REDG", "QSPC")


def sass_counts(so: Path) -> dict:
    """Memory instructions per kernel in the library's SASS (cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {}
    out = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                         timeout=120).stdout
    counts, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and cur:
            counts[cur][m.group(1)] += 1
    return {f: {op: c[op] for op in SASS_OPS} | {"all": sum(c.values())}
            for f, c in counts.items()}


def distance_builds(_build, le, dists) -> dict:
    """{d: the entry point of the lane engine built with -DLE_PREFETCH=d}."""
    out = _build.BUILD_DIR / "prefetch"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for d in dists:
        so = out / f"lane_engine_d{d}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DLE_PREFETCH={d}", "-o", str(so),
               str(_build.CSRC / "lane_engine.cu")]
        procs[d] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True))
    fns = {}
    for d, (so, proc) in procs.items():
        log, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"the build at prefetch distance {d} failed:\n{log}")
        fn = ctypes.CDLL(str(so)).repro_lane_engine
        fn.restype = ctypes.c_int
        fn.argtypes = le._ARGTYPES + [ctypes.c_int, ctypes.c_void_p]
        fns[d] = fn
    return fns


def timed(fn) -> float:
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--dists", default="4,8,16,32",
                    help="prefetch distances of the device-memory route, each in [1, 256]")
    ap.add_argument("--chunks", type=int, default=3, help="timed chunks per setting")
    ap.add_argument("--fig2-warm", type=int, default=300_000)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_lane_engine: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import irm  # the tree's modules
    from repro_torch.core.fastsim import SimParams
    from repro_torch.core.fastsim_cuda import BatchedCudaRunner
    from repro_torch.kernels import _build
    from repro_torch.kernels import lane_engine as le

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}; tree {args.src}", flush=True)
    dev = torch.device("cuda")
    dists = [int(x) for x in args.dists.split(",")]
    report = _build.build(["lane_engine"]).get("lane_engine", "")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"ptxas: {line.strip()}")
    for fn, c in sass_counts(_build.library_path("lane_engine")).items():
        print(f"sass {fn}: {c}")
    launch = distance_builds(_build, le, dists)

    def runners(params, N, R, scale, plan, **kw):
        """{setting: runner} for plan {setting: (route, prefetch distance)}."""
        return {key: BatchedCudaRunner(params, N, np.ones(N, np.int64), 0, 0, scale, R,
                                       device=dev, route=route, **kw)
                for key, (route, _) in plan.items()}

    def feed_all(rs, P, O):
        for r in rs.values():
            r.feed(P, O)

    def same(rs):
        ref = next(iter(rs.values()))
        for r in rs.values():
            for k in r.st:
                if not torch.equal(r.st[k], ref.st[k]):
                    raise RuntimeError(f"settings disagree on {k}")

    def chunk_fn(r, Pd, Od, dist):
        if r.route == "shared":
            def go():
                le.lane_engine(r.st, Pd, Od, idx0=r.idx, lengths=r.lengths, share=r.share,
                               B=r.B, warmup=r.warmup, ripple_from=r.ripple_from,
                               ghost=r.ghost_retention, table=r._table, route="shared")
            return go

        def go():
            rc = le._call(launch[dist], r.st, r._table, Pd, Od, r.lengths, r.share, r.idx,
                          r.B, r.warmup, r.ripple_from, r.ghost_retention, 0,
                          torch.cuda.current_stream(dev).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"prefetch distance {dist}: launch failed, cudaError {rc}")
        return go

    def run_chunks(rs, sample, m, plan, label):
        """Every chunk runs on every setting's runners in turn (the same
        requests on lanes in the same state), timed; then the states are
        compared."""
        times = {key: [] for key in plan}
        for _ in range(args.chunks):
            P, O = sample(m)
            Pd, Od = torch.from_numpy(P).to(dev), torch.from_numpy(O).to(dev)
            for key, (_, d) in plan.items():
                r = rs[key]
                times[key].append(timed(chunk_fn(r, Pd, Od, d)))
                r.idx += m
            same(rs)
        for key, t in times.items():
            med = float(np.median(t))
            route, d = plan[key]
            at = "" if d is None else f" dist {d}"
            print(f"{label} route {route}{at}: {med:.4f} ms per chunk of "
                  f"{rs[key].R} lanes x {m} (median of {len(t)}; all "
                  f"{[round(x, 4) for x in t]}), {m / med * 1e3:.0f} requests/s a lane",
                  flush=True)

    # -- Table I ---------------------------------------------------------
    N, R = 1000, 4
    combos = np.repeat(np.asarray(TABLE1_GRID, np.int64), R, axis=0)
    L = len(combos)
    lam = irm.rate_matrix(N, (0.75, 0.5, 1.0))
    rng = np.random.default_rng(7)

    def sample1(m):
        """R replicas' requests (one IRM trace cut in R), each fed to the 8
        b-combos' lanes."""
        t = irm.sample_trace(lam, R * m, seed=int(rng.integers(2**31)))
        P, O = t.proxies.reshape(R, m), t.objects.reshape(R, m)
        rep = np.arange(L) % R
        return P[rep].astype(np.int32), O[rep].astype(np.int32)

    p1 = SimParams(allocations=TABLE1_GRID[-1], physical_capacity=N)
    plan = {"shared": ("shared", None)} | {f"d{d}": ("device", d) for d in dists}
    rs = runners(p1, N, L, 6, plan, b_sweep=combos, bhat_sweep=combos)
    feed_all(rs, *sample1(200_000))
    same(rs)
    run_chunks(rs, sample1, 65_536, plan, "Table I")
    P, O = sample1(le.TILE)
    Pd, Od = torch.from_numpy(P).to(dev), torch.from_numpy(O).to(dev)
    short = []
    for _ in range(5):
        short.append(timed(chunk_fn(rs["shared"], Pd, Od, None)))
        rs["shared"].idx += le.TILE
    print(f"Table I route shared: one tile ({le.TILE} requests a lane, {L} lanes) "
          f"{float(np.median(short)):.4f} ms (median of 5)", flush=True)
    del rs

    # -- Fig. 2 ------------------------------------------------------------
    N2, R2 = 1_000_000, 16
    lam2 = irm.rate_matrix(N2, tuple(0.5 + 0.5 * i for i in range(9)))
    rng2 = np.random.default_rng(23)

    def sample2(m):
        t = irm.sample_trace(lam2, R2 * m, seed=int(rng2.integers(2**31)))
        return (t.proxies.reshape(R2, m).astype(np.int32),
                t.objects.reshape(R2, m).astype(np.int32))

    p2 = SimParams(allocations=FIG2_ALLOCS, physical_capacity=sum(FIG2_ALLOCS))
    plan2 = {f"d{d}": ("device", d) for d in dists}
    rs2 = runners(p2, N2, R2, 2520, plan2)
    feed_all(rs2, *sample2(args.fig2_warm))
    run_chunks(rs2, sample2, 16_384, plan2, "Fig. 2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
