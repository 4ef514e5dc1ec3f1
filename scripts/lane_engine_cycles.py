#!/usr/bin/env python3
"""Where a step of the lane engine (E1) spends its cycles, on one NVIDIA card.

    python3 scripts/lane_engine_cycles.py [--src TREE/src]

Copies the tree's ``kernels/csrc/lane_engine.cu`` and ``.cuh`` into
``kernels/_build/cycles/`` (ignored by git), adds ``clock64()`` marks at
six points of ``lane_engine.cuh``'s step, builds the copy with ``nvcc``
and runs warm lanes through it: the Table I system (32 sweep lanes, J=3,
N=1000) on the shared-memory route and the Fig. 2 system (16 lanes, J=9,
N=1e6) on the device-memory route. Block 0's walker sums, per kind of
step (a list hit; an attach: a cache hit or a miss), the cycles of the
early loads, the miss and attach blocks, the unlink and insert, the
eviction loop, the rest of the step, and the time between steps (the
request loop). The marks cost cycles of their own, so each sum is an
upper bound of the uninstrumented step. The tree's kernel is not
changed. Prints the card's name and power limit first. Exits 2 without a
card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
SEGMENTS = ("early loads", "miss+attach", "unlink+insert", "evictions", "rest", "between steps")

# (anchor in the source, text put in its place); every anchor must occur once
CUH_MARKS = (
    ("template <class T>\nLE_FN void lane_step(LaneT<T>& s, const Args& a, int32_t idx, "
     "int32_t i, int32_t k) {",
     "#if defined(__CUDA_ARCH__)\n#define LE_MARK(n) do { if (mk) mk[n] = clock64(); } while (0)\n"
     "#else\n#define LE_MARK(n) do { } while (0)\n#endif\n"
     "template <class T>\nLE_FN void lane_step(LaneT<T>& s, const Args& a, int32_t idx, "
     "int32_t i, int32_t k, long long* mk = nullptr) {\n  LE_MARK(0);"),
    ("  T::add(s.hits_p, i, held && post);\n", "  T::add(s.hits_p, i, held && post);\n  LE_MARK(1);\n"),
    ("  // list hit: unlink k from its place", "  LE_MARK(2);\n  // list hit: unlink k from its place"),
    ("  if (att) s.res_since[ik] = idx;\n", "  if (att) s.res_since[ik] = idx;\n  LE_MARK(3);\n"),
    ("  // miss: reconcile a transient physical overshoot",
     "  LE_MARK(4);\n  // miss: reconcile a transient physical overshoot"),
    ("  T::add(s.reqs_p, i, post);\n}", "  T::add(s.reqs_p, i, post);\n  LE_MARK(5);\n}"),
)
CU_MARKS = (
    ("namespace {\n\nusing namespace lane_engine;",
     "__device__ unsigned long long le_cycles[16];\nnamespace {\n\nusing namespace lane_engine;"),
    ("  for (int t = 0; t < ntiles; ++t) {\n    const int b0",
     "  long long acc[2][7] = {};\n  long long last = clock64();\n"
     "  for (int t = 0; t < ntiles; ++t) {\n    const int b0"),
    ("        lane_step(s, la, a.idx0 + b0 + x, i, k);",
     "        long long mk[6];\n        const int32_t h0 = s.n_hit_list;\n"
     "        lane_step(s, la, a.idx0 + b0 + x, i, k, mk);\n"
     "        const int ty = s.n_hit_list != h0 ? 0 : 1;\n"
     "        for (int q = 0; q < 5; ++q) acc[ty][q] += mk[q + 1] - mk[q];\n"
     "        acc[ty][5] += mk[0] - last;\n        acc[ty][6] += 1;\n        last = mk[5];"),
    ("  // -- write the lane back",
     "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
     "    for (int y = 0; y < 2; ++y)\n"
     "      for (int q = 0; q < 7; ++q) le_cycles[y * 8 + q] += acc[y][q];\n"
     "  // -- write the lane back"),
)
CU_TAIL = """
extern "C" int repro_lane_engine_cycles(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, le_cycles, sizeof(le_cycles));
  unsigned long long z[16] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(le_cycles, z, sizeof(z));
  return (int)e;
}
"""


def patched(text: str, marks, what: str) -> str:
    for anchor, repl in marks:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{what}: the anchor {anchor[:40]!r} does not occur once; the "
                               f"step changed, so update this script's marks")
        text = text.replace(anchor, repl)
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("lane_engine_cycles: no CUDA device", file=sys.stderr)
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
    out = _build.BUILD_DIR / "cycles"
    out.mkdir(parents=True, exist_ok=True)
    csrc = _build.CSRC
    (out / "lane_engine.cuh").write_text(
        patched((csrc / "lane_engine.cuh").read_text(), CUH_MARKS, "lane_engine.cuh"))
    (out / "lane_engine.cu").write_text(
        patched((csrc / "lane_engine.cu").read_text(), CU_MARKS, "lane_engine.cu") + CU_TAIL)
    so = out / "lane_engine_cycles.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(out / "lane_engine.cu")],
                   check=True, capture_output=True, text=True, timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(str(so))
    fn = lib.repro_lane_engine
    fn.restype = ctypes.c_int
    fn.argtypes = le._ARGTYPES + [ctypes.c_int, ctypes.c_void_p]
    cycles = lib.repro_lane_engine_cycles
    cycles.restype = ctypes.c_int
    dev = torch.device("cuda")

    def measure(runner, P, O, label):
        buf = (ctypes.c_ulonglong * 16)()
        cycles(buf)                                   # reset
        Pd, Od = torch.from_numpy(P).to(dev), torch.from_numpy(O).to(dev)
        rc = le._call(fn, runner.st, runner._table, Pd, Od, runner.lengths, runner.share,
                      runner.idx, runner.B, runner.warmup, runner.ripple_from,
                      runner.ghost_retention, int(runner.route == "shared"),
                      torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        if rc != 0 or cycles(buf) != 0:
            raise RuntimeError(f"instrumented launch failed: cudaError {rc}")
        runner.idx += P.shape[1]
        v = list(buf)
        for y, kind in ((0, "list hit"), (1, "attach")):
            n = max(v[y * 8 + 6], 1)
            segs = ", ".join(f"{name} {v[y * 8 + q] / n:.0f}" for q, name in enumerate(SEGMENTS))
            print(f"{label}, route {runner.route}, block 0, {kind} x{v[y * 8 + 6]}: cycles a "
                  f"step: {segs}; sum {sum(v[y * 8 + q] for q in range(6)) / n:.0f}", flush=True)

    rng = np.random.default_rng(7)
    # Table I: 8 b-combos x 4 replicas, warmed by 200,000 requests a lane
    grid = ((8, 8, 8), (8, 8, 64), (8, 64, 8), (8, 64, 64),
            (64, 8, 8), (64, 8, 64), (64, 64, 8), (64, 64, 64))
    combos = np.repeat(np.asarray(grid, np.int64), 4, axis=0)
    lam = irm.rate_matrix(1000, (0.75, 0.5, 1.0))

    def sample1(m):
        t = irm.sample_trace(lam, 4 * m, seed=int(rng.integers(2**31)))
        rep = np.arange(len(combos)) % 4
        return (t.proxies.reshape(4, m)[rep].astype(np.int32),
                t.objects.reshape(4, m)[rep].astype(np.int32))

    r1 = BatchedCudaRunner(SimParams(allocations=grid[-1], physical_capacity=1000), 1000,
                           np.ones(1000, np.int64), 0, 0, 6, len(combos), b_sweep=combos,
                           bhat_sweep=combos, device=dev)
    r1.feed(*sample1(200_000))
    measure(r1, *sample1(65_536), "Table I (lane 0: b=(8, 8, 8))")
    del r1
    # Fig. 2: 16 lanes, warmed by 100,000 requests a lane
    allocs = (1000, 1000, 1000, 2000, 2000, 2000, 7000, 7000, 7000)
    lam2 = irm.rate_matrix(1_000_000, tuple(0.5 + 0.5 * i for i in range(9)))

    def sample2(m):
        t = irm.sample_trace(lam2, 16 * m, seed=int(rng.integers(2**31)))
        return (t.proxies.reshape(16, m).astype(np.int32),
                t.objects.reshape(16, m).astype(np.int32))

    r2 = BatchedCudaRunner(SimParams(allocations=allocs, physical_capacity=sum(allocs)),
                           1_000_000, np.ones(1_000_000, np.int64), 0, 0, 2520, 16, device=dev)
    r2.feed(*sample2(100_000))
    measure(r2, *sample2(16_384), "Fig. 2")
    return 0


if __name__ == "__main__":
    sys.exit(main())
