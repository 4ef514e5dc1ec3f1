#!/usr/bin/env python3
"""Times K3-bwd (attention's backward) of one source tree on one NVIDIA card.

    python3 scripts/time_flash_attention_bwd.py [--src TREE/src] [--seed N]

Imports ``repro_torch`` from ``--src`` (this repository's ``src`` by
default) before ``chip_smoke``, so that ``chip_smoke.k3_bwd_times`` times
that tree's kernel: flushed (``median_ms``) and back to back in a CUDA
graph, beside the backward of SDPA through autograd (min and median) and
the bound, at ``chip_smoke.bwd_timing_shapes``: qwen3-1.7b's training
shape (B=4, T=1024, H=16, KV=8, D=128, causal), granite-moe-1b's (D=64),
deepseek-v2's MLA (H=128, 192/128 padded to 256) and hubert's encoder
(T=1000, 80 padded to 128, non-causal), all bf16 (``chip_smoke.py``
times the plain version beside them). Two trees, e.g. a commit and its
parent unpacked with ``git archive``, are timed in turns, one process
each; the tree's ``repro_torch`` must hold the modules ``chip_smoke.py``
imports.

Also prints, for the tree's library: ptxas's registers and spills of
each kernel (when this process built it), the count of each kernel's
tensor-core instructions in its SASS (``cuobjdump -sass``: HGMMA is
wgmma, HMMA mma.sync), and, at each shape, the device ms of each of the
three launches (delta, dK/dV, dQ) under ``torch.profiler``. A last line
times a one-element add under the same flush, the timing's own floor.
Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _demangle(text: str, nvcc: str) -> str:
    filt = Path(nvcc).with_name("cu++filt")
    if not filt.exists():
        return text
    return subprocess.run([str(filt)], input=text, capture_output=True, text=True, check=True,
                          timeout=60).stdout


def sass_counts(lib: Path, nvcc: str) -> dict:
    """{kernel: {"HGMMA": n, "HMMA": m}} from ``cuobjdump -sass`` of lib."""
    dump = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(lib)],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = {"HGMMA": 0, "HMMA": 0}
        elif name is not None:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", line):
                    counts[name][op] += 1
    names = _demangle("\n".join(counts), nvcc).splitlines()
    return {n: counts[k] for n, k in zip(names, counts)}


def launch_ms(fn, n: int = 5) -> dict:
    """Device ms a call of each kernel fn launches, by kernel name, under
    torch.profiler (n calls after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = defaultdict(float)
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if t:
            out[e.key] += t / 1e3 / n
    return dict(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_flash_attention_bwd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build  # the tree's kernels
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(f"card: {cs.nvidia_smi()}; tree {args.src}", flush=True)
    report = _build.build(["flash_attention_bwd"]).get("flash_attention_bwd", "")
    nvcc = _build._nvcc()
    for line in _demangle(report, nvcc).splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"[ptxas] {line.strip()}", flush=True)
    for name, c in sass_counts(_build.library_path("flash_attention_bwd"), nvcc).items():
        print(f"[sass] {name}: HGMMA {c['HGMMA']}, HMMA {c['HMMA']}", flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    sizes = cs.Sizes()
    for shape in cs.bwd_timing_shapes(sizes):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        r = cs.k3_bwd_times(shape, gen, dev, flush, plain=False)
        cs._log_bwd_timing(r)
        B, T, H, KV, Dqk, Dv, causal = shape
        D = cs.kernel_head_dim(max(Dqk, Dv))
        q, do = (torch.randn(B, T, H, D, device=dev).to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, T, KV, D, device=dev).to(torch.bfloat16) for _ in range(2))
        out, lse = cs.flash_attention_fwd(q, k, v, causal=causal)
        per = launch_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, causal=causal))
        print(f"[launches] {r['shape']}: "
              + ", ".join(f"{k[:48]} {ms:.4f} ms" for k, ms in sorted(per.items())), flush=True)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
    x = torch.zeros(1, device=dev)
    print(f"[floor] one-element add under the flush: "
          f"{cs.median_ms(lambda: x.add_(1), flush):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
