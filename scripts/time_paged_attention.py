#!/usr/bin/env python3
"""Times K1 (paged decode attention) of one source tree on one NVIDIA card.

    python3 scripts/time_paged_attention.py [--src TREE/src] [--seed N]

Imports ``repro_torch`` from ``--src`` (this repository's ``src`` by
default) before ``chip_smoke``, so that ``chip_smoke.k1_kernel_times``
times that tree's kernel: flushed (``median_ms``), back to back in a CUDA
graph and host-inclusive (the host clock around a call and a synchronize).
Two trees, e.g. a commit and its parent unpacked with ``git archive``, are
timed in turns, one process each; the tree's ``repro_torch`` must hold the
modules ``chip_smoke.py`` imports. Prints the card's name and power limit,
then one line per shape with the byte bound of reading every sequence's
pages once. Shapes (qwen3-1.7b's heads, H=16, KV=8, D=128, bf16, pages of
16 tokens, each sequence's pages distinct): a small batch with a long
context (B=4, ctx=4096), the serving phase's batch (B=64, ctx=1280), and
B=4 with ctx=0, a launch with nothing to read. A last line times a
one-element add under the same flush, the timing's own floor. Exits 2
without a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ((4, 4096), (64, 1280), (4, 0))      # (B, ctx)
H, KV, D, PAGE = 16, 8, 128, 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_paged_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels.paged_attention import paged_attention  # the tree's kernel

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    print(f"card: {cs.nvidia_smi()}; tree {args.src}", flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for B, ctx in SHAPES:
        n = max(1, ctx // PAGE)
        kp, vp = (cs._randn(gen, (KV, B * n, PAGE, D), torch.bfloat16, dev) for _ in range(2))
        bt = torch.randperm(B * n, generator=gen, device=dev).to(torch.int32).reshape(B, n)
        q = cs._randn(gen, (B, H, D), torch.bfloat16, dev)
        cl = torch.full((B,), ctx, dtype=torch.int32, device=dev)
        r = cs.k1_kernel_times(lambda: paged_attention(q, kp, vp, bt, cl), flush)
        bound = (2 * B * ctx * KV * D * 2 + 2 * q.numel() * 2) / cs.HBM_BYTES_PER_S * 1e3
        print(f"[k1] B={B} H={H} KV={KV} D={D} ctx={ctx} page={PAGE}, distinct pages: "
              f"{r['ms']:.4f} ms flushed, {r['graph_ms']:.4f} ms back to back, "
              f"{r['host_ms']:.4f} ms host-inclusive, byte bound {bound:.4f} ms", flush=True)
        del kp, vp
    x = torch.zeros(1, device=dev)
    print(f"[k1] one-element add under the flush: {cs.median_ms(lambda: x.add_(1), flush):.4f} ms",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
