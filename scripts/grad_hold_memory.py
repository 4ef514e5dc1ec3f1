#!/usr/bin/env python3
"""Runs phase 9's (i6) and (i8) gradient holds of ``chip_smoke.py`` alone
on one NVIDIA card: deepseek-v2-236b at 1 of 60 layers, full width, B=1 x
T=1024, one plain loss and gradient, then the same partitioned over
``model`` (MLA and the MoE; then with the embedding and the head split on
their vocabulary too) in a one-rank NCCL group, each held to the plain
one bit for bit.

    python3 scripts/grad_hold_memory.py [--seed N]

Each partitioned pass prints the device memory allocated before it and
its own peak (``chip_smoke.partitioned_grad_hold``): what an earlier pass
leaves allocated shows there. About 70 s. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs

    device = torch.device("cuda")
    print(cs.nvidia_smi(), flush=True)
    with cs.one_rank_group(device):
        mesh = cs.launch_mesh.make_mesh((1, 1), ("data", "model"), device=device)
        r = cs.partitioned_grad_hold(device, cs.Sizes(), args.seed, mesh)
    print({k: v for k, v in r.items() if k != "vocab"}, r["vocab"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
