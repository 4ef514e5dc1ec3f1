#!/usr/bin/env python3
"""Times recurrentgemma-2b's local attention and training step for one
source tree of the port on one NVIDIA card.

    python3 scripts/time_local_attention.py [--src TREE/src] [--steps 6] [--seed N]

Imports ``repro_torch`` from ``--src`` (this repository's ``src`` by
default) and measures, through that tree's own code:

1. one local block's attention at the training shape (B=1, T=4096,
   H=10, KV=1, D=256, causal, window 2048, bf16) through
   ``models.attention._sequence_attention``: the forward alone under
   ``torch.inference_mode`` (a prefill's), and the forward with its
   backward (``torch.autograd.grad``), each flushed (256 MiB written
   before each call) and timed with CUDA events, medians of 20;
2. the launcher's run of recurrentgemma-2b at full width and depth (B=1 x
   T=4096, ``--remat``, ``--steps`` steps): each step's ms on the host
   clock, and the last step but one under ``torch.profiler``: the card's
   busy ms (kernel and copy time) and, of it, the device ms of the
   kernels launched inside the local attention, read from two
   ``record_function`` ranges this script wraps around
   ``_sequence_attention`` (forward, run twice a step at ``--remat``) and
   around the backward of every attention autograd function the tree
   defines (``models.attention.FlashGrouped``,
   ``kernels.flash_attention.FlashAttention``).

Two trees (a commit and its parent unpacked with ``git archive``) are
compared in one call, one process each, in turns. ``--device cpu
--reduced`` rehearses it on the CPU at the reduced config (no times).
Exits 2 without a card when ``--device`` is not cpu.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-2b"
RANGES = ("local_attention.forward", "local_attention.backward")


def _wrap_ranges(attention, k3) -> None:
    """record_function ranges around the tree's local attention: its
    forward, and the backward of each autograd function it may apply."""
    from torch.profiler import record_function

    seq = attention._sequence_attention

    def forward(q, k, v, *, causal, window):
        if window <= 0:
            return seq(q, k, v, causal=causal, window=window)
        with record_function(RANGES[0]):
            return seq(q, k, v, causal=causal, window=window)

    attention._sequence_attention = forward
    for fn in (getattr(attention, "FlashGrouped", None), getattr(k3, "FlashAttention", None)):
        if fn is None:
            continue
        bwd = fn.backward

        def backward(ctx, *grads, _bwd=bwd):
            with record_function(RANGES[1]):
                return _bwd(ctx, *grads)

        fn.backward = staticmethod(backward)


def _median_ms(fn, flush, n: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def layer_times(attention, cfg, device, seq: int, seed: int) -> dict:
    """The local block's attention at (1, seq) tokens, forward and forward +
    backward, through the tree's ``_sequence_attention``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v, do = (torch.randn(s, generator=gen, device=device).to(torch.bfloat16)
                   for s in ((1, seq, H, D), (1, seq, KV, D), (1, seq, KV, D), (1, seq, H, D)))
    qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))

    def fwd():
        with torch.inference_mode():
            attention._sequence_attention(q, k, v, causal=True, window=cfg.window)

    def fwd_bwd():
        out = attention._sequence_attention(qs, ks, vs, causal=True, window=cfg.window)
        torch.autograd.grad(out, (qs, ks, vs), do)

    if device.type != "cuda":
        fwd()
        fwd_bwd()
        return dict(forward_ms=None, forward_backward_ms=None)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    return dict(forward_ms=_median_ms(fwd, flush), forward_backward_ms=_median_ms(fwd_bwd, flush))


def step_times(train, device, steps: int, seq: int, seed: int, reduced: bool) -> dict:
    """The launcher's run; the last step but one profiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    ms, prof, at = [], {}, steps - 2

    def on_step(step: int, loss: float, dt: float) -> None:
        ms.append(1e3 * dt)
        if step == at - 1:
            prof["p"] = profile(activities=acts)
            prof["p"].start()
        elif step == at and "p" in prof:
            if device.type == "cuda":
                torch.cuda.synchronize()
            prof["p"].stop()

    argv = ["--arch", ARCH, "--steps", str(steps), "--batch", "1", "--seq", str(seq),
            "--lr", "3e-3", "--remat", "--seed", str(seed), "--data-seed", str(seed),
            "--log-every", str(steps), "--device", device.type] + ["--reduced"] * reduced
    rc = train.main(argv, on_step=on_step)
    if rc != 0 or len(ms) != steps:
        raise RuntimeError(f"the launcher returned {rc} after {len(ms)} steps")
    rows = prof["p"].key_averages()
    busy = sum(e.self_device_time_total for e in rows
               if e.device_type != DeviceType.CPU) / 1e3
    local = {r: sum(e.device_time_total for e in rows if e.key == r) / 1e3 for r in RANGES}
    calls = {r: sum(e.count for e in rows if e.key == r) for r in RANGES}
    return dict(step_ms=ms, median_ms=statistics.median(ms[1:]), profiled_step=at,
                busy_ms=busy if device.type == "cuda" else None,
                local_ms=local if device.type == "cuda" else None, local_calls=calls)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("time_local_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as k3
    from repro_torch.launch import train
    from repro_torch.models import attention

    device = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(ARCH).reduced() if args.reduced else get_config(ARCH)
    seq = 2 * cfg.window                       # 4096 at full size: past the window
    _wrap_ranges(attention, k3)
    card = (torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu")
    t0 = time.perf_counter()
    out = dict(src=args.src, card=card, shape=dict(B=1, T=seq, H=cfg.n_heads, KV=cfg.n_kv_heads,
                                                   D=cfg.head_dim, window=cfg.window))
    out["layer"] = layer_times(attention, cfg, device, seq, args.seed)
    out["run"] = step_times(train, device, args.steps, seq, args.seed, args.reduced)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
