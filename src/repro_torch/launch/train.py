"""Training launcher: config-driven, checkpoint/restart, straggler +
failure handling (the reference's ``repro.launch.train``), on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --steps 6 --batch 4 --seq 1024 --remat
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt --device cpu
    # resume after any interruption:
    ... --resume

``--device`` defaults to the card (none there: it raises; name ``cpu`` to
run the plain PyTorch path). The optimizer, schedule and ``TrainConfig``
defaults (bf16 compute over f32 masters) are the reference's.
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models import make_model
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
from repro_torch.training.checkpoint import Checkpointer
from repro_torch.training.compression import CompressionConfig
from repro_torch.training.elastic import FailureInjector, SimulatedNodeFailure, StragglerMonitor
from repro_torch.training.train_step import init_train_state


def build(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = make_model(cfg, remat=args.remat)
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=min(50, args.steps // 10 + 1),
                              total_steps=args.steps),
        microbatches=args.microbatches,
        compression=CompressionConfig() if args.compress_grads else None,
    )
    step_fn = make_train_step(model, tcfg)
    data = SyntheticLMData(cfg.vocab_size, args.seq, args.batch, seed=args.data_seed)
    return cfg, model, tcfg, step_fn, data


def main(argv=None, *, on_step: Optional[Callable[[int, float, float], None]] = None) -> int:
    """Trains as the arguments say; ``on_step(step, loss, seconds)`` is
    called after each completed step (``seconds``: the step on the host
    clock, up to the loss on the host). Returns 0 when the loss fell
    (or the run is shorter than 20 steps), else 1."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-seed", type=int, default=0)
    ap.add_argument("--simulate-failures", default="",
                    help="comma-separated steps at which to inject a failure")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: the card) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg, model, tcfg, step_fn, data = build(args)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    monitor = StragglerMonitor()
    injector = FailureInjector([int(s) for s in args.simulate_failures.split(",") if s])

    def fresh_state():
        return init_train_state(model, torch.Generator(device=device).manual_seed(args.seed),
                                tcfg)

    state = fresh_state()
    start_step = 0
    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        state, extras = ckpt.restore(None, state)
        start_step = int(extras["step"])
        data.restore(extras["data"])
        print(f"[resume] restored step {start_step}")

    losses = []
    step = start_step
    while step < args.steps:
        batch = {k: torch.as_tensor(v, device=device) for k, v in data.next_batch().items()}
        t0 = time.perf_counter()
        try:
            injector.maybe_fail(step)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
        except SimulatedNodeFailure as e:
            print(f"[failure] {e}; recovering from checkpoint")
            if ckpt is None or ckpt.latest_step() is None:
                print("[failure] no checkpoint — restarting from scratch")
                state = fresh_state()
                data = SyntheticLMData(cfg.vocab_size, args.seq, args.batch,
                                       seed=args.data_seed)
                step = 0
            else:
                state, extras = ckpt.restore(None, state)
                step = int(extras["step"])
                data.restore(extras["data"])
            continue
        dt = time.perf_counter() - t0
        if monitor.observe(step, dt):
            print(f"[straggler] step {step} took {dt:.2f}s")
        losses.append(loss)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms, lr {float(metrics['lr']):.2e})")
        if on_step is not None:
            on_step(step, loss, dt)
        step += 1
        if ckpt is not None and step % args.ckpt_every == 0:
            ckpt.save_async(step, state, {"step": step, "data": data.state()})
    if ckpt is not None:
        ckpt.save(args.steps, state, {"step": args.steps, "data": data.state()})
    n = max(len(losses) // 10, 1)
    first, last = np.mean(losses[:n]), np.mean(losses[-n:])
    print(f"done: loss {first:.4f} -> {last:.4f} "
          f"({len(monitor.stragglers)} stragglers flagged)")
    if device.type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
    return 0 if (last < first or args.steps < 20) else 1


if __name__ == "__main__":
    sys.exit(main())
