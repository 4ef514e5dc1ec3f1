"""The training cells: the port's train step (``make_train_step`` over an
AdamW state of f32 masters, bf16 compute) driven on the traffic mix's
batches for the window.

Set-up draws the parameters from the seed, builds the one train step and
its state, and drives them through the mix's first steps on the window's
own feed: those steps warm every shape, and the first ``compared_steps``
are the ones the reference follows (each step's loss, the first
gradient's norm by leaf worked out from the moments after one step, and
each leaf's change after the last compared step, its norm and up to
``compare.SAMPLE`` of its elements drawn from the seed, read before the
next step moves it). The window then runs steps until ``--seconds`` have
passed, each read to the host as the launcher reads it (``float(loss)``).
After it, a traced run profiles ``profiled_steps`` more; then the
program's state is freed and the reference runs its steps in f32 with
TF32 off.

A cell on more than one chip runs this on every rank: set-up and the
window start and end at a barrier, and every rank ends the window on the
same step.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import torch

from chipbench import archs

from . import compare, traffic, weights, yardstick
from .profiling import Profile, Session
from .record import Record, check, free, log, passed


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def first_grad_norms(state, metrics, o: dict) -> Dict[str, float]:
    """Each leaf's first gradient norm as the optimizer was handed it: its
    first moment after one step is (1 - b1) x scale x g, with the clip
    scale from the step's global gradient norm."""
    gnorm = float(metrics["grad_norm"])
    scale = min(o["grad_clip"] / max(gnorm, 1e-12), 1.0)
    mu = weights.unnest(state["opt"]["mu"])
    return {n: float(torch.linalg.vector_norm(t.double())) / ((1 - o["b1"]) * scale)
            for n, t in mu.items()}


def change_readings(state, c: dict, seed: int, device, rank: int = 0, world: int = 1) -> tuple:
    """Each leaf's distance from its starting values (drawn again), and
    the elements of its change that the reference's are held to
    (:func:`compare.kept_change`)."""
    now = weights.unnest(state["params"])
    keep = compare.kept_change(seed, device)
    norms, kept = {}, {}
    with torch.no_grad():
        for i, (n, p0) in enumerate(weights.leaves(c, seed, device, rank=rank, world=world)):
            d = now[n].double() - p0.double()
            norms[n], kept[n] = float(torch.linalg.vector_norm(d)), keep(i, d)
    return norms, kept


def start(cell, seed: int, device, hooks: Optional[Dict[str, Callable]] = None):
    """Set-up: the parameters drawn from the seed, the one train step and
    its state, driven through the mix's ``setup_steps`` on the window's
    feed. Returns (state, step_fn, feed, prog: the compared readings)."""
    from repro_torch.training import AdamWConfig, TrainConfig
    from repro_torch.training.optimizer import adamw_init

    hooks = hooks or {}
    c, mix, share = cell.config, cell.traffic, dict(rank=cell.ranks.rank, world=cell.ranks.world)
    arch, o, n_cmp = archs.of(c), mix["optimizer"], mix["compared_steps"]
    model = arch.make_model(c, cell.ranks, remat=mix["remat"])
    step_fn = arch.make_train_step(model, TrainConfig(optimizer=AdamWConfig(**o)), cell.ranks)
    if "step" in hooks:
        step_fn = hooks["step"](step_fn)
    params = weights.nest(weights.flat(c, seed, device, **share))
    state = {"params": params, "opt": adamw_init(params)}
    feed = traffic.TokenFeed(seed, c["vocab_size"], mix["batch"], mix["seq"], mix["zipf_alpha"],
                             device)
    prog = {"loss": []}
    for k in range(mix["setup_steps"]):
        state, m = step_fn(state, feed.next())
        loss = float(m["loss"])
        if k < n_cmp:
            prog["loss"].append(loss)
        if k == 0:
            prog["grad_norm"] = first_grad_norms(state, m, o)
        if k == n_cmp - 1:
            prog["change_norm"], prog["change_sample"] = change_readings(state, c, seed, device,
                                                                         **share)
    return state, step_fn, feed, prog


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        hooks: Optional[Dict[str, Callable]] = None) -> Record:
    hooks = hooks or {}
    c, mix, ranks = cell.config, cell.traffic, cell.ranks
    B, T = mix["batch"], mix["seq"]
    rec = Record(cell.name, "train")
    state, step_fn, feed, prog = start(cell, seed, device, hooks)
    _sync(device)
    ranks.barrier()
    rec.setup_s = time.perf_counter() - t_start
    log(f"set-up {rec.setup_s:.2f} s", t_start)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    losses, steps = [], 0
    w0 = time.perf_counter()
    while True:
        state, m = step_fn(state, feed.next())
        losses.append(float(m["loss"]))
        steps += 1
        if ranks.any(time.perf_counter() - w0 >= seconds):
            break
    ranks.barrier()
    rec.window_s = time.perf_counter() - w0
    rec.counters.update(window_steps=steps, window_tokens=steps * B * T,
                        window_peak_bytes=(torch.cuda.max_memory_allocated(device)
                                           if device.type == "cuda" else 0))
    if trace:
        rec.profile = Profile()
        with Session(device) as s:
            for _ in range(mix["profiled_steps"]):
                state, m = step_fn(state, feed.next())
                losses.append(float(m["loss"]))
        rec.profile.add("step", s)
        rec.counters["profiled_steps"] = mix["profiled_steps"]
    if device.type == "cuda":
        rec.memory_peak_bytes = max(peak, torch.cuda.max_memory_allocated(device))
    rec.attempted = len(losses) + mix["setup_steps"]
    rec.failed = sum(not math.isfinite(x) for x in losses + prog["loss"])
    arch = archs.of(c)
    attn = arch.attention_work(c, B, T, lse=True)
    rec.work.update(step_flops=arch.train_step_flops(c, B, T),
                    k3_bound_ms=yardstick.bound_ms(*attn["k3"])[0],
                    k3bwd_bound_ms=yardstick.bound_ms(*attn["k3bwd"])[0])

    log(f"window {rec.window_s:.2f} s, {steps} steps; traced {trace}", t_start)
    del state, m, step_fn
    free(device)
    ref = reference_readings(c, mix, seed, device, rank=ranks.rank, world=ranks.world)
    for name, (value, where) in compare.train_readings(prog, ref).items():
        if name in cell.limits:
            check(rec, name, value, cell.limits[name], f"at {where}")
        else:                       # a reading with no limit: printed, not compared
            log(f"reading {name} {value!r} (at {where}; not compared)", t_start)
    check(rec, "nonfinite_losses", rec.failed, 0)
    rec.correct = passed(rec)
    log("reference done", t_start)
    return rec


def reference_readings(c: dict, mix: dict, seed: int, device, dtype=torch.float32,
                       rows: slice = slice(None), rank: int = 0, world: int = 1) -> dict:
    """The reference's readings of the compared steps, on the same
    parameters and batches (``rows`` of each), in ``dtype``: f32 with TF32
    off, or the control's lower precision; rank ``rank``'s share of
    ``world``."""
    from chipbench.reference import train as ref_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    feed = traffic.TokenFeed(seed, c["vocab_size"], mix["batch"], mix["seq"], mix["zipf_alpha"],
                             device)
    batches = [feed.batch(k) for k in range(mix["compared_steps"])]
    def initial():
        return weights.leaves(c, seed, device, rank=rank, world=world)

    params = {n: t.to(dtype) for n, t in initial()}
    out = ref_train.readings(params, initial, c, mix["optimizer"], batches,
                             loss=archs.of(c).reference.loss, batch_rows=rows,
                             keep=compare.kept_change(seed, device))
    del params
    free(device)
    return out
