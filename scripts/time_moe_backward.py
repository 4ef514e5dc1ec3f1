#!/usr/bin/env python3
"""Times one granite-moe-1b-a400m MoE layer's forward and backward on one
NVIDIA card: the port's dispatch and combine functions beside the plain
gathers whose backward autograd makes a sorted scatter-add.

    python3 scripts/time_moe_backward.py [--seed N] [--reps 20] [--shift 1.0]

One layer at the training cell's shape: N = 4096 tokens (B=4 x T=1024),
d 1024, 32 experts of 512, top-8, capacity 1.25 (C = 1280), bf16 experts
over an f32 router, weights drawn on the card from the seed. Three
inputs: i.i.d. normal rows; rows repeated as Zipf (alpha 1.1) draws from
a vocabulary-sized table, as a batch of text repeats its tokens
(repeated rows route alike and overflow their experts); and i.i.d. rows
plus one shared normal row times ``--shift``, which sends most tokens to
the same experts, as a router that favours a few does. For each input it
prints the routing's empty slots, its dropped choices and the longest
run of one clamped slot among a choice's gathers (the most choices j
dropped), then for each formulation the
median ms (CUDA events, ``--reps`` calls after a warm-up) of the forward
and of forward plus backward, the top device kernels of one forward and
backward under ``torch.profiler``, and how far its output and gradients
(x, the router, the three expert weights) are from the functions'. One
JSON line per input. Exits 2 without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402

B, T, ZIPF_ALPHA = 4, 1024, 1.1
NAMES = ("router", "w_gate", "w_up", "w_down")


def gather_dispatch(xf, r, E):
    """The dispatch before its function: an int32 slot -> token table
    (empty slots read token 0), one gather; autograd's backward of it is
    an index_put with accumulate."""
    N = xf.shape[0]
    C, dest = r["C"], r["dest"]
    token_ids = torch.arange(N, dtype=torch.int32, device=xf.device)
    slot_tok = torch.zeros((E * C + 1,), dtype=torch.int32, device=xf.device)
    for j in range(dest.shape[1]):
        slot_tok[dest[:, j]] = token_ids
    return xf[slot_tok[: E * C].reshape(E, C).long()]


def gather_combine(ye, r, dtype):
    """The combine before its function: dropped choices clamped onto slot
    E C - 1 at weight 0, one gather a choice, summed in f32."""
    E, C, d = ye.shape
    keep, dest, top_w = r["keep"], r["dest"], r["top_w"]
    out = torch.zeros((dest.shape[0], d), dtype=torch.float32, device=ye.device)
    for j in range(dest.shape[1]):
        w_j = (top_w[:, j] * keep[:, j]).float()
        slot = torch.clamp(dest[:, j], max=E * C - 1)
        out = out + ye[slot // C, slot % C].float() * w_j[:, None]
    return out.to(dtype)


FORMS = {"functions": (moe.moe_dispatch, moe.moe_gather),
         "plain_gathers": (gather_dispatch, gather_combine)}


def layer(cfg, p, x, ct, form, backward=True):
    """One MoE layer's output on x and, with ``backward``, the gradients of
    <out, ct> + aux with respect to x and ``NAMES``."""
    dispatch, combine = FORMS[form]
    r = moe.moe_route(x, p, cfg, capacity_factor=cfg.capacity_factor)
    out = combine(moe.expert_ffn(dispatch(x, r, cfg.n_experts), p), r, x.dtype)
    if not backward:
        return out, None
    loss = (out.float() * ct).sum() + r["aux"]
    return out, torch.autograd.grad(loss, [x] + [p[n] for n in NAMES])


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def top_kernels(fn, n: int = 6) -> list:
    """[name, device ms] of the n kernels that take most of one call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    return [[k[:80], round(ms, 4)] for k, ms in sorted(rows, key=lambda r: -r[1])[:n]]


def inputs(cfg, kind: str, gen, dev, shift: float):
    N, d = B * T, cfg.d_model
    if kind != "zipf":
        x = torch.randn((N, d), generator=gen, device=dev)
        if kind == "shifted":
            x += shift * torch.randn((1, d), generator=gen, device=dev)
        return x.to(torch.bfloat16)
    V = cfg.vocab_size
    probs = torch.arange(1, V + 1, device=dev, dtype=torch.float64) ** -ZIPF_ALPHA
    ids = torch.multinomial(probs.float(), N, replacement=True, generator=gen)
    table = torch.randn((V, d), generator=gen, device=dev).to(torch.bfloat16)
    return table[ids]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--shift", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-moe-1b-a400m")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p = moe.moe_init(gen, cfg, torch.bfloat16, dev)
    p = {n: p[n].requires_grad_(True) for n in NAMES}
    for kind in ("iid", "zipf", "shifted"):
        x = inputs(cfg, kind, gen, dev, args.shift).requires_grad_(True)
        ct = torch.randn(x.shape, generator=gen, device=dev)
        r = moe.moe_route(x.detach(), p, cfg, capacity_factor=cfg.capacity_factor)
        E, C = cfg.n_experts, r["C"]
        kept = int(r["keep"].sum())
        line = {"input": kind, "N": x.shape[0], "d": cfg.d_model, "E": E, "k": cfg.top_k,
                "C": C, "slots": E * C, "empty_slots": E * C - kept,
                "dropped_choices": int((~r["keep"]).sum()),
                "longest_clamped_run": int((~r["keep"]).sum(0).max()),
                "device": torch.cuda.get_device_name(dev)}
        want, want_g = layer(cfg, p, x, ct, "functions")
        for form in FORMS:
            out, g = layer(cfg, p, x, ct, form)
            line[form] = {
                "forward_ms": median_ms(lambda: layer(cfg, p, x, ct, form, backward=False),
                                        args.reps),
                "forward_backward_ms": median_ms(lambda: layer(cfg, p, x, ct, form), args.reps),
                "top_kernels": top_kernels(lambda: layer(cfg, p, x, ct, form)),
                "out_equal": bool(torch.equal(out, want)),
                "grad_rel_gap": {n: float((a.float() - b.float()).abs().max()
                                          / b.float().abs().max().clamp(min=1e-30))
                                 for n, a, b in zip(("x",) + NAMES, g, want_g)},
            }
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
