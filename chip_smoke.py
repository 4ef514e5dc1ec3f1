#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port's serving paths, its estimator loop and its
training path once on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught to carry on):

1. env       card name and power limit, torch/CUDA versions, the build
             of every kernel under src/repro_torch/kernels/csrc with nvcc
             (one nvcc per source, all started together: K1, K2, K3,
             K3-bwd and the lane engine), each kernel's
             ptxas report (registers, spills) and the launch K1, K2 and K3
             get at this run's shapes (cluster size, stages, shared memory);
2. kernels   each CUDA kernel against its plain PyTorch version on the card,
             over the shape grids of tests/test_kernels.py and the port's
             tests in f32 and bf16 and at this run's own shapes, K2 also at
             a 4096-token prefix with lengths from 0 to S, K3 through the
             op that pads the widths it is not built for (MLA's 192/128,
             hubert's 80) against the unpadded plain version;
3. serving   the engine at the full qwen3-1.7b KV geometry admits three
             tenants over a 16384-block pool and takes 1024 requests; pages
             are written once when allocated, and every 64 requests the
             resident ones decode one token through paged attention (K1);
4. grouped   8 prefix groups of 16 resident requests decode through
             shared-prefix attention (K2) + suffix attention + LSE merge,
             held to the plain version and to K1 over each full table;
5. live      the engine in live mode serves 8 requests of 1280 tokens, 16
             new tokens each, with each of three models at full width and
             depth (bf16 weights from --seed): qwen3-1.7b (dense), granite-
             moe-1b (MoE, 32 experts top-8) and recurrentgemma-2b (RG-LRU
             and local-attention blocks). Each prompt is prefilled, then
             decoded greedily on dense caches and recurrent states. The
             global attention of qwen3's and granite's prefills runs flash
             attention (K3), one launch a layer, and their first prefill is
             held to the same prefill with K3's plain version (granite's
             replaying the K3 prefill's MoE routing, RouteTape);
             recurrentgemma's windowed prefills run the plain chunked
             attention (no K3 launch), and its prefill of T-1 tokens and one
             decode step are held to its prefill of T tokens; then 4
             requests each with deepseek-v2-236b (MLA and 160 experts at
             full width, 4 of its 60 layers: K3 padded 192/128 -> 256, the
             routing replayed in its check), xlstm-125m (no K3; its decode
             consistency held in f32) and llava-next-mistral-7b (and one
             request with 1152 image tokens first, held to the plain
             prefill too), and 4 forwards of hubert-xlarge over 1000
             frames (the encoder: K3 padded 80 -> 128, non-causal; no
             engine, no decode);
6. admission the working-set virtual allocations on the card against the
             port's own CPU solve;
7. timing    each kernel, its plain version and a PyTorch yardstick at the
             main path's shapes (CUDA events, L2 flushed between launches),
             K1 first at a small batch with a long context (B=4, ctx=4096),
             and also back to back in a CUDA graph and host-inclusive (the
             host clock around a call and a synchronize), K2 first at a
             long prefix with a small group, K3 at each live model's shape
             (the padded ones with the true work's bound, the padded
             work's and the kernel alone on padded inputs);
8. estimator the paper's estimator loop at its published widths on the
             lane engine (one block per lane, its warp 0 walking the
             requests; the lane in shared memory where it fits, else in
             device memory): the Table I system (J=3, N=1000, B=1000,
             Zipf 0.75/0.5/1.0), its 8 b-combos x 4 replicas as 32 sweep
             lanes of one batched runner on the shared-memory route, and
             once more on the device-memory route, and the Fig. 2 system
             (J=9, N=1e6, 3x1000+3x2000+3x7000 units, Zipf 0.5..4.5), 16
             replicas on the device-memory route (about 3.2 GB of state);
             every lane held exactly to the kernel's host build and to the
             host C engine; Scenario.run() of the Table I preset with 4
             replicas on its default backend ("auto", which runs the lane
             engine on the card) against backend="c" (same_estimates);
             the Table II working-set solve of the 8 combos batched on
             the card against the CPU; then the lane engine timed per
             chunk on both routes beside its host build, the host C
             engine and its byte bound, with the timed chunk's mix of
             steps read from the lanes' counters and its evictions from
             their holder bits. Request counts per lane are cut from the
             paper's (printed); widths never are;
9. train     training on the card: (a) K3-bwd, the backward of flash
             attention, against its plain version in f32 and bf16 (and K3's
             lse against the plain lse) over tests/test_kernels.py's
             gradient shape and the training shapes of qwen3-1.7b (B=4,
             T=1024), granite-moe-1b, deepseek-v2's MLA (192/128 padded to
             256), hubert (80 padded to 128, non-causal), G = 1 and G = 8,
             and qwen3's at a ragged T=1000;
             (b) qwen3-1.7b at full width and 4 of its 28 layers, bf16
             compute over f32 masters, B=4 x T=1024: one step's loss and
             gradients through K3 + K3-bwd against the same with both
             plain versions on the card, and the attention parameters'
             gradients nonzero; (c) qwen3-1.7b at full width and depth
             (1.72 B f32 masters) takes 6 optimizer steps of B=4 x T=1024
             SyntheticLMData tokens through the launcher
             (repro_torch.launch.train.main, lr 3e-3, warmup 1, --remat),
             with per-step loss, ms, tokens/s and launches, the peak device
             memory and one step under torch.profiler; the loss must be
             finite and lower at step 6 than at step 1; (d) K3-bwd timed
             (flushed, and back to back in a CUDA graph) at qwen3's,
             granite's, MLA's and hubert's shapes (B=4) beside its plain
             version, the backward of SDPA through autograd (median and
             min) and its bound;
             (e) a one-rank group (NCCL, a file:// store) and a (data=1)
             mesh: qwen3-1.7b at 4 layers, its state placed replicated by
             reshard_state(state, Sharding(mesh)), takes 3 data-parallel
             steps and a copy 3 plain steps on the same batches: equal
             losses, every leaf bit-identical; the placed state saved and
             restored onto the mesh bit for bit; at full width and depth a
             step timed with and without the mesh, in turns, with the
             collectives a step; granite-moe-1b at 4 layers 2 steps each
             way, bit-identical (its aux sums and moe_chunks on the card);
             (f) granite-moe-1b (B=4 x T=1024) and recurrentgemma-2b (B=1 x
             T=4096, past its 2048-token window) at full width and depth, 6
             launcher steps each as (c), and a 4-layer gradient hold each as
             (b) (granite's routing replayed, RouteTape); (g)
             deepseek-v2 at 1 of 60 layers: one loss and gradient (B=1 x
             T=1024) through K3 and K3-bwd padded to 256 held to the plain
             route, the first gradients waiting in host memory;
10. launch   the launch modules through a one-rank NCCL group (a file://
             store in a temporary directory, no TCP port) and a (data=1,
             model=1) mesh: (a) qwen3-1.7b at full width and depth serves
             the live phase's requests again with the flash-decode
             override installed (repro_torch.launch.flash_decode): the
             same greedy tokens as without it, and a decode step's
             last-token logits within LIVE_LOGITS_RTOL; decode ms per
             token with and without it (at a model axis of 1 the
             difference is the collectives' fixed cost); (b) granite-
             moe-1b at full width and depth prefills with the expert-
             parallel MoE (repro_torch.launch.moe_ep): the same kept
             slots in every layer as moe_apply, logits within
             LIVE_LOGITS_RTOL, prefill ms with and without it; (c) the
             serving CLI (repro_torch.launch.serve --live) on the card;
             (d) input_specs of every config x shape cell on the meta
             device, the card's allocated memory unchanged.

The line before the last lists each kernel as JSON (launches on its path:
K1 and K2 in phases 3-4, K3 in phases 5, 9 and 10, the lane engine in
phase 8, K3-bwd in phase 9: its runs, (e)'s steps and (g)'s kernel route;
max error; times; bound); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.cacheblocks import layout_for  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.core import admission, fastsim, irm  # noqa: E402
from repro_torch.core.fastsim_cuda import BatchedCudaRunner  # noqa: E402
from repro_torch.core.shared_lru import _lcm_1_to  # noqa: E402
from repro_torch.core.workingset import solve_workingset_batch  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as k3_module  # noqa: E402
from repro_torch.kernels import paged_attention as k1_module  # noqa: E402
from repro_torch.kernels import shared_prefix_attention as k2_module  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_attention_plain,
    kernel_head_dim,
)
from repro_torch.kernels import lane_engine as le_module  # noqa: E402
from repro_torch.kernels.lane_engine import SCALARS, lane_engine  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
)
from repro_torch.kernels.shared_prefix_attention import (  # noqa: E402
    shared_prefix_attention,
    shared_prefix_attention_plain,
)
from repro_torch.models import make_model, moe, shardctx  # noqa: E402
from repro_torch.scenario import get_preset  # noqa: E402
from repro_torch.scenario.runner import _rates_for, derive_seeds, ensemble_seeds  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine, TenantSpec  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.launch import flash_decode, moe_ep, specs  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import Sharding  # noqa: E402
from repro_torch.training import AdamWConfig, TrainConfig, make_train_step  # noqa: E402
from repro_torch.training.elastic import reshard_state  # noqa: E402
from repro_torch.training.train_step import init_train_state, make_grad_fn  # noqa: E402
from repro_torch.training.tree import flatten_with_paths  # noqa: E402

# Tolerances of tests/test_kernels.py: out f32 / bf16, lse f32 / bf16.
ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_ATOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
# NVIDIA H100 SXM data sheet: HBM rate, dense peaks (f32 outside the
# tensor cores, bf16 on them).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
ADMISSION_RTOL = 1e-4   # card vs CPU float32 solve: sums in another order
# Full-depth bf16 prefill, K3 against its plain version: last-token logits
# within 5% of their largest magnitude. Both round each layer's attention
# output to bf16 (relative step 2^-8), K3 its probabilities too, from
# values that differ in the last bits; 28 layers carry those differences
# down the residual stream: 28 x 2^-9 = 0.055 if none cancelled.
LIVE_LOGITS_RTOL = 0.05
# recurrentgemma-2b in bf16, prefill(T-1) + one decode step against
# prefill(T): last-token logits within 5% of their largest magnitude. The
# two paths compute the last token in another order (the RG-LRU's doubling
# scan against its step, the conv's shifted adds against its einsum, the
# attention's chunked scan over T keys against one decode step), each
# rounded to bf16 per layer: 26 x 2^-9 = 0.051 if none cancelled.
DECODE_LOGITS_RTOL = 0.05
# xlstm-125m's decode consistency is held in f32 (an f32 copy of its
# parameters): its gates are exponential and its outputs num / max(|n q|,
# e^-m), so a last-bit difference between the prefill's chunkwise form and
# the step comes back amplified. At full width on the CPU (seed 0, T=1280)
# the f32 difference was 1.4e-4 of the logits' scale and the bf16 one
# 6.6-10% (three prompts; one greedy token differed): bf16 cannot be held
# to a rounding argument, f32 to 1e-3 (7x what the CPU showed).
DECODE_IN_F32 = {"xlstm-125m": 1e-3}

# phase 5 serves each in turn: dense, MoE (K3 at D=64), hybrid (no K3) ...
LIVE_ARCHS = ("qwen3-1.7b", "granite-moe-1b-a400m", "recurrentgemma-2b")
# ... then MLA (K3 padded from 192/128 to 256), xLSTM (no K3), the vision
# model (K3 at D=128; one more request with an image, 1152 tokens first)
# and the audio encoder (forwards over frames, no engine: K3 padded from 80
# to 128, non-causal), each serving sizes.more_requests requests
MORE_ARCHS = ("deepseek-v2-236b", "xlstm-125m", "llava-next-mistral-7b", "hubert-xlarge")
# layers kept where the full depth does not fit the card with room for its
# activations: deepseek-v2's 60 layers are 3.97 B parameters each (160
# routed experts), 4 of them and the embedding and head 33.9 GB in bf16
DEPTH = {"deepseek-v2-236b": 4}
# K3 against its plain version in the new models' full-depth bf16 prefill
# (or forward), as LIVE_LOGITS_RTOL: L layers x 2^-9 if none cancelled,
# plus one bf16 step of the logits themselves (up to 2^-7 of their scale
# just above a power of two), which at 4 layers is no longer small:
# deepseek-v2 (4 layers) 2^-7 + 4 x 2^-9 = 0.0156; llava (32 layers)
# 2^-7 + 32 x 2^-9 = 0.070; hubert's encoder (48 layers, every frame's
# logits compared) 2^-7 + 48 x 2^-9 = 0.102.
K3_LOGITS_RTOL = {"deepseek-v2-236b": 2**-7 + 4 * 2**-9,
                  "llava-next-mistral-7b": 2**-7 + 32 * 2**-9,
                  "hubert-xlarge": 2**-7 + 48 * 2**-9}
# the engine's accounting pool in live mode holds at most this many bytes
# of K+V pages (deepseek-v2's 128 heads of 192 would take 25.8 GB at
# 16384 blocks); the other models' pools are smaller than this
LIVE_POOL_BYTES = 2 << 30

KERNELS = {
    "paged_attention": dict(
        fn=paged_attention,
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:38",
    ),
    "shared_prefix_attention": dict(
        fn=shared_prefix_attention,
        source="src/repro_torch/kernels/csrc/shared_prefix_attention.cu",
        replaces="src/repro/kernels/shared_prefix_attention.py:37",
    ),
    "flash_attention": dict(
        fn=flash_attention,
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:34",
    ),
    # not a Pallas kernel: the XLA custom VJP of the reference's training
    # attention (_flash_grouped_bwd)
    "flash_attention_bwd": dict(
        fn=flash_attention_bwd,
        source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:123",
    ),
    # not a Pallas kernel: the reference's XLA lane engine (_drive_impl;
    # _drive_batched_impl at :364)
    "lane_engine": dict(
        fn=lane_engine,
        source="src/repro_torch/kernels/csrc/lane_engine.cu",
        replaces="src/repro/core/fastsim_jax.py:138",
    ),
}


@dataclass(frozen=True)
class Sizes:
    """The run's scale. The defaults are the full one: qwen3-1.7b's KV
    geometry (H=16, KV=8, D=128) over a 16384-block pool of 16 tokens."""

    arch: str = "qwen3-1.7b"
    reduced: bool = False           # the arch's small config (CPU rehearsal)
    pool_blocks: int = 16384
    block_tokens: int = 16
    n_requests: int = 1024
    n_prompts: int = 8              # shared system prompts of tenants A, B
    prefix_tokens: int = 1024
    user_tokens: int = 256
    decode_every: int = 64
    groups: int = 8                 # P prefix groups ...
    group_size: int = 16            # ... of M resident requests
    n_objects: int = 1024           # admission catalogue (engine.py's N)
    live_requests: int = 8          # phase 5: requests served by each model ...
    live_prompts: int = 2           # ... shared prompts of tenants A, B ...
    new_tokens: int = 16            # ... and tokens decoded for each
    more_requests: int = 4          # requests (or forwards) of each of MORE_ARCHS
    audio_frames: int = 1000        # hubert's frames a forward: 20 s at 50 Hz
    # phase 8: requests per lane (the paper: 10^7 for Table I, 3 x 10^6
    # for Fig. 2) and lanes; the catalogue is cut only in CPU rehearsals
    table1_requests: int = 4_000_000
    table1_replicas: int = 4        # x 8 b-combos = 32 sweep lanes
    fig2_requests: int = 1_200_000
    fig2_replicas: int = 16
    fig2_catalogue: float = 1.0     # 1.0 = the published N = 10^6
    scenario_requests: int = 1_000_000
    est_chunk: int = 1 << 16        # requests per lane in a timed chunk
    # phase 9: the training batch (sequences x tokens), the optimizer
    # steps of the full-depth run and the layers of the gradient hold;
    # the K3-bwd checks at the models' shapes take train_seq too
    train_batch: int = 4
    train_seq: int = 1024
    train_steps: int = 6
    grad_layers: int = 4
    # phase 9 (e)-(g): data-parallel steps held to plain ones at
    # grad_layers layers; recurrentgemma-2b's sequence, past its window
    mesh_steps: int = 3
    window_seq: int = 4096

    def arch_config(self, name: str = ""):
        cfg = get_config(name or self.arch)
        if self.reduced:
            return cfg.reduced()
        if cfg.name in DEPTH:
            return dataclasses.replace(cfg, n_layers=DEPTH[cfg.name])
        return cfg


def _log(msg: str) -> None:
    print(msg, flush=True)


def _fail(msg: str) -> None:
    raise RuntimeError(msg)


class Errors:
    """Largest kernel-vs-plain difference seen per kernel."""

    def __init__(self) -> None:
        self.max = {name: 0.0 for name in KERNELS}

    def check(self, name: str, got: torch.Tensor, want: torch.Tensor, atol: float,
              what: str) -> float:
        if got.shape != want.shape:
            _fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        g, w = got.float(), want.float()
        if not bool(torch.isfinite(g).all()):
            _fail(f"{what}: non-finite values")
        err = float((g - w).abs().max()) if g.numel() else 0.0
        if not err <= atol:
            _fail(f"{what}: max abs err {err:.3e} > atol {atol:.1e}")
        self.max[name] = max(self.max[name], err)
        return err


def reset_launches() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def launches() -> Dict[str, int]:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


# -- phase 1: env --------------------------------------------------------

def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def phase_env() -> str:
    card = nvidia_smi()
    _log(f"[env] card: {card}")
    _log(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, "
         f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build()
    for name in KERNELS:
        _build.load(name)
    _log(f"[env] kernels built from csrc/ with nvcc in {time.perf_counter() - t0:.2f} s "
         f"(set-up; {len(reports)} compiled, {len(KERNELS) - len(reports)} cached)")
    # each entry function with its registers, spills and shared memory,
    # names demangled by the toolkit's cu++filt where it has one
    filt = Path(_build._nvcc()).with_name("cu++filt")
    for name, log in reports.items():
        if filt.exists():
            log = subprocess.run([str(filt)], input=log, capture_output=True, text=True,
                                 check=True, timeout=60).stdout
        for line in log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                _log(f"[env] ptxas {name}: {line.strip()}")
    return card


def launch_plans(sizes: Sizes) -> None:
    """The launch of K1 (cluster, stage tokens, stages, shared memory,
    clusters the card holds at once) at the serving, grouped and
    small-batch timing shapes and for one sequence, of K2 (cluster,
    tiles, stages, shared memory) at the grouped phase's and the
    long-prefix timing shapes, of K3 at the head size of each live
    model that runs it, and of K3-bwd (bf16) at each head size it is
    timed at."""
    cfg = sizes.arch_config()
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ctx = sizes.prefix_tokens + sizes.user_tokens
    for what, B, c in (("serving", sizes.decode_every, ctx),
                       ("grouped", sizes.groups * sizes.group_size, ctx),
                       ("small batch", SMALL_BATCH_B, SMALL_BATCH_CTX),
                       ("one sequence", 1, SMALL_BATCH_CTX)):
        _log(f"[env] launch K1 bf16 {what} B={B} H={H} KV={KV} D={D} page={sizes.block_tokens} "
             f"ctx={c}: {k1_module.launch_plan(B, H, KV, D, sizes.block_tokens, c)}")
    for P, M, S in ((sizes.groups, sizes.group_size, sizes.prefix_tokens),
                    (LONG_PREFIX_P, LONG_PREFIX_M, LONG_PREFIX_S)):
        _log(f"[env] launch K2 bf16 P={P} M={M} H={H} KV={KV} D={D} S={S}: "
             f"{k2_module.launch_plan(P, M, H, KV, D, S)}")
    k3_dims = sorted({kernel_head_dim(max(k3_shape(c)[2:4]))
                      for c in map(sizes.arch_config, LIVE_ARCHS + MORE_ARCHS)
                      if attn_layers(c)})
    for D in k3_dims:                # each live model's that runs K3 (padded where it must be)
        for dtype in (torch.bfloat16, torch.float32):
            _log(f"[env] launch K3 {str(dtype)[6:]} D={D}: {k3_module.launch_plan(D, dtype)}")
    for D in sorted({kernel_head_dim(max(s[4:6])) for s in bwd_timing_shapes(sizes)}):
        _log(f"[env] launch K3-bwd bf16 D={D}: {k3_module.bwd_launch_plan(D, torch.bfloat16)}")


# -- phase 2: kernels against their plain versions ----------------------

K1_GRID = [  # B, H, KV, D, page, P, pps (tests/test_kernels.py, then tests/test_torch_kernels.py)
    (4, 8, 4, 64, 16, 32, 6), (2, 4, 1, 128, 8, 16, 4), (3, 6, 6, 64, 32, 12, 3),
    (2, 56, 8, 128, 16, 24, 6), (3, 10, 1, 256, 16, 16, 5), (2, 20, 1, 64, 8, 8, 4),
    (2, 4, 2, 256, 64, 8, 3), (2, 8, 4, 64, 12, 16, 5), (2, 16, 8, 128, 16, 64, 32),
    (1, 4, 2, 64, 16, 300, 512), (3, 8, 2, 128, 16, 200, 128), (4, 16, 8, 128, 16, 200, 128),
]
K1_LENS = {  # given context lengths (else drawn, the first 0)
    (2, 16, 8, 128, 16, 64, 32): (200, 77),        # ends mid-page and mid-split
    (1, 4, 2, 64, 16, 300, 512): (4093,),          # many splits, some empty
    (3, 8, 2, 128, 16, 200, 128): (0, 2048, 1500),  # ctx = 0 beside long rows
    (4, 16, 8, 128, 16, 200, 128): (0, 5, 1250, 2048),  # ... inside a page, mid-page, full
}
K2_GRID = [  # P, M, H, KV, D, S
    (3, 4, 8, 4, 64, 64), (2, 2, 4, 1, 128, 100), (1, 8, 4, 4, 64, 256),
    (2, 32, 8, 2, 64, 300), (1, 3, 6, 3, 128, 520), (1, 40, 8, 2, 64, 300),
    (1, 26, 56, 8, 128, 300), (1, 36, 16, 2, 128, 200), (1, 8, 8, 2, 256, 100),
    (2, 8, 10, 1, 256, 300), (1, 20, 8, 1, 256, 130),
]
K1_WIDE = [(3, 8, 1, 256, 64, 8, 3)]   # G=8, D=256, pages wider than a warp's 32 tokens
K3_GRID = [  # B, T, S, H, KV, D_qk, D_v, causal (tests/test_kernels.py, then causal T < S,
    # then the padded widths: MLA's 192/128 and 80, non-causal and causal, and
    # llava's T of an image request with G = 4 at fewer heads)
    (2, 128, 128, 4, 2, 64, 64, True), (1, 256, 256, 8, 8, 128, 128, True),
    (2, 100, 100, 4, 1, 64, 64, False), (1, 64, 192, 4, 4, 64, 64, False),
    (1, 128, 128, 4, 4, 256, 256, True), (1, 64, 192, 4, 2, 64, 64, True),
    (1, 200, 200, 8, 2, 128, 128, True),
    (1, 200, 200, 16, 16, 192, 128, True), (1, 200, 200, 4, 4, 80, 80, False),
    (2, 100, 100, 4, 2, 80, 80, True), (1, 2432, 2432, 4, 1, 128, 128, True),
]
# K2's long-prefix, small-group shape (with the model's heads): many chunks
# of S per (p, h), and in the kernels phase lengths from 0 to S, so that
# some chunks, or all of a prefix's, are empty
LONG_PREFIX_P, LONG_PREFIX_M, LONG_PREFIX_S = 8, 4, 4096
# K1's small-batch, long-context timing shape (the model's heads, each
# sequence's pages distinct): the splits of a sequence fill the card
SMALL_BATCH_B, SMALL_BATCH_CTX = 4, 4096


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def phase_kernels(device, sizes: Sizes, errs: Errors, seed: int) -> None:
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    cfg = sizes.arch_config()
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pps = (sizes.prefix_tokens + sizes.user_tokens) // sizes.block_tokens
    k1 = K1_GRID + K1_WIDE + [(sizes.decode_every, H, KV, D, sizes.block_tokens,
                     sizes.decode_every * pps, pps)]
    k2 = K2_GRID + [(sizes.groups, sizes.group_size, H, KV, D, sizes.prefix_tokens),
                    (4, LONG_PREFIX_M, H, KV, D, LONG_PREFIX_S)]
    k3 = list(dict.fromkeys(K3_GRID + live_k3_shapes(sizes)))
    for dtype in (torch.float32, torch.bfloat16):
        for B, H_, KV_, D_, page, P, pps_ in k1:
            q = _randn(gen, (B, H_, D_), dtype, device)
            kp = _randn(gen, (KV_, P, page, D_), dtype, device)
            vp = _randn(gen, (KV_, P, page, D_), dtype, device)
            bt = torch.randint(0, P, (B, pps_), generator=gen, device=device, dtype=torch.int32)
            cl = torch.randint(1, pps_ * page + 1, (B,), generator=gen, device=device,
                               dtype=torch.int32)
            cl[0] = 0                                     # the ctx = 0 row
            lens = K1_LENS.get((B, H_, KV_, D_, page, P, pps_))
            if lens is not None:
                cl = torch.tensor(lens, dtype=torch.int32, device=device)
            got = paged_attention(q, kp, vp, bt, cl)
            err = errs.check("paged_attention", got, paged_attention_plain(q, kp, vp, bt, cl),
                             ATOL[dtype], f"K1 {dtype} B={B} H={H_} KV={KV_} D={D_} page={page}")
            if int(cl[0]) == 0 and float(got[0].float().abs().max()) != 0.0:
                _fail("K1: ctx = 0 must give zeros")
            _log(f"[kernels] K1 {str(dtype)[6:]:8s} B={B:3d} H={H_:2d} KV={KV_} D={D_:3d} "
                 f"page={page:2d} pps={pps_:2d}: max abs err {err:.3e}")
        for P, M, H_, KV_, D_, S in k2:
            q = _randn(gen, (P, M, H_, D_), dtype, device)
            pk = _randn(gen, (P, S, KV_, D_), dtype, device)
            pv = _randn(gen, (P, S, KV_, D_), dtype, device)
            pl = torch.randint(1, S + 1, (P,), generator=gen, device=device, dtype=torch.int32)
            if P > 1:
                pl[0] = 0                                 # the prefix_len = 0 row
            go, gl = shared_prefix_attention(q, pk, pv, pl, block_s=32 if S <= 256 else 128)
            wo, wl = shared_prefix_attention_plain(q, pk, pv, pl)
            what = f"K2 {dtype} P={P} M={M} H={H_} KV={KV_} D={D_} S={S}"
            err = errs.check("shared_prefix_attention", go, wo, ATOL[dtype], what + " out")
            lerr = errs.check("shared_prefix_attention", gl, wl, LSE_ATOL[dtype], what + " lse")
            if P > 1 and (float(go[0].float().abs().max()) != 0.0 or float(gl[0].max()) > -1e29):
                _fail("K2: prefix_len = 0 must give out = 0, lse = -1e30")
            _log(f"[kernels] K2 {str(dtype)[6:]:8s} P={P} M={M:2d} H={H_:2d} KV={KV_} "
                 f"D={D_:3d} S={S:4d}: max abs err out {err:.3e} lse {lerr:.3e}")
        for B, T_, S, H_, KV_, D_, Dv, causal in k3:
            q = _randn(gen, (B, T_, H_, D_), dtype, device)
            k = _randn(gen, (B, S, KV_, D_), dtype, device)
            v = _randn(gen, (B, S, KV_, Dv), dtype, device)
            # through the op, which pads widths the kernel is not built for
            # (one launch either way), against the unpadded plain version
            err = errs.check("flash_attention", ops.flash_attention(q, k, v, causal=causal),
                             flash_attention_plain(q, k, v, causal=causal), ATOL[dtype],
                             f"K3 {dtype} B={B} T={T_} S={S} H={H_} KV={KV_} D={D_}/{Dv} "
                             f"causal={causal}")
            pad = kernel_head_dim(max(D_, Dv))
            _log(f"[kernels] K3 {str(dtype)[6:]:8s} B={B} T={T_:4d} S={S:4d} H={H_:3d} KV={KV_:3d} "
                 f"D={D_:3d}/{Dv:3d}{f' (padded to {pad})' if pad != D_ or pad != Dv else ''} "
                 f"causal={int(causal)}: max abs err {err:.3e}")
    if device.type == "cuda":
        torch.cuda.synchronize()


# -- phase 3: serving ------------------------------------------------------

def phase_serving(device, sizes: Sizes, errs: Errors, seed: int) -> dict:
    cfg = sizes.arch_config()
    ecfg = EngineConfig(block_tokens=sizes.block_tokens, pool_blocks=sizes.pool_blocks)
    layout = layout_for(cfg, block_tokens=sizes.block_tokens)
    pool_bytes = sizes.pool_blocks * layout.bytes_per_block
    engine = ServingEngine(
        cfg,
        [TenantSpec("tenantA", 0.35 * pool_bytes), TenantSpec("tenantB", 0.35 * pool_bytes),
         TenantSpec("tenantC", 0.20 * pool_bytes)],
        ecfg,
        device=device,
    )
    pool, cache = engine.pool, engine.cache
    k_pages, v_pages = pool.layer_pool(0)
    KV, D, bt = cfg.n_kv_heads, cfg.head_dim, sizes.block_tokens
    n_blocks = (sizes.prefix_tokens + sizes.user_tokens) // bt
    ctx = n_blocks * bt
    _log(f"[serving] {cfg.name}: H={cfg.n_heads} KV={KV} D={D}, pool {sizes.pool_blocks} "
         f"blocks x {bt} tokens = {2 * k_pages.numel() * k_pages.element_size() / 2**30:.3f} "
         f"GiB of {str(k_pages.dtype)[6:]} K+V (layer 0) on {device}")

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    prompts = [rng.integers(0, cfg.vocab_size, sizes.prefix_tokens) for _ in range(sizes.n_prompts)]
    written: Dict[int, bytes] = {}       # page -> object key it holds
    requests: List[tuple] = []           # (tenant, prompt index or -1, tokens)
    decoded = dropped = pages_written = 0
    last = None
    spent = {"submit": 0.0, "writes": 0.0, "decode": 0.0}   # host seconds
    t0 = time.perf_counter()
    for i in range(sizes.n_requests):
        t = int(rng.choice(3, p=[0.4, 0.4, 0.2]))
        tenant = ("tenantA", "tenantB", "tenantC")[t]
        pi = int(rng.integers(0, sizes.n_prompts)) if t < 2 else -1
        prefix = prompts[pi] if t < 2 else rng.integers(0, cfg.vocab_size, sizes.prefix_tokens)
        tokens = np.concatenate([prefix, rng.integers(0, cfg.vocab_size, sizes.user_tokens)])
        t1 = time.perf_counter()
        engine.submit(tenant, tokens)
        t2 = time.perf_counter()
        spent["submit"] += t2 - t1
        requests.append((tenant, pi, tokens))
        # write K/V once into each page this request newly allocated
        new = [(key, cache.pages[key]) for key in cache._keys_for(tokens)
               if key in cache.pages and written.get(cache.pages[key]) != key]
        if new:
            kv = torch.randn((2, len(new), bt, KV, D), generator=gen, device=device)
            for j, (key, page) in enumerate(new):
                pool.write_block(0, page, kv[0, j], kv[1, j])
                written[page] = key
            pages_written += len(new)
        t3 = time.perf_counter()
        spent["writes"] += t3 - t2
        if (i + 1) % sizes.decode_every == 0:
            tables = [cache.block_table(tn, tk) for tn, _, tk in requests[-sizes.decode_every:]]
            tables = [tb for tb in tables if len(tb) == n_blocks]   # fully resident
            dropped += sizes.decode_every - len(tables)
            if tables:
                B = len(tables)
                q = _randn(gen, (B, cfg.n_heads, D), k_pages.dtype, device)
                bt_t = torch.as_tensor(np.stack(tables), device=device)
                cl = torch.full((B,), ctx, dtype=torch.int32, device=device)
                out = ops.paged_attention(q, k_pages, v_pages, bt_t, cl)
                errs.check("paged_attention", out,
                           paged_attention_plain(q, k_pages, v_pages, bt_t, cl),
                           ATOL[q.dtype], f"serving decode after request {i + 1}")
                decoded += B
                last = (q, bt_t, cl)
            spent["decode"] += time.perf_counter() - t3
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats()
    _log(f"[serving] {sizes.n_requests} requests in {wall:.2f} s (host clock): submit "
         f"{spent['submit']:.2f} s, page writes {spent['writes']:.2f} s (enqueue), decode + "
         f"check {spent['decode']:.2f} s (synchronised by the check); pages written "
         f"{pages_written}")
    _log(f"[serving] prefix-hit token ratio {st['prefix_hit_token_ratio']:.4f}, evictions "
         f"{st['evictions']}, ripple evictions {st['ripple_evictions']}, sharing ratio "
         f"{st['sharing_ratio']:.4f}, pool used {st['pool_used_blocks']}/{sizes.pool_blocks}")
    _log(f"[serving] decoded {decoded} requests through K1, dropped {dropped} not resident")
    if last is None:
        _fail("serving: no request was resident at any decode step")
    return dict(engine=engine, requests=requests, n_blocks=n_blocks, last=last,
                stats=st, decoded=decoded, dropped=dropped)


# -- phase 4: grouped decode ----------------------------------------------

def _gather(pages: torch.Tensor, table: np.ndarray) -> torch.Tensor:
    """(KV, P, page, D) pool, table of n pages -> (n * page, KV, D)."""
    KV, _, page, D = pages.shape
    idx = torch.as_tensor(table, device=pages.device, dtype=torch.long)
    return pages[:, idx].reshape(KV, len(table) * page, D).transpose(0, 1)


def phase_grouped(device, sizes: Sizes, served: dict, errs: Errors, seed: int) -> dict:
    engine, n_blocks = served["engine"], served["n_blocks"]
    cache, pool = engine.cache, engine.pool
    k_pages, v_pages = pool.layer_pool(0)
    n_pre = sizes.prefix_tokens // sizes.block_tokens
    groups: Dict[int, List[np.ndarray]] = {}
    for tenant, pi, tokens in reversed(served["requests"]):     # most recent first
        if pi < 0 or len(groups.get(pi, [])) == sizes.group_size:
            continue
        table = cache.block_table(tenant, tokens)
        if len(table) == n_blocks:
            groups.setdefault(pi, []).append(table)
    full = sorted(pi for pi, g in groups.items() if len(g) == sizes.group_size)
    if len(full) < sizes.groups:
        _fail(f"grouped: only {len(full)} prompts have {sizes.group_size} resident requests")
    tables = np.stack([np.stack(groups[pi]) for pi in full[: sizes.groups]])  # (P, M, n_blocks)
    if not (tables[:, :, :n_pre] == tables[:, :1, :n_pre]).all():
        _fail("grouped: requests of one prompt do not share its prefix pages")
    P, M = tables.shape[:2]
    cfg = engine.cfg
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    q = _randn(gen, (P, M, cfg.n_heads, cfg.head_dim), k_pages.dtype, device)
    pk = torch.stack([_gather(k_pages, tables[p, 0, :n_pre]) for p in range(P)]).contiguous()
    pv = torch.stack([_gather(v_pages, tables[p, 0, :n_pre]) for p in range(P)]).contiguous()
    sk = torch.stack([torch.stack([_gather(k_pages, tables[p, m, n_pre:]) for m in range(M)])
                      for p in range(P)]).contiguous()
    sv = torch.stack([torch.stack([_gather(v_pages, tables[p, m, n_pre:]) for m in range(M)])
                      for p in range(P)]).contiguous()
    plens = torch.full((P,), sizes.prefix_tokens, dtype=torch.int32, device=device)
    slens = torch.full((P, M), sizes.user_tokens, dtype=torch.int32, device=device)

    out = ops.shared_prefix_decode(q, pk, pv, plens, sk, sv, slens)
    # the plain version: plain K2, the same suffix attention and merge
    wo, wl = shared_prefix_attention_plain(q, pk, pv, plens)
    sb, lb = ref.reference_attention_with_lse(
        q.reshape(P * M, 1, *q.shape[2:]), sk.flatten(0, 1), sv.flatten(0, 1),
        kv_valid_len=slens.reshape(P * M),
    )
    want = ref.lse_merge(wo.float(), wl, sb.reshape(out.shape), lb.reshape(P, M, -1)).to(q.dtype)
    err = errs.check("shared_prefix_attention", out, want, ATOL[q.dtype],
                     "grouped decode vs plain")
    # sharing-aware decode must equal per-request decode over the same pages
    ctx = torch.full((P * M,), n_blocks * sizes.block_tokens, dtype=torch.int32, device=device)
    bt_t = torch.as_tensor(tables.reshape(P * M, n_blocks), device=device)
    per_req = ops.paged_attention(q.reshape(P * M, *q.shape[2:]), k_pages, v_pages, bt_t, ctx)
    errs.check("paged_attention", per_req,
               paged_attention_plain(q.reshape(P * M, *q.shape[2:]), k_pages, v_pages, bt_t, ctx),
               ATOL[q.dtype], "grouped: per-request K1 vs plain")
    gap = float((out.float() - per_req.reshape(out.shape).float()).abs().max())
    if not gap <= ATOL[q.dtype]:
        _fail(f"grouped decode differs from per-request K1 decode by {gap:.3e}")
    if device.type == "cuda":
        torch.cuda.synchronize()
    _log(f"[grouped] P={P} prefix groups x M={M} requests, prefix {sizes.prefix_tokens} + "
         f"suffix {sizes.user_tokens} tokens: max abs err vs plain {err:.3e}, vs per-request "
         f"K1 {gap:.3e}")
    return dict(q=q, pk=pk, pv=pv, plens=plens)


# -- phase 5: live serving -------------------------------------------------

class TimedModel:
    """The model as the engine sees it, with each prefill and decode step
    timed on the host clock between two synchronisations, and the first
    prefill's logits kept. It computes nothing of its own."""

    def __init__(self, model, device) -> None:
        self.model, self.device = model, device
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []
        self.first_logits = None

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def prefill(self, params, batch, cache_len):
        self._sync()
        t0 = time.perf_counter()
        logits, caches = self.model.prefill(params, batch, cache_len)
        self._sync()
        self.prefill_s.append(time.perf_counter() - t0)
        if self.first_logits is None:
            self.first_logits = logits.float().clone()
        return logits, caches

    def decode_step(self, params, tokens, caches, position):
        self._sync()
        t0 = time.perf_counter()
        out = self.model.decode_step(params, tokens, caches, position)
        self._sync()
        self.decode_s.append(time.perf_counter() - t0)
        return out


@contextmanager
def plain_prefill_attention():
    """Within the block, the models' prefill attention runs K3's plain
    version (this script only; the port has no such switch)."""
    kernel = ops.flash_attention
    ops.flash_attention = lambda q, k, v, *, causal=True: flash_attention_plain(
        q, k, v, causal=causal)
    try:
        yield
    finally:
        ops.flash_attention = kernel


def attn_layers(cfg) -> int:
    """The layers of global attention: each runs K3 once a prefill (or an
    encoder's forward)."""
    G = len(cfg.block_pattern)
    return sum(cfg.block_pattern[i % G] == "attn" for i in range(cfg.n_layers))


def k3_shape(cfg) -> tuple:
    """(H, KV, D_qk, D_v, causal) of the model's K3 launches: MLA's
    expanded heads (nope + rope against v), an encoder's non-causal
    attention, else GQA."""
    if cfg.attention == "mla":
        return (cfg.n_heads, cfg.n_heads, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                cfg.v_head_dim, True)
    return cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.head_dim, not cfg.is_encoder


def k3_lengths(cfg, sizes: Sizes) -> List[int]:
    """The sequence lengths K3 runs at in the model's live path: a served
    prompt's (and, for a vision model, with its image tokens first), or
    an encoder's frames."""
    if cfg.modality == "audio":
        return [sizes.audio_frames]
    T = sizes.prefix_tokens + sizes.user_tokens
    return [T, T + cfg.n_image_tokens] if cfg.modality == "vision_text" else [T]


def live_k3_shapes(sizes: Sizes) -> List[tuple]:
    """K3's (B, T, S, H, KV, D_qk, D_v, causal) in the live phase."""
    out = []
    for cfg in dict.fromkeys(map(sizes.arch_config, LIVE_ARCHS + MORE_ARCHS)):
        if attn_layers(cfg):
            out += [(1, n, n) + k3_shape(cfg) for n in k3_lengths(cfg, sizes)]
    return out


def _init_model(device, cfg, seed: int, what: str):
    """The model in bf16 and its parameters drawn on ``device`` from the
    seed; the parameter count."""
    model = make_model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    if device.type == "cuda":
        torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    cut = (f" (of {get_config(cfg.name).n_layers}: depth cut)"
           if cfg.n_layers == DEPTH.get(cfg.name) else "")
    _log(f"[{what}] {cfg.name}: {cfg.n_layers} layers{cut}, d_model {cfg.d_model}, "
         f"H={cfg.n_heads} KV={cfg.n_kv_heads} D={cfg.head_dim}, vocab {cfg.vocab_size}: "
         f"{n_params / 1e9:.3f} B bf16 parameters ({2 * n_params / 1e9:.2f} GB) drawn on {device} "
         f"from seed {seed} in {time.perf_counter() - t0:.2f} s (set-up)")
    return model, params, n_params


def phase_live(device, sizes: Sizes, seed: int, arch: str = "", n_requests: int = 0) -> dict:
    """The engine in live mode with the model ``arch`` (default
    ``sizes.arch``): ``n_requests`` requests (default
    ``sizes.live_requests``), each prefilled and decoded; the prefill and
    decode times of each."""
    cfg = sizes.arch_config(arch)
    n_requests = n_requests or sizes.live_requests
    model, params, n_params = _init_model(device, cfg, seed, "live")
    layout = layout_for(cfg, block_tokens=sizes.block_tokens)
    page_bytes = 2 * 2 * sizes.block_tokens * cfg.n_kv_heads * cfg.head_dim   # K+V, bf16
    pool_blocks = min(sizes.pool_blocks, LIVE_POOL_BYTES // page_bytes)
    pool_bytes = pool_blocks * layout.bytes_per_block
    timed = TimedModel(model, device)
    engine = ServingEngine(
        cfg,
        [TenantSpec("tenantA", 0.35 * pool_bytes), TenantSpec("tenantB", 0.35 * pool_bytes),
         TenantSpec("tenantC", 0.20 * pool_bytes)],
        EngineConfig(block_tokens=sizes.block_tokens, pool_blocks=pool_blocks),
        model=timed, params=params, device=device,
    )
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, cfg.vocab_size, sizes.prefix_tokens)
               for _ in range(sizes.live_prompts)]
    results, requests = [], []
    t0 = time.perf_counter()
    for i in range(n_requests):
        t = i % 3                        # A, B, C in turn; A and B share the prompts
        pi = (i // 3) % sizes.live_prompts if t < 2 else -1
        head = prompts[pi] if t < 2 else rng.integers(0, cfg.vocab_size, sizes.prefix_tokens)
        tokens = np.concatenate([head, rng.integers(0, cfg.vocab_size, sizes.user_tokens)])
        tenant = ("tenantA", "tenantB", "tenantC")[t]
        res = engine.submit(tenant, tokens, max_new_tokens=sizes.new_tokens)
        out = res.output
        if out is None or out.shape != (1, sizes.new_tokens) or out.dtype != np.int32:
            _fail(f"live: request {i} gave {None if out is None else (out.shape, out.dtype)}")
        if not (0 <= out.min() and out.max() < cfg.vocab_size):
            _fail(f"live: request {i} decoded a token outside the vocabulary")
        results.append(res)
        requests.append(tokens)
        _log(f"[live] request {i} {tenant} prompt {pi:2d}: {len(tokens)} tokens, cached "
             f"{res.cached_tokens}, prefill {1e3 * timed.prefill_s[-1]:.2f} ms, decode "
             f"{1e3 * np.mean(timed.decode_s[-(sizes.new_tokens - 1):]):.2f} ms/token, "
             f"tokens {out[0, :6].tolist()}...")
    wall = time.perf_counter() - t0
    # a request of tenant B whose prompt tenant A sent first finds it cached
    if results[1].cached_tokens != sizes.prefix_tokens:
        _fail(f"live: tenant B's shared prompt was not served from the cache "
              f"({results[1].cached_tokens} of {sizes.prefix_tokens} tokens)")
    st = engine.stats()
    _log(f"[live] {n_requests} requests in {wall:.2f} s (host clock): prefill "
         f"{1e3 * np.median(timed.prefill_s[1:]):.2f} ms per request (median of requests "
         f"1-{n_requests - 1}; the first took {1e3 * timed.prefill_s[0]:.2f} ms), decode "
         f"{1e3 * np.median(timed.decode_s):.2f} ms per token (median of {len(timed.decode_s)} "
         f"steps); prefix-hit token ratio {st['prefix_hit_token_ratio']:.4f}, sharing ratio "
         f"{st['sharing_ratio']:.4f}")
    return dict(cfg=cfg, model=model, params=params, timed=timed, results=results,
                requests=requests, n_params=n_params)


def phase_live_models(device, sizes: Sizes, seed: int, card: str,
                      archs=LIVE_ARCHS) -> List[dict]:
    """Phase 5 with each model of ``archs`` in turn: its launch counts
    from 0 across its requests (the main path: the engine's requests, a
    vision model's request with an image too; an encoder's forwards),
    then its checks (K3 against the plain prefill or forward where it
    runs K3, else the decode consistency) and a profiled prefill and
    decode step (an encoder's forward). Returns a summary per model
    (``k3_want``: the K3 launches its path must make); the models'
    tensors are freed between models."""
    out = []
    for arch in archs:
        cfg = sizes.arch_config(arch)
        n = sizes.live_requests if arch in LIVE_ARCHS else sizes.more_requests
        if cfg.is_encoder:
            out.append(encode_model(device, sizes, seed, cfg, n, card))
            continue
        reset_launches()                              # this model's path starts here
        live = phase_live(device, sizes, seed, arch, n)
        image = image_request(live, sizes, seed) if cfg.modality == "vision_text" else None
        got = launches()                              # ... and ends here
        timed = live["timed"]
        r = dict(name=cfg.name, launches=got, k3_per_request=attn_layers(cfg),
                 k3_want=attn_layers(cfg) * (n + (image is not None)),
                 n_params=live["n_params"],
                 prefill_ms=1e3 * float(np.median(timed.prefill_s[1:])),
                 decode_ms=1e3 * float(np.median(timed.decode_s)))
        if r["k3_per_request"]:
            r["k3_err"] = check_live_against_plain(live, sizes)
        else:
            r["decode_err"] = check_decode_consistency(live, sizes)
        if image is not None:
            r["image_err"] = check_image_against_plain(live, image)
            r["image_prefill_ms"], r["image_decode_ms"] = image["prefill_ms"], image["decode_ms"]
        profile_live(live, sizes)
        _log(f"[live] {cfg.name} on {card}: {r['n_params'] / 1e9:.3f} B parameters "
             f"({2 * r['n_params'] / 1e9:.2f} GB bf16), prefill {r['prefill_ms']:.2f} ms per "
             f"request, decode {r['decode_ms']:.2f} ms per token; launches {got} "
             f"({r['k3_per_request']} K3 launches a request)")
        out.append(r)
        del live, timed, image
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def image_request(live: dict, sizes: Sizes, seed: int) -> dict:
    """A vision model's request with an image: the projected image tokens
    (``n_image_tokens`` patch embeddings drawn from the seed: the vision
    tower is a stub in the reference too) first, then the first request's
    prompt, prefilled through ``TransformerLM.prefill`` and decoded
    greedily from position ``n_image_tokens + len(prompt)``; its prefill
    and decode times, tokens and last-token logits."""
    from repro_torch.serving import greedy_decode

    cfg, model, params, timed = live["cfg"], live["model"], live["params"], live["timed"]
    dev = params["embed"].device
    tokens = live["requests"][0]
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    batch = {"tokens": torch.as_tensor(tokens[None, :], device=dev),
             "image_embeds": _randn(gen, (1, cfg.n_image_tokens, cfg.vision_dim),
                                    torch.bfloat16, dev)}
    T = cfg.n_image_tokens + len(tokens)
    n_decode = len(timed.decode_s)
    with torch.inference_mode():
        logits, caches = timed.prefill(params, batch, T + sizes.new_tokens)
        prefill_s = timed.prefill_s.pop()
        out = greedy_decode(timed, params, logits, caches, start_pos=T,
                            n_steps=sizes.new_tokens).cpu().numpy()
    decode_s = timed.decode_s[n_decode:]
    del timed.decode_s[n_decode:]
    if out.shape != (1, sizes.new_tokens) or not (0 <= out.min() and out.max() < cfg.vocab_size):
        _fail(f"live: {cfg.name}: the image request gave {out.shape} {out.min()}..{out.max()}")
    r = dict(batch=batch, S=T + sizes.new_tokens, logits=logits.float(), tokens=out,
             prefill_ms=1e3 * prefill_s, decode_ms=1e3 * float(np.median(decode_s)))
    _log(f"[live] {cfg.name} request with an image: {cfg.n_image_tokens} image tokens + "
         f"{len(tokens)} text tokens = {T}, prefill {r['prefill_ms']:.2f} ms, decode "
         f"{r['decode_ms']:.2f} ms/token from position {T}, tokens {out[0, :6].tolist()}...")
    return r


def check_image_against_plain(live: dict, image: dict) -> float:
    """The image request's prefill again with K3's plain version: the
    last-token logits within the model's K3_LOGITS_RTOL of their scale
    and the same first greedy token."""
    cfg = live["cfg"]
    with torch.inference_mode(), plain_prefill_attention():
        want, _ = live["model"].prefill(live["params"], image["batch"], image["S"])
    return _hold_logits(cfg, image["logits"], want.float(), int(image["tokens"][0, 0]),
                        "image request, K3 vs plain attention")


def encode_model(device, sizes: Sizes, seed: int, cfg, n: int, card: str) -> dict:
    """An encoder (hubert-xlarge) on ``n`` inputs of ``sizes.audio_frames``
    precomputed frames (the reference's audio frontend is a stub): each
    through ``TransformerLM.forward_logits``, timed; its launches counted
    from 0 across them; then its first forward held to the same forward
    with K3's plain version (every frame's logits) and one more forward
    profiled. It has no decode step (the model raises there, as the
    reference's does)."""
    reset_launches()                                  # this model's path starts here
    model, params, n_params = _init_model(device, cfg, seed, "encode")
    gen = torch.Generator(device=device).manual_seed(seed + 8)
    frames = [_randn(gen, (1, sizes.audio_frames, cfg.d_model), torch.bfloat16, device)
              for _ in range(n)]
    times, first = [], None
    with torch.inference_mode():
        for i, f in enumerate(frames):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = model.forward_logits(params, {"frames": f})
            if device.type == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if logits.shape != (1, sizes.audio_frames, cfg.vocab_size):
                _fail(f"encode: {cfg.name}: logits {tuple(logits.shape)}")
            if first is None:
                first = logits.float().clone()
            _log(f"[encode] {cfg.name} input {i}: {sizes.audio_frames} frames, forward "
                 f"{1e3 * times[-1]:.2f} ms, frame 0's argmax {int(torch.argmax(logits[0, 0]))}")
    got = launches()                                  # ... and ends here
    try:
        model.decode_step(params, torch.zeros((1, 1), dtype=torch.long, device=device), {},
                          torch.zeros(1, dtype=torch.int32, device=device))
    except ValueError:
        pass
    else:
        _fail(f"encode: {cfg.name} decoded a step; an encoder has none")
    with torch.inference_mode(), plain_prefill_attention():
        want = model.forward_logits(params, {"frames": frames[0]}).float()
    r = dict(name=cfg.name, launches=got, k3_per_request=attn_layers(cfg),
             k3_want=attn_layers(cfg) * n, n_params=n_params,
             prefill_ms=1e3 * float(np.median(times[1:] if n > 1 else times)), decode_ms=None)
    r["k3_err"] = _hold_logits(cfg, first, want, None, "forward, K3 vs plain attention")
    with torch.inference_mode():
        prof = _device_profile(lambda: model.forward_logits(params, {"frames": frames[0]}),
                               device)
    _log_profile(cfg.name, "forward", prof)
    _log(f"[encode] {cfg.name} on {card}: {n_params / 1e9:.3f} B parameters "
         f"({2 * n_params / 1e9:.2f} GB bf16), forward {r['prefill_ms']:.2f} ms per "
         f"{sizes.audio_frames} frames (median of inputs 1-{n - 1}; the first took "
         f"{1e3 * times[0]:.2f} ms); launches {got} ({r['k3_per_request']} K3 launches a forward)")
    del model, params, frames, first, want
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return r


class RouteTape:
    """A launcher-style ``moe_apply`` override (``models.shardctx``) for
    two passes of an MoE model, prefills or losses and gradients: the
    first (``routes=None``) records each layer's discrete routing
    (experts, kept slots, capacity) and computes ``moe_apply``'s own
    function; the second replays those choices with the top-k weights
    and the aux loss taken from its own router pass, so that the two
    passes differ only where their attention does (top-k and capacity
    drops are discontinuous) and the router's gradient flows. One call a
    layer a pass (no remat)."""

    def __init__(self, routes=None) -> None:
        self.replay = routes is not None
        self.routes = [] if routes is None else routes
        self.i = 0

    def __call__(self, h, p, cfg, *, capacity_factor):
        xf = h.reshape(-1, h.shape[-1])
        if self.replay:
            r = self.routes[self.i]
            self.i += 1
            probs = torch.softmax(moe.matmul(xf.float(), p["router"]), dim=-1)
            top_w = probs.gather(1, r["top_i"])
            if cfg.moe_renormalize:
                top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
            E = cfg.n_experts
            f_e = F.one_hot(r["top_i"][:, 0], E).float().mean(dim=0)
            r = dict(r, top_w=top_w, aux=E * torch.sum(f_e * probs.mean(dim=0)))
        else:
            r = moe.moe_route(xf, p, cfg, capacity_factor=capacity_factor)
            self.routes.append({k: r[k] for k in ("top_i", "keep", "dest", "C")})
        return moe.moe_combine(xf, p, cfg, r).reshape(h.shape), r["aux"]


def route_changes(a: List[dict], b: List[dict]) -> dict:
    """How far two recorded routings differ, over all layers: tokens whose
    top-k experts differ, and routing choices kept in one but dropped in
    the other, of all tokens and choices; and the last token's choices
    dropped in each."""
    return dict(tokens=sum(int((x["top_i"] != y["top_i"]).any(-1).sum()) for x, y in zip(a, b)),
                of_tokens=sum(x["top_i"].shape[0] for x in a),
                kept=sum(int((x["keep"] != y["keep"]).sum()) for x, y in zip(a, b)),
                of_choices=sum(x["keep"].numel() for x in a),
                last_dropped=(sum(int((~x["keep"][-1]).sum()) for x in a),
                              sum(int((~y["keep"][-1]).sum()) for y in b)))


def check_live_against_plain(live: dict, sizes: Sizes) -> float:
    """The first request's prefill again, with K3's plain version: the
    last-token logits within LIVE_LOGITS_RTOL of their scale and the same
    first greedy token. For an MoE model the plain prefill replays the K3
    prefill's routing (RouteTape): top-k and the capacity drops are
    discontinuous in their inputs, so a last bit of attention can move a
    token to another expert or drop it, which the bf16 argument of
    LIVE_LOGITS_RTOL does not cover. The plain prefill with its own
    routing is run as well, and how far it and its routing moved is
    printed."""
    tokens, model, params, cfg = live["requests"][0], live["model"], live["params"], live["cfg"]
    dev = params["embed"].device
    batch = {"tokens": torch.as_tensor(tokens[None, :], device=dev)}
    S = len(tokens) + sizes.new_tokens
    got = live["timed"].first_logits
    with torch.inference_mode():
        if cfg.moe:
            k3_tape, own_tape = RouteTape(), RouteTape()
            with shardctx.rules({"moe_apply": k3_tape}):
                again, _ = model.prefill(params, batch, S)            # K3, its routing recorded
            with plain_prefill_attention(), shardctx.rules({"moe_apply": own_tape}):
                own, _ = model.prefill(params, batch, S)              # plain, its own routing
            with plain_prefill_attention(), shardctx.rules({"moe_apply": RouteTape(k3_tape.routes)}):
                want, _ = model.prefill(params, batch, S)             # plain, K3's routing
            got = again.float()
            own = own.float()
            ch = route_changes(k3_tape.routes, own_tape.routes)
            _log(f"[live] {cfg.name} first prefill again with K3: logits max abs diff "
                 f"{float((got - live['timed'].first_logits).abs().max()):.3e} from the served "
                 f"one; the plain prefill with its own routing: last-token logits max abs err "
                 f"{float((got - own).abs().max()):.3e} (scale {float(own.abs().max()):.3e}), "
                 f"greedy token {int(torch.argmax(own[0, -1]))}; its routing moved "
                 f"{ch['tokens']} of {ch['of_tokens']} tokens' experts and {ch['kept']} of "
                 f"{ch['of_choices']} kept choices; the last token's choices dropped "
                 f"{ch['last_dropped'][0]} (K3) and {ch['last_dropped'][1]} (plain) over "
                 f"{len(k3_tape.routes)} layers")
        else:
            with plain_prefill_attention():
                want, _ = model.prefill(params, batch, S)
    what = "first prefill, K3 vs plain attention" + (", the routing held" if cfg.moe else "")
    return _hold_logits(cfg, got, want.float(), int(live["results"][0].output[0, 0]), what)


def _hold_logits(cfg, got, want, first, what: str) -> float:
    """Logits (B, T, V) from K3 against the plain version's, within the
    model's tolerance (K3_LOGITS_RTOL, else LIVE_LOGITS_RTOL) of their
    scale; where a greedy token ``first`` was served from them, it must
    be the plain last token's argmax. Returns the max abs difference."""
    rtol = K3_LOGITS_RTOL.get(cfg.name, LIVE_LOGITS_RTOL)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= rtol * scale):
        _fail(f"{cfg.name}: {what}: the logits differ by {err:.3e} "
              f"(> {rtol:.4f} x scale {scale:.3e})")
    tail = ""
    if first is not None:
        top2 = torch.topk(want[0, -1], 2).values
        if first != int(torch.argmax(want[0, -1])):
            _fail(f"{cfg.name}: {what}: first greedy token {first} != the plain one's "
                  f"{int(torch.argmax(want[0, -1]))}")
        tail = (f"; first greedy token {first} in both (plain top-2 margin "
                f"{float(top2[0] - top2[1]):.3e})")
    _log(f"[live] {cfg.name} {what}: {'last-token ' if first is not None else ''}logits max "
         f"abs err {err:.3e} (scale {scale:.3e}, limit {rtol * scale:.3e}){tail}")
    return err


def _decode_vs_prefill(model, params, tokens, sizes: Sizes) -> tuple:
    """The last-token logits of a prefill of T-1 tokens and one decode
    step of the last, and of a prefill of all T."""
    T, dev = len(tokens), params["embed"].device
    toks = torch.as_tensor(tokens[None, :], device=dev)
    with torch.inference_mode():
        want, _ = model.prefill(params, {"tokens": toks}, T + sizes.new_tokens)
        _, caches = model.prefill(params, {"tokens": toks[:, :T - 1]}, T + sizes.new_tokens)
        got, _ = model.decode_step(params, toks[:, T - 1:], caches,
                                   torch.full((1,), T - 1, dtype=torch.int32, device=dev))
    return got[0, -1].float(), want[0, -1].float()


def check_decode_consistency(live: dict, sizes: Sizes) -> float:
    """The first request's prefill of T-1 tokens and one decode step of
    its last token against its prefill of T tokens (tests/test_models.py's
    decode consistency): the last-token logits within DECODE_LOGITS_RTOL
    of their scale. A model in DECODE_IN_F32 is held in f32 instead, on
    an f32 copy of its parameters, within its rtol there; the served bf16
    model's difference is printed beside it. Returns the max abs
    difference held."""
    cfg, tokens = live["cfg"], live["requests"][0]
    T = len(tokens)
    got, want = _decode_vs_prefill(live["model"], live["params"], tokens, sizes)
    rtol, what = DECODE_LOGITS_RTOL, "bf16"
    if cfg.name in DECODE_IN_F32:
        bf16 = (f"; the served bf16 model: {float((got - want).abs().max()):.3e} (scale "
                f"{float(want.abs().max()):.3e}), greedy token {int(torch.argmax(got))} vs "
                f"{int(torch.argmax(want))} (printed, not held)")
        model = make_model(cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
        params = _tree_map(lambda t: t.float(), live["params"])
        got, want = _decode_vs_prefill(model, params, tokens, sizes)
        del params
        rtol, what = DECODE_IN_F32[cfg.name], "f32 copy of the parameters"
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= rtol * scale):
        _fail(f"live: {cfg.name} ({what}) prefill(T-1) + decode differs from prefill(T) by "
              f"{err:.3e} (> {rtol} x scale {scale:.3e})")
    _log(f"[live] {cfg.name} prefill({T - 1}) + decode step vs prefill({T}), {what}: last-token "
         f"logits max abs err {err:.3e} (scale {scale:.3e}, limit {rtol * scale:.3e}); greedy "
         f"token {int(torch.argmax(got))} vs {int(torch.argmax(want))}"
         f"{bf16 if cfg.name in DECODE_IN_F32 else ''}")
    return err


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _device_profile(fn, device) -> dict:
    """Host-clock ms of ``fn()`` under torch.profiler, the card's busy ms
    (the sum of kernel and copy times; one stream, so they do not
    overlap) and the largest device consumers. Device figures are None
    where the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, top, _, _ = _busy(prof)
    return dict(wall_ms=wall, busy_ms=busy, top=top[:6])


# kernels of a training step by name: cuBLAS's products, K3, K3-bwd; the
# rest are PyTorch's elementwise kernels, reductions and copies
STEP_KERNELS = (("matmuls (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
                ("K3", ("flash_tma_kernel", "flash_fma_kernel")),
                ("K3-bwd", ("bwd_dkdv", "bwd_dq", "bwd_delta")))


def _busy(prof) -> tuple:
    """The card's busy ms under a finished profiler (None where it saw no
    device activity), the largest device consumers, the busy ms by
    STEP_KERNELS' groups (and "other"), and the device ms of the kernels
    launched inside the train step's ``train_step.*`` ranges (on the
    calling thread: the backward runs on autograd's own)."""
    from torch.autograd import DeviceType

    ranges = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
              if e.key.startswith("train_step.") and e.device_type == DeviceType.CPU}
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
            and not e.key.startswith("train_step.")]      # the ranges' own device rows
    rows.sort(key=lambda r: -r[1])
    groups = {name: 0.0 for name, _ in STEP_KERNELS}
    groups["other"] = 0.0
    for key, ms, _ in rows:
        name = next((n for n, pats in STEP_KERNELS if any(p in key for p in pats)), "other")
        groups[name] += ms
    return (sum(ms for _, ms, _ in rows) if rows else None), rows[:8], groups, ranges


def profile_live(live: dict, sizes: Sizes) -> dict:
    """One more prefill of the first request and one decode step on its
    caches, each under torch.profiler: where the time goes, and the
    card's idle share (1 - busy / host-clock time, the profiler's own
    overhead included)."""
    tokens, model, params = live["requests"][0], live["model"], live["params"]
    dev = params["embed"].device
    batch = {"tokens": torch.as_tensor(tokens[None, :], device=dev)}
    state = {}

    def prefill():
        state["logits"], state["caches"] = model.prefill(
            params, batch, len(tokens) + sizes.new_tokens)

    def decode():
        tok = torch.argmax(state["logits"][:, -1], dim=-1)[:, None]
        model.decode_step(params, tok, state["caches"],
                          torch.full((1,), len(tokens), dtype=torch.int32, device=dev))

    out = {}
    with torch.inference_mode():
        for name, fn in (("prefill", prefill), ("decode step", decode)):
            out[name] = _device_profile(fn, dev)
            _log_profile(live["cfg"].name, name, out[name])
    return out


def _log_profile(model: str, name: str, r: dict) -> None:
    if r["busy_ms"] is None:
        _log(f"[live] {model} profile {name}: {r['wall_ms']:.2f} ms (host clock); device time "
             f"not measured (the profiler saw no device activity)")
        return
    top = "; ".join(f"{k[:60]} x{n} {ms:.3f} ms" for k, ms, n in r["top"])
    _log(f"[live] {model} profile {name}: {r['wall_ms']:.2f} ms (host clock), card busy "
         f"{r['busy_ms']:.2f} ms, idle share {1 - r['busy_ms'] / r['wall_ms']:.3f}; "
         f"largest: {top}")


def _leaves(tree):
    """The tensors of a tree of dicts and lists (the parameters)."""
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    for v in (tree.values() if isinstance(tree, dict) else tree):
        yield from _leaves(v)


# -- phase 6: admission ----------------------------------------------------

def phase_admission(device, sizes: Sizes) -> float:
    cfg = sizes.arch_config()
    bpb = layout_for(cfg, block_tokens=sizes.block_tokens).bytes_per_block
    lam = irm.rate_matrix(sizes.n_objects, (0.8, 0.6, 1.0))
    lengths = np.full(sizes.n_objects, float(bpb))
    b_star = np.array([0.20, 0.20, 0.10]) * lengths.sum()
    t0 = time.perf_counter()
    b, sol = admission.virtual_allocations(lam, lengths, b_star, device=device)
    wall = time.perf_counter() - t0
    b_cpu, sol_cpu = admission.virtual_allocations(lam, lengths, b_star, device="cpu")
    if not (np.all(np.isfinite(b)) and np.all(b > 0) and np.all(b <= b_star * (1 + 1e-6))):
        _fail(f"admission: virtual allocations {b} outside (0, b*]")
    rel = float(np.max(np.abs(b - b_cpu) / b_cpu))
    rel_t = float(np.max(np.abs(sol.t - sol_cpu.t) / sol_cpu.t))
    if not (rel <= ADMISSION_RTOL and rel_t <= ADMISSION_RTOL):
        _fail(f"admission: card vs CPU rel err b {rel:.2e}, t {rel_t:.2e} > {ADMISSION_RTOL}")
    gain = float(b_star.sum() / b.sum())
    _log(f"[admission] J=3 N={sizes.n_objects} objects of {bpb} B, b* = (0.20, 0.20, 0.10) x "
         f"catalogue: b/b* = {np.round(b / b_star, 4).tolist()}, overbooking gain {gain:.4f}; "
         f"card vs CPU float32 rel err b {rel:.2e} t {rel_t:.2e}; solve {wall:.3f} s "
         f"({sol.iterations} outer steps)")
    return gain


# -- phase 7: timing -------------------------------------------------------

def times_ms(fn, flush: torch.Tensor, n: int = 30, warmup: int = 5) -> List[float]:
    """n launches, each timed with CUDA events, the L2 cache flushed
    before each by a 256 MiB write (which leaves the cache full of dirty
    lines that the launch pays to write back as it evicts them); sorted."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        flush.zero_()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)


def median_ms(fn, flush: torch.Tensor, n: int = 30, warmup: int = 5) -> float:
    """Median of times_ms."""
    return float(np.median(times_ms(fn, flush, n, warmup)))


def graph_ms(fn, n: int = 20) -> float:
    """ms per launch of n launches of fn captured in one CUDA graph and
    replayed once: back to back, no flush and no host time between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def host_ms(fn, n: int = 30, warmup: int = 5) -> float:
    """Median host wall-clock time of one call of fn and a synchronize (no
    flush): the wrapper's host path, the launch and the kernel together,
    what a caller that waits for each call pays."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def bound_ms(n_bytes: float, flops: float, dtype) -> tuple:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_k2(gq, pk, pv, pl, flush) -> dict:
    """K2, its plain version and an SDPA yardstick on one input; the bound
    counts the prefix rows below each length once, q, out and lse."""
    P, M, H, D = gq.shape
    S, KV = pk.shape[1], pk.shape[2]
    es = gq.element_size()
    valid = int(pl.clamp(0, S).sum())
    k2_bytes = 2 * valid * KV * D * es + 2 * gq.numel() * es + 4 * P + 4 * P * M * H
    k2_flops = 4.0 * M * H * valid * D
    # yardstick: one SDPA call on the same q and prefix K/V (heads expanded
    # beforehand, outside the timed region), without the lse output
    qs = gq.permute(0, 2, 1, 3)
    ks = pk.permute(0, 2, 1, 3).repeat_interleave(H // KV, dim=1)
    vs = pv.permute(0, 2, 1, 3).repeat_interleave(H // KV, dim=1)
    r = dict(
        ms=median_ms(lambda: shared_prefix_attention(gq, pk, pv, pl), flush),
        plain_ms=median_ms(lambda: shared_prefix_attention_plain(gq, pk, pv, pl), flush),
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs), flush),
        shape=f"P={P} M={M} H={H} KV={KV} D={D} S={S}",
    )
    r["bound_ms"], r["bound_by"] = bound_ms(k2_bytes, k2_flops, gq.dtype)
    return r


def k1_sdpa_inputs(q, k_pages, v_pages, bt, ctx: int) -> tuple:
    """K1's yardstick inputs: q as (B, H, 1, D) and each sequence's first
    ctx tokens of K and V gathered through its table into (B, KV, ctx, D),
    for one SDPA call with enable_gqa (made outside the timed region)."""
    B, _, D = q.shape
    KV, _, page, _ = k_pages.shape
    n = -(-ctx // page)
    idx = bt[:, :n].long()
    kg, vg = (p[:, idx].permute(1, 0, 2, 3, 4).reshape(B, KV, n * page, D)[:, :, :ctx].contiguous()
              for p in (k_pages, v_pages))
    return q[:, :, None, :], kg, vg


def k1_kernel_times(fn, flush) -> dict:
    """One K1 call fn timed three ways: flushed (median_ms), back to back
    in a CUDA graph (graph_ms) and on the host clock with a synchronize
    (host_ms)."""
    return dict(ms=median_ms(fn, flush), graph_ms=graph_ms(fn), host_ms=host_ms(fn))


def _time_k1(q, k_pages, v_pages, bt, cl, flush) -> dict:
    """K1 (k1_kernel_times), its plain version and an SDPA yardstick on one
    batch whose rows share one ctx. bound_ms counts the distinct pages the
    batch needs once (with q, out, tables and lengths); seq_bound_ms counts
    every sequence's pages."""
    B, H, D = q.shape
    KV, _, page, _ = k_pages.shape
    es = k_pages.element_size()
    ctx = int(cl[0])
    if not bool((cl == ctx).all()):
        _fail("K1 timing: the rows must share one ctx")
    n = -(-ctx // page)
    pages = int(torch.unique(bt[:, :n]).numel())
    small = 2 * q.numel() * es + 4 * (B * n + B)
    k1_flops = 4.0 * B * H * ctx * D
    qs, kg, vg = k1_sdpa_inputs(q, k_pages, v_pages, bt, ctx)
    r = k1_kernel_times(lambda: paged_attention(q, k_pages, v_pages, bt, cl), flush)
    r.update(
        plain_ms=median_ms(lambda: paged_attention_plain(q, k_pages, v_pages, bt, cl), flush),
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(qs, kg, vg, enable_gqa=True),
                             flush),
        library="SDPA on K/V gathered beforehand, enable_gqa",
        shape=f"B={B} H={H} KV={KV} D={D} ctx={ctx} page={page}, {pages} distinct pages",
    )
    r["bound_ms"], r["bound_by"] = bound_ms(2 * pages * KV * page * D * es + small, k1_flops,
                                            q.dtype)
    r["seq_bound_ms"], _ = bound_ms(2 * B * ctx * KV * D * es + small, k1_flops, q.dtype)
    return r


def _log_timing(name: str, r: dict) -> None:
    lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    if r.get("library"):
        lib += f" ({r['library']})"
    seq = f", per-sequence bound {r['seq_bound_ms']:.4f} ms" if "seq_bound_ms" in r else ""
    if "kernel_ms" in r:
        seq += (f"; the kernel alone on the padded inputs {r['kernel_ms']:.4f} ms, padded "
                f"work's bound {r['padded_bound_ms']:.4f} ms")
    extra = (f" (back to back {r['graph_ms']:.4f} ms, host-inclusive {r['host_ms']:.4f} ms)"
             if "graph_ms" in r else "")
    _log(f"[timing] {name} ({r['shape']}): kernel {r['ms']:.4f} ms{extra}, plain "
         f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
         f"({r['bound_by']}){seq}")


def _time_k3(q3, k3, v3, flush, causal: bool = True) -> dict:
    """K3 through the op (which pads widths the kernel is not built for,
    its copies timed with it), its plain version and an SDPA yardstick on
    one prefill (T = S) or encoder forward. The bound is the true work's:
    q, k, v and out once at their own widths, and the (t, s) pairs
    attended (s <= t when causal), each a D_qk and a D_v product; where
    the op pads, the kernel alone on the padded inputs is timed too
    (``kernel_ms``) and the padded work's bound given (``padded_bound_ms``)."""
    B, T, H, D = q3.shape
    KV, Dv = k3.shape[2], v3.shape[-1]
    es = q3.element_size()
    pairs = T * (T + 1) / 2 if causal else T * T
    k3_bytes = es * (q3.numel() + k3.numel() + v3.numel() + B * T * H * Dv)
    k3_flops = 2.0 * B * H * pairs * (D + Dv)
    Dp = kernel_head_dim(max(D, Dv))
    # yardstick: one SDPA call, layouts permuted beforehand (not timed)
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q3, k3, v3))
    r = dict(
        ms=median_ms(lambda: ops.flash_attention(q3, k3, v3, causal=causal), flush),
        plain_ms=median_ms(lambda: flash_attention_plain(q3, k3, v3, causal=causal), flush),
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal, enable_gqa=True), flush),
        shape=f"B={B} T=S={T} H={H} KV={KV} D={D}" + (f"/{Dv}" if Dv != D else "")
        + (" causal" if causal else " non-causal"),
    )
    r["bound_ms"], r["bound_by"] = bound_ms(k3_bytes, k3_flops, q3.dtype)
    if Dp != D or Dp != Dv:
        qp, kp, vp = (F.pad(x, (0, Dp - x.shape[-1])) for x in (q3, k3, v3))
        scale = 1.0 / D ** 0.5
        r["kernel_ms"] = median_ms(lambda: flash_attention(qp, kp, vp, causal=causal,
                                                           sm_scale=scale), flush)
        r["padded_bound_ms"], _ = bound_ms(es * (qp.numel() + kp.numel() + vp.numel()
                                                 + qp.numel()),
                                           4.0 * B * H * pairs * Dp, q3.dtype)
        r["shape"] += (f", padded to {Dp}: {k3_flops / 1e9:.1f} GFLOP of true work, "
                       f"{4.0 * B * H * pairs * Dp / 1e9:.1f} padded")
    return r


def phase_timing(device, sizes: Sizes, served: dict, grouped: dict, seed: int,
                 models: List[dict]) -> Dict[str, dict]:
    """Each kernel at the main path's shapes; K3 also at the prefill of
    every live model that runs it (``k3_by_model``: name -> ms)."""
    cfg = sizes.arch_config()
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
    k_pages, v_pages = served["engine"].pool.layer_pool(0)
    q, bt_t, cl = served["last"]
    # K1 first at the small-batch, long-context shape (a line of its own;
    # each sequence's pages distinct, in a pool of their own), then at the
    # serving phase's last decode batch (the kernels row)
    gen = torch.Generator(device=device).manual_seed(seed + 6)
    B1, H, KV, D = SMALL_BATCH_B, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    page, n = sizes.block_tokens, SMALL_BATCH_CTX // sizes.block_tokens
    sk, sv = (_randn(gen, (KV, B1 * n, page, D), k_pages.dtype, device) for _ in range(2))
    sbt = torch.randperm(B1 * n, generator=gen, device=device).to(torch.int32).reshape(B1, n)
    small = _time_k1(_randn(gen, (B1, H, D), k_pages.dtype, device), sk, sv, sbt,
                     torch.full((B1,), SMALL_BATCH_CTX, dtype=torch.int32, device=device), flush)
    del sk, sv
    _log_timing("paged_attention, small batch long context", small)
    res = {"paged_attention": _time_k1(q, k_pages, v_pages, bt_t, cl, flush)}

    # K2 first at the long-prefix, small-group shape (a line of its own),
    # then at the grouped phase's shape (the kernels row)
    gen = torch.Generator(device=device).manual_seed(seed + 5)
    Pl, Ml, Sl = LONG_PREFIX_P, LONG_PREFIX_M, LONG_PREFIX_S
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    long = _time_k2(_randn(gen, (Pl, Ml, H, D), torch.bfloat16, device),
                    _randn(gen, (Pl, Sl, KV, D), torch.bfloat16, device),
                    _randn(gen, (Pl, Sl, KV, D), torch.bfloat16, device),
                    torch.full((Pl,), Sl, dtype=torch.int32, device=device), flush)
    _log_timing("shared_prefix_attention, long prefix", long)
    res["shared_prefix_attention"] = _time_k2(grouped["q"], grouped["pk"], grouped["pv"],
                                              grouped["plens"], flush)
    # K3 at each live model's prefill (one prompt of T tokens, causal; a
    # vision model's also with its image tokens) or encoder forward (its
    # frames, non-causal); the kernels row at sizes.arch's, the others on
    # lines of their own
    by_model = {}
    for m in models:
        c = sizes.arch_config(m["name"])
        if not m["k3_per_request"]:
            continue
        H, KV, Dqk, Dv, causal = k3_shape(c)
        lengths = k3_lengths(c, sizes)
        for n in lengths:
            gen = torch.Generator(device=device).manual_seed(seed + 4)
            q3 = _randn(gen, (1, n, H, Dqk), torch.bfloat16, device)
            k3 = _randn(gen, (1, n, KV, Dqk), torch.bfloat16, device)
            v3 = _randn(gen, (1, n, KV, Dv), torch.bfloat16, device)
            r = _time_k3(q3, k3, v3, flush, causal)
            del q3, k3, v3
            if n != lengths[0]:
                _log_timing(f"flash_attention, {c.name} prefill with an image", r)
                continue
            by_model[m["name"]] = r["ms"]
            if c.name == cfg.name:
                res["flash_attention"] = r
            else:
                _log_timing(f"flash_attention, {c.name} "
                            f"{'forward' if c.is_encoder else 'prefill'}", r)
    for name, r in res.items():
        _log_timing(name, r)
    res["k3_by_model"] = by_model
    return res


# -- phase 9: train ------------------------------------------------------------

# K3-bwd against its plain version: f32 within 2e-4 (tests/test_kernels.py's
# gradient bound); bf16 within 2^-6 of the plain gradient's largest
# magnitude: the kernel rounds P and dS to bf16 as the operands of the next
# products (2^-9 relative each) and the gradients themselves (2^-9), about
# 2^-8 of the scale, with a 4x margin.
BWD_ATOL_F32 = 2e-4
BWD_BF16_REL = 2.0**-6
# The 4-layer full-width bf16 gradient hold, K3 + K3-bwd against both plain
# versions: each leaf's relative L2 error within 0.05. The forward and the
# backward each carry a bf16 rounding of 2^-9 a layer that the two routes
# make at other places (2 x 4 x 2^-9 = 0.016), and the kernels round P and
# dS to bf16 besides (another 0.016); 0.05 leaves a margin. The loss, a mean
# of 4096 cross-entropies near ln(151936) = 11.9, within 0.05 (2^-8 of it).
GRAD_REL_L2 = 0.05
GRAD_LOSS_ATOL = 0.05
# the profiled step of the full-depth run (0-based)
PROFILED_STEP = 4


def bwd_shapes(sizes: Sizes) -> List[tuple]:
    """(B, T, H, KV, D_qk, D_v, causal) of phase 9's K3-bwd checks:
    tests/test_kernels.py's gradient shape (D=16, padded to 64 by the op),
    then the training shapes of sizes.arch (sizes.train_batch sequences of
    sizes.train_seq tokens, the main path's own shape),
    granite-moe-1b, deepseek-v2's MLA and hubert's encoder (its frames),
    then G = 1 and G = 8 at sizes.arch's head size, and sizes.arch's
    shape at a ragged length (1000 of 1024 tokens: the kernels' last
    tiles part full)."""
    out = [(2, 32, 4, 2, 16, 16, True)]
    for name in (sizes.arch, "granite-moe-1b-a400m", "deepseek-v2-236b", "hubert-xlarge"):
        cfg = sizes.arch_config(name)
        B = sizes.train_batch if name == sizes.arch else 1
        out.append((B, sizes.audio_frames if cfg.is_encoder else sizes.train_seq) + k3_shape(cfg))
    D = sizes.arch_config().head_dim
    return out + [(1, sizes.train_seq // 2, 8, 8, D, D, True),
                  (1, sizes.train_seq // 2, 16, 2, D, D, True),
                  (sizes.train_batch, sizes.train_seq * 125 // 128) + out[1][2:]]


def _padded(x: torch.Tensor, D: int) -> torch.Tensor:
    return F.pad(x, (0, D - x.shape[-1])) if x.shape[-1] != D else x


def phase_train_kernels(device, sizes: Sizes, errs: Errors, seed: int) -> None:
    """(a) K3 with its lse and K3-bwd against their plain versions on the
    same inputs, zero-padded as the op pads them (scale 1/sqrt(D_qk))."""
    gen = torch.Generator(device=device).manual_seed(seed + 9)
    for dtype in (torch.float32, torch.bfloat16):
        for B, T, H, KV, Dqk, Dv, causal in bwd_shapes(sizes):
            D = kernel_head_dim(max(Dqk, Dv))
            q, do = (_padded(_randn(gen, (B, T, H, d), dtype, device), D) for d in (Dqk, Dv))
            k, v = (_padded(_randn(gen, (B, T, KV, d), dtype, device), D) for d in (Dqk, Dv))
            kw = dict(causal=causal, sm_scale=1.0 / Dqk ** 0.5)
            what = (f"K3-bwd {str(dtype)[6:]} B={B} T={T} H={H} KV={KV} D={Dqk}/{Dv}"
                    f"{f' (padded to {D})' if D != Dqk or D != Dv else ''} causal={int(causal)}")
            out, lse = flash_attention_fwd(q, k, v, **kw)
            want_out, want_lse = flash_attention_fwd_plain(q, k, v, **kw)
            errs.check("flash_attention", out, want_out, ATOL[dtype], what + ": K3 out")
            lse_err = float((lse - want_lse).abs().max())
            if not lse_err <= LSE_ATOL[dtype]:
                _fail(f"{what}: K3 lse max abs err {lse_err:.3e} > {LSE_ATOL[dtype]:.1e}")
            got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
            want = flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
            line = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                atol = (BWD_ATOL_F32 if dtype == torch.float32
                        else BWD_BF16_REL * float(w.float().abs().max()))
                err = errs.check("flash_attention_bwd", g, w, atol, f"{what}: {name}")
                line.append(f"{name} {err:.3e} (bound {atol:.2e})")
            _log(f"[train] {what}: K3 lse err {lse_err:.3e}; max abs err " + ", ".join(line))
    if device.type == "cuda":
        torch.cuda.synchronize()


@contextmanager
def plain_training_attention():
    """Within the block, the autograd function of the models' windowless
    attention runs K3's and K3-bwd's plain versions (this script only; the
    port has no such switch)."""
    fwd, bwd = k3_module.flash_attention_fwd, k3_module.flash_attention_bwd
    k3_module.flash_attention_fwd = flash_attention_fwd_plain
    k3_module.flash_attention_bwd = flash_attention_bwd_plain
    try:
        yield
    finally:
        k3_module.flash_attention_fwd, k3_module.flash_attention_bwd = fwd, bwd


def _train_batch(cfg, sizes: Sizes, seed: int, device, batch: int = 0, seq: int = 0) -> dict:
    data = SyntheticLMData(cfg.vocab_size, seq or sizes.train_seq, batch or sizes.train_batch,
                           seed=seed)
    return {k: torch.as_tensor(v, device=device) for k, v in data.next_batch().items()}


def _allocated_gb(device) -> float:
    return torch.cuda.memory_allocated() / 1e9 if device.type == "cuda" else 0.0


def _rel_l2(g: torch.Tensor, w: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp(min=1e-30))


def phase_train_grads(device, sizes: Sizes, seed: int, arch: str = "", layers: int = 0,
                      batch: int = 0, seq: int = 0) -> dict:
    """(b), and (f)'s and (g)'s holds: ``arch`` (sizes.arch) at full width
    and ``layers`` (sizes.grad_layers) layers, f32 masters and bf16 compute
    (the launcher's TrainConfig), ``batch`` x ``seq`` tokens (the training
    batch): one step's loss and gradients through K3 + K3-bwd, then through
    both plain versions on the same device (an MoE model's second pass
    replays the first's routing, RouteTape; the first pass's gradients
    wait in host memory); each leaf's relative L2 error, the loss
    difference, the attention parameters' gradients nonzero on the kernel
    route, and K3 / K3-bwd launched once a global-attention layer."""
    cfg = dataclasses.replace(sizes.arch_config(arch), n_layers=layers or sizes.grad_layers)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model = make_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    data = _train_batch(cfg, sizes, seed, device, batch, seq)
    grad_fn = make_grad_fn(model, TrainConfig())
    tape = RouteTape()
    n3, nb = flash_attention.launches, flash_attention_bwd.launches
    with shardctx.rules({"moe_apply": tape} if cfg.moe else {}):
        loss, _, grads = grad_fn(params, data)
    got = (flash_attention.launches - n3, flash_attention_bwd.launches - nb)
    want_n = (attn_layers(cfg), attn_layers(cfg))
    if device.type == "cuda" and got != want_n:
        _fail(f"train grads {cfg.name}: K3 / K3-bwd launched {got}, not {want_n}")
    zero = [path for path, g in flatten_with_paths(grads)
            if "['attn']" in path and not float(g.abs().max()) > 0.0]
    mem = [_allocated_gb(device)]
    grads = [(path, g.to("cpu")) for path, g in flatten_with_paths(grads)]
    gc.collect()
    mem.append(_allocated_gb(device))
    with plain_training_attention(), shardctx.rules(
            {"moe_apply": RouteTape(tape.routes)} if cfg.moe else {}):
        want_loss, _, want = grad_fn(params, data)
    worst, worst_path = 0.0, ""
    for (path, g), (_, w) in zip(grads, flatten_with_paths(want)):
        rel = _rel_l2(g.to(w.device), w)
        if rel > worst:
            worst, worst_path = rel, path
    dloss = abs(float(loss) - float(want_loss))
    n_params = sum(p.numel() for _, p in flatten_with_paths(params))
    B, T = data["tokens"].shape
    _log(f"[train] gradient hold {cfg.name} at full width, {cfg.n_layers} of "
         f"{get_config(cfg.name).n_layers} layers ({n_params / 1e9:.3f} B f32 masters, bf16 "
         f"compute), B={B} x T={T}: loss {float(loss):.5f} "
         f"(plain route {float(want_loss):.5f}, |diff| {dloss:.2e}, bound {GRAD_LOSS_ATOL}); "
         f"worst leaf relative L2 error {worst:.3e} ({worst_path}, bound {GRAD_REL_L2}); "
         f"K3 / K3-bwd launches {got}" + (f"; {len(tape.routes)} MoE routings replayed"
                                          if cfg.moe else "") + "; peak device memory "
         + (f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (allocated after the kernel "
            f"route {mem[0]:.2f} GB, its gradients in host memory {mem[1]:.2f} GB)"
            if device.type == "cuda" else "not measured"))
    if zero:
        _fail(f"train grads {cfg.name}: zero gradients for {zero}")
    if not (dloss <= GRAD_LOSS_ATOL and worst <= GRAD_REL_L2):
        _fail(f"train grads {cfg.name}: loss diff {dloss:.3e} or leaf rel L2 {worst:.3e} "
              f"({worst_path}) out of bounds")
    return dict(loss_diff=dloss, worst_rel=worst, worst_path=worst_path, launches=got,
                n_params=n_params)


def phase_train_run(device, sizes: Sizes, seed: int, card: str, arch: str = "",
                    profiled: bool = True) -> dict:
    """(c), and (f): the launcher's training run of ``arch`` (sizes.arch)
    at full width and depth (--remat) on its training batch
    (``train_shape``): the loss, host-clock ms, tokens/s and K3 / K3-bwd
    launches of each step, the peak device memory, and (``profiled``) step
    PROFILED_STEP under torch.profiler (started and stopped around it by
    the step callback). Returns the per-step records and the run's launch
    counts."""
    from torch.profiler import ProfilerActivity, profile

    arch = arch or sizes.arch
    B, T = train_shape(sizes, arch)
    argv = ["--arch", arch, "--steps", str(sizes.train_steps), "--batch",
            str(B), "--seq", str(T), "--lr", "3e-3", "--remat",
            "--seed", str(seed), "--data-seed", str(seed), "--log-every", "1"]
    argv += ["--reduced"] * sizes.reduced + ["--device", device.type]
    cfg = sizes.arch_config(arch)
    tokens = B * T
    steps, prof = [], {}
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    last = [0, 0]

    def on_step(step: int, loss: float, dt: float) -> None:
        k3_n, bwd_n = flash_attention.launches, flash_attention_bwd.launches
        steps.append(dict(step=step, loss=loss, ms=1e3 * dt, tokens_per_s=tokens / dt,
                          k3=k3_n - last[0], k3_bwd=bwd_n - last[1]))
        last[:] = [k3_n, bwd_n]
        _log(f"[train] {cfg.name} step {step}: loss {loss:.5f}, {1e3 * dt:.2f} ms (host "
             f"clock), {tokens / dt:.1f} tokens/s, launches K3 {steps[-1]['k3']} K3-bwd "
             f"{steps[-1]['k3_bwd']}")
        if not profiled:
            return
        if step == PROFILED_STEP - 1:
            prof["p"] = profile(activities=acts)
            prof["p"].start()
            prof["t0"] = time.perf_counter()
        elif step == PROFILED_STEP and "p" in prof:
            if device.type == "cuda":
                torch.cuda.synchronize()
            prof["wall_ms"] = 1e3 * (time.perf_counter() - prof["t0"])
            prof["p"].stop()

    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()                                  # the training path starts here
    t0 = time.perf_counter()
    rc = train_launcher.main(argv, on_step=on_step)
    wall = time.perf_counter() - t0
    run_launches = launches()                         # ... and ends here
    peak = torch.cuda.max_memory_allocated() / 1e9 if device.type == "cuda" else None
    losses = [r["loss"] for r in steps]
    if rc != 0 or len(steps) != sizes.train_steps:
        _fail(f"train run: the launcher returned {rc} after {len(steps)} steps")
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        _fail(f"train run: losses {losses} not finite, or not lower at the last step")
    per_step = (2 * attn_layers(cfg), attn_layers(cfg))   # --remat runs each forward twice
    for r in steps:
        if device.type == "cuda" and (r["k3"], r["k3_bwd"]) != per_step:
            _fail(f"train run: step {r['step']} launched K3 / K3-bwd {(r['k3'], r['k3_bwd'])}, "
                  f"not {per_step}")
    busy, top, groups, ranges = _busy(prof["p"]) if "p" in prof else (None, [], {}, {})
    med = float(np.median([r["ms"] for r in steps[1:]]))
    _log(f"[train] {cfg.name} on {card}: {sizes.train_steps} steps of {B} x "
         f"{T} tokens in {wall:.2f} s (host clock, set-up included); loss "
         f"{losses[0]:.5f} -> {losses[-1]:.5f}; median step {med:.2f} ms ({tokens / med * 1e3:.1f}"
         f" tokens/s; the first {steps[0]['ms']:.2f} ms); peak device memory "
         + (f"{peak:.2f} GB" if peak is not None else "not measured") + f"; launches {run_launches}")
    what = f"[train] {cfg.name} profiled step {PROFILED_STEP}"
    if profiled and busy is None:
        _log(f"{what}: {prof.get('wall_ms', 0):.2f} ms (host clock); device time not measured "
             f"(the profiler saw no device activity)")
    elif profiled:
        shown = "; ".join(f"{k[:60]} x{n} {ms:.3f} ms" for k, ms, n in top)
        _log(f"{what}: {prof['wall_ms']:.2f} ms (host clock, profiler on), card busy "
             f"{busy:.2f} ms, idle share {1 - busy / prof['wall_ms']:.3f}; largest: {shown}")
        _log(f"{what}, busy ms by kernel: "
             + ", ".join(f"{k} {ms:.2f}" for k, ms in groups.items())
             + "; by range (device ms of the kernels each launched): "
             + ", ".join(f"{k} {ms:.2f}" for k, ms in sorted(ranges.items()))
             + f", the backward (remat's forward in it) and the rest "
             f"{busy - sum(ranges.values()):.2f}")
    return dict(steps=steps, launches=run_launches, peak_gb=peak, median_ms=med,
                profile_busy_ms=busy, profile_wall_ms=prof.get("wall_ms"),
                profile_groups=groups, profile_ranges=ranges, cfg=cfg)


def sizes_window(sizes: Sizes) -> tuple:
    """recurrentgemma-2b's local-attention window and the tokens of its
    training sequence, which must pass it."""
    return sizes.arch_config("recurrentgemma-2b").window, sizes.window_seq


def train_shape(sizes: Sizes, arch: str) -> tuple:
    """(B, T) of ``arch``'s training batch: sizes.train_batch x
    sizes.train_seq, but recurrentgemma-2b's one sequence of
    sizes.window_seq tokens, past its 2048-token window (its 256,000-wide
    f32 logits and their gradient take 8.4 GB at 4096 tokens), and
    GRAD_ONLY_ARCH's one sequence (at B=4 its plain route's dense scores,
    128 heads of 1024 x 1024 in f32, do not fit beside its 30 GB of
    masters and gradients)."""
    name = get_config(arch).name
    if name == "recurrentgemma-2b":
        return 1, sizes.window_seq
    if name == GRAD_ONLY_ARCH:
        return 1, sizes.train_seq
    return sizes.train_batch, sizes.train_seq


# -- phase 9 (e)-(g): training state on a mesh, the other families ------------

# the families that train on the card besides sizes.arch (f), and the one
# whose loss and gradient are held at one layer (g): deepseek-v2's 5.02 B
# parameters of one layer with the embedding and head take 16 bytes each
# with AdamW (80.3 GB), more than the card holds at any depth
TRAIN_ARCHS = ("granite-moe-1b-a400m", "recurrentgemma-2b")
GRAD_ONLY_ARCH, GRAD_ONLY_LAYERS = "deepseek-v2-236b", 1
MESH_ROUNDS = 4             # (e): full-size steps with and without the mesh, in turns


def mesh_vs_plain(device, sizes: Sizes, seed: int, mesh, arch: str, n_steps: int) -> dict:
    """``arch`` at full width and sizes.grad_layers layers (--remat): one
    state drawn from the seed, copied; the copy placed replicated on
    ``mesh`` (reshard_state) takes ``n_steps`` data-parallel steps and the
    other as many plain steps on the same batches. The losses must be
    equal and every leaf bit-identical (a sum over one rank changes no
    bit); the collectives a step are counted."""
    from repro_torch.training.tree import leaves, tree_map

    cfg = dataclasses.replace(sizes.arch_config(arch), n_layers=sizes.grad_layers)
    model = make_model(cfg, remat=True)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=n_steps))
    plain = init_train_state(model, torch.Generator(device=device).manual_seed(seed), tcfg)
    placed = reshard_state(tree_map(torch.clone, plain), Sharding(mesh))
    step = make_train_step(model, tcfg)
    B, T = train_shape(sizes, arch)
    data = SyntheticLMData(cfg.vocab_size, T, B, seed=seed)
    losses, calls = {"mesh": [], "plain": []}, []
    for _ in range(n_steps):
        batch = {k: torch.as_tensor(v, device=device) for k, v in data.next_batch().items()}
        placed, m = step(placed, batch)
        losses["mesh"].append(float(m["loss"]))
        calls.append(int(m["collectives"]))
        plain, m = step(plain, batch)
        losses["plain"].append(float(m["loss"]))
    same = all(a.dtype == b.dtype and torch.equal(a.to_local(), b)
               for a, b in zip(leaves(placed), leaves(plain)))
    n_params = sum(p.numel() for _, p in flatten_with_paths(plain["params"]))
    _log(f"[train] mesh {tuple(mesh.shape)} {tuple(mesh.mesh_dim_names)}: {cfg.name} at full "
         f"width, {cfg.n_layers} layers ({n_params / 1e9:.3f} B), B={B} x T={T}: {n_steps} "
         f"data-parallel steps, losses {losses['mesh']}; plain steps {losses['plain']}; every "
         f"leaf bit-identical: {same}; collectives a step {calls}")
    if losses["mesh"] != losses["plain"] or not same:
        _fail(f"train mesh {cfg.name}: the data-parallel step is not the plain step at world 1")
    return dict(plain=plain, placed=placed, losses=losses["mesh"], calls=calls[0], cfg=cfg,
                n_params=n_params)


def mesh_checkpoint(placed, mesh) -> dict:
    """(e) the placed state saved through the Checkpointer (rank 0 writes,
    then a barrier) and restored onto the mesh (a single spec), bit for
    bit; host-clock seconds and bytes of each."""
    from repro_torch.training.checkpoint import Checkpointer
    from repro_torch.training.tree import leaves

    n_bytes = sum(t.numel() * t.element_size() for t in leaves(placed))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        t0 = time.perf_counter()
        ck.save(1, placed, {"step": 1})
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        back, extras = ck.restore(None, placed, shardings=Sharding(mesh))
        t_restore = time.perf_counter() - t0
        same = extras["step"] == 1 and all(
            a.placements == b.placements and torch.equal(a.to_local(), b.to_local())
            for a, b in zip(leaves(back), leaves(placed)))
    _log(f"[train] checkpoint of the placed state ({n_bytes / 1e9:.2f} GB): saved in "
         f"{t_save:.2f} s, restored onto the mesh in {t_restore:.2f} s (host clock); "
         f"bit-identical: {same}")
    if not same:
        _fail("train mesh: the restored state differs from the saved one")
    return dict(bytes=n_bytes, save_s=t_save, restore_s=t_restore)


def time_mesh_step(device, sizes: Sizes, seed: int, mesh) -> dict:
    """(e) sizes.arch at full width and depth (--remat): one state placed
    replicated on ``mesh``; a step with the mesh (the data-parallel step
    on the DTensor state) and without it (the plain step on its local
    tensors, the same storage), MESH_ROUNDS each in turns after one of
    each to warm up; medians on the host clock, and the collectives a
    step."""
    from repro_torch.training.tree import tree_map

    cfg = sizes.arch_config()
    model = make_model(cfg, remat=True)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=100))
    placed = reshard_state(
        init_train_state(model, torch.Generator(device=device).manual_seed(seed), tcfg),
        Sharding(mesh))
    with torch.no_grad():
        local = tree_map(lambda t: t.to_local(), placed)
    step = make_train_step(model, tcfg)
    data = SyntheticLMData(cfg.vocab_size, sizes.train_seq, sizes.train_batch, seed=seed)
    ms = {"mesh": [], "plain": []}
    calls = []
    for rnd in range(MESH_ROUNDS + 1):
        for name in (("mesh", "plain") if rnd % 2 == 0 else ("plain", "mesh")):
            batch = {k: torch.as_tensor(v, device=device) for k, v in data.next_batch().items()}
            _sync(device)
            t0 = time.perf_counter()
            _, m = step(placed if name == "mesh" else local, batch)
            float(m["loss"])
            if rnd:
                ms[name].append(1e3 * (time.perf_counter() - t0))
            if name == "mesh":
                calls.append(int(m["collectives"]))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    n_leaves = len(flatten_with_paths(placed["params"]))
    _log(f"[train] {cfg.name} full width and depth on mesh {tuple(mesh.shape)}: a step "
         f"{med['mesh']:.2f} ms with the mesh, {med['plain']:.2f} ms without (medians of "
         f"{MESH_ROUNDS} each, in turns, host clock; {ms}); {calls[0]} collectives a step "
         f"({n_leaves} gradient all-reduces, one a parameter leaf, and the loss's sums); "
         f"difference {med['mesh'] - med['plain']:.2f} ms, "
         f"{(med['mesh'] - med['plain']) / calls[0]:.3f} ms a collective")
    return dict(mesh_ms=med["mesh"], plain_ms=med["plain"], calls=calls[0], all_ms=ms)


def phase_train_mesh(device, sizes: Sizes, seed: int, card: str) -> dict:
    """(e)-(g): (e) a one-rank group and a (data=1) mesh: the 4-layer
    data-parallel steps against the plain ones, the placed checkpoint,
    the full-size step timed with and without the mesh; (f) each of
    TRAIN_ARCHS through the launcher, its 4-layer gradient hold, and
    granite's data-parallel steps on the mesh (its aux all-reduce and
    ``moe_chunks``); (g) GRAD_ONLY_ARCH's one-layer gradient hold. Returns
    the records and the launches of the training paths ((e)'s steps, (f)'s
    runs, (g)'s kernel route); the holds' plain routes and (f)'s holds
    are checks, not counted."""
    out, path = {}, {k: 0 for k in KERNELS}

    def count(fn, counted: bool = True):
        before = launches()
        r = fn()
        # a launcher run counts from its own start (phase_train_run resets)
        got = r["launches"] if "steps" in r else {k: v - before[k] for k, v in launches().items()}
        if counted:
            for k, v in got.items():
                path[k] += v
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        held_gb.append(_allocated_gb(device))
        return r

    held_gb = []        # device memory still allocated after each part

    with one_rank_group(device) as backend:
        mesh = launch_mesh.make_mesh((1,), ("data",), device=device)
        _log(f"[train] one-rank {backend} group (file store), mesh {tuple(mesh.shape)} "
             f"{tuple(mesh.mesh_dim_names)} on {device}")
        held = count(lambda: mesh_vs_plain(device, sizes, seed, mesh, sizes.arch,
                                           sizes.mesh_steps))
        out["mesh_ckpt"] = mesh_checkpoint(held.pop("placed"), mesh)
        del held["plain"]
        out["mesh_steps"] = held
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out["mesh_timing"] = count(lambda: time_mesh_step(device, sizes, seed, mesh))
        moe_mesh = count(lambda: mesh_vs_plain(device, sizes, seed, mesh, TRAIN_ARCHS[0], 2))
        del moe_mesh["plain"], moe_mesh["placed"]
        out["moe_mesh_steps"] = moe_mesh
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    held_gb.append(_allocated_gb(device))
    _log(f"[train] device memory allocated after each part of (e) and after the group: "
         f"{held_gb} GB")
    window, T = sizes_window(sizes)
    if not T > window:
        _fail(f"train: recurrentgemma-2b's {T} tokens do not pass its window of {window}")
    for arch in TRAIN_ARCHS:
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        out[arch] = count(lambda: phase_train_run(device, sizes, seed, card, arch))
        out[arch]["grads"] = count(lambda: phase_train_grads(
            device, sizes, seed, arch, batch=train_shape(sizes, arch)[0],
            seq=train_shape(sizes, arch)[1]), counted=False)
    _log(f"[train] device memory allocated after each part of (e) and (f): {held_gb} GB")
    B, T = train_shape(sizes, GRAD_ONLY_ARCH)
    out[GRAD_ONLY_ARCH] = phase_train_grads(device, sizes, seed, GRAD_ONLY_ARCH,
                                            layers=GRAD_ONLY_LAYERS, batch=B, seq=T)
    # the kernel route's launches (K3 once, K3-bwd once) are the path's
    for k, v in zip(("flash_attention", "flash_attention_bwd"),
                    out[GRAD_ONLY_ARCH]["launches"]):
        path[k] += v
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["launches"] = path
    return out


def bwd_timing_shapes(sizes: Sizes) -> List[tuple]:
    """(B, T, H, KV, D_qk, D_v, causal) at which K3-bwd is timed, each at
    sizes.train_batch sequences: sizes.arch's training shape (the main
    path's, first), granite-moe-1b's (D=64), deepseek-v2's MLA (H=128,
    192/128, padded to 256) and hubert's encoder (its frames, 80 padded to
    128, non-causal)."""
    out = []
    for name in (sizes.arch, "granite-moe-1b-a400m", "deepseek-v2-236b", "hubert-xlarge"):
        cfg = sizes.arch_config(name)
        T = sizes.audio_frames if cfg.is_encoder else sizes.train_seq
        out.append((sizes.train_batch, T) + k3_shape(cfg))
    return out


def k3_bwd_times(shape: tuple, gen, device, flush, plain: bool = True) -> dict:
    """K3-bwd at one (B, T, H, KV, D_qk, D_v, causal) shape in bf16, on
    inputs zero-padded as the op pads them: flushed (median_ms) and back
    to back in a CUDA graph (graph_ms); its plain version (unless not
    ``plain``); and the backward of SDPA through autograd on the unpadded
    inputs (the yardstick; the min and median of its flushed times, which
    moved most between calls). The bound is the true work's: five
    products of the attended (t, s) pairs (S, dK, dQ of D_qk; dP, dV of
    D_v) at the bf16 dense peak, against q, k, v, out, dout and lse read
    once and dq, dk, dv written once, at their own widths."""
    B, T, H, KV, Dqk, Dv, causal = shape
    D = kernel_head_dim(max(Dqk, Dv))
    dt = torch.bfloat16
    q, do = (_randn(gen, (B, T, H, d), dt, device) for d in (Dqk, Dv))
    k, v = (_randn(gen, (B, T, KV, d), dt, device) for d in (Dqk, Dv))
    kw = dict(causal=causal, sm_scale=1.0 / Dqk ** 0.5)
    qp, kp, vp, dop = (_padded(x, D) for x in (q, k, v, do))
    out, lse = flash_attention_fwd(qp, kp, vp, **kw)
    pairs = T * (T + 1) / 2 if causal else T * T
    flops = 2.0 * B * H * pairs * (3 * Dqk + 2 * Dv)
    n_bytes = q.element_size() * (2 * (q.numel() + k.numel() + v.numel()) + 2 * do.numel()) \
        + 4 * lse.numel()
    qs, ks, vs = (x.permute(0, 2, 1, 3).detach().requires_grad_() for x in (q, k, v))
    os_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal, enable_gqa=True)
    dos = do.permute(0, 2, 1, 3)
    lib = times_ms(lambda: torch.autograd.grad(os_, (qs, ks, vs), dos, retain_graph=True), flush)
    fn = lambda: flash_attention_bwd(qp, kp, vp, out, lse, dop, **kw)  # noqa: E731
    r = dict(
        ms=median_ms(fn, flush), graph_ms=graph_ms(fn),
        plain_ms=median_ms(lambda: flash_attention_bwd_plain(qp, kp, vp, out, lse, dop, **kw),
                           flush) if plain else None,
        library_ms=float(np.median(lib)), library_min_ms=lib[0],
        library="the backward of F.scaled_dot_product_attention (enable_gqa) through autograd",
        shape=f"B={B} T=S={T} H={H} KV={KV} D={Dqk}" + (f"/{Dv}" if Dv != Dqk else "")
        + (f" (padded to {D})" if D != Dqk or D != Dv else "")
        + (" causal" if causal else " non-causal") + ", bf16",
    )
    r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, flops, dt)
    return r


def _log_bwd_timing(r: dict) -> None:
    plain = "not timed" if r["plain_ms"] is None else f"{r['plain_ms']:.4f} ms"
    _log(f"[timing] flash_attention_bwd ({r['shape']}): kernel {r['ms']:.4f} ms (back to "
         f"back {r['graph_ms']:.4f} ms), plain {plain}, library {r['library_ms']:.4f} ms "
         f"median, {r['library_min_ms']:.4f} min ({r['library']}), bound {r['bound_ms']:.4f} "
         f"ms ({r['bound_by']}), {r['ms'] / r['bound_ms']:.2f}x it")


def time_k3_bwd(device, sizes: Sizes, seed: int, flush) -> dict:
    """(d) K3-bwd at each of bwd_timing_shapes (k3_bwd_times), each
    logged; returns the main path's shape's times (the first)."""
    gen = torch.Generator(device=device).manual_seed(seed + 10)
    times = []
    for shape in bwd_timing_shapes(sizes):
        times.append(k3_bwd_times(shape, gen, device, flush))
        _log_bwd_timing(times[-1])
        torch.cuda.empty_cache()
    return times[0]


def phase_train(device, sizes: Sizes, errs: Errors, seed: int, card: str) -> dict:
    """Phase 9: (a) the kernels, (b) the gradient hold, (c) the training
    run (its launches: the training path's), (e)-(g) training state on a
    mesh and the other families (phase_train_mesh; its paths' launches
    too), (d) K3-bwd's timing."""
    t0 = time.perf_counter()
    phase_train_kernels(device, sizes, errs, seed)
    grads = phase_train_grads(device, sizes, seed)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run = phase_train_run(device, sizes, seed, card)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    mesh = phase_train_mesh(device, sizes, seed, card)
    timing = None
    if device.type == "cuda":
        flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=device)
        timing = time_k3_bwd(device, sizes, seed, flush)
    _log(f"[train] phase 9 took {time.perf_counter() - t0:.1f} s (host clock)")
    return dict(grads=grads, run=run, mesh=mesh, timing=timing)


# -- phase 10: launch --------------------------------------------------------

# rounds of the with/without comparisons, in turns (A B, B A, ...): a
# granite prefill each, LAUNCH_STEPS qwen3 decode steps each; medians
LAUNCH_ROUNDS = 4
LAUNCH_STEPS = 8
SERVE_REQUESTS = 60         # the serving CLI's default


@contextmanager
def one_rank_group(device):
    """A process group of one rank through a ``file://`` store in a
    temporary directory (no TCP port): NCCL on the card, gloo for a CPU
    rehearsal; a group that does not start fails the phase. Destroyed on
    the way out."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as d:
        if device.type == "cuda":
            torch.cuda.set_device(device.index or 0)
        dist.init_process_group(backend, init_method=f"file://{d}/store", world_size=1, rank=0)
        try:
            yield backend
        finally:
            dist.destroy_process_group()


class RouteSpy:
    """Records every routing that ``fn`` (``moe_route``) returns; this
    script's means of comparing two prefills' routings."""

    def __init__(self, fn) -> None:
        self.fn, self.routes = fn, []

    def __call__(self, *args, **kw):
        r = self.fn(*args, **kw)
        self.routes.append(r)
        return r


def _served_tokens(live: dict) -> List[np.ndarray]:
    return [r.output for r in live["results"]]


def launch_flash_decode(device, sizes: Sizes, seed: int, mesh) -> dict:
    """(a) qwen3-1.7b served twice with the live phase's requests, the
    second time with the flash-decode override installed: the same greedy
    tokens; the first request's prefill and one decode step, with and
    without it, last-token logits within LIVE_LOGITS_RTOL of their scale;
    the decode ms per token of each run, and of one decode step timed in
    turns with and without it on the same cache."""
    arch = LIVE_ARCHS[0]
    override = flash_decode.make_decode_attention(mesh)
    if override is None:
        _fail("launch: make_decode_attention gave no override on a mesh with a model axis")
    plain = phase_live(device, sizes, seed, arch)
    want_tokens, plain_ms = _served_tokens(plain), 1e3 * float(np.median(plain["timed"].decode_s))
    del plain
    with shardctx.rules({"decode_attention": override}):
        live = phase_live(device, sizes, seed, arch)
    got_tokens, fd_ms = _served_tokens(live), 1e3 * float(np.median(live["timed"].decode_s))
    for i, (g, w) in enumerate(zip(got_tokens, want_tokens)):
        if not np.array_equal(g, w):
            _fail(f"launch: {arch} request {i}: greedy tokens {g.tolist()} with flash-decode, "
                  f"{w.tolist()} without")
    model, params, cfg, tokens = live["model"], live["params"], live["cfg"], live["requests"][0]
    dev = params["embed"].device
    S = len(tokens) + sizes.new_tokens
    with torch.inference_mode():
        logits, caches = model.prefill(
            params, {"tokens": torch.as_tensor(tokens[None, :], device=dev)}, S)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        pos = torch.full((1,), len(tokens), dtype=torch.int32, device=dev)
        want, _ = model.decode_step(params, tok, _tree_map(torch.clone, caches), pos)
        with shardctx.rules({"decode_attention": override}):
            got, _ = model.decode_step(params, tok, caches, pos)
        # the same step timed in turns, plain and flash-decode, on one cache
        step_s = {"plain": [], "flash-decode": []}
        for rnd in range(LAUNCH_ROUNDS):
            for name in (("plain", "flash-decode") if rnd % 2 == 0 else
                         ("flash-decode", "plain")):
                with shardctx.rules({"decode_attention": override} if name != "plain" else {}):
                    for _ in range(LAUNCH_STEPS):
                        _sync(device)
                        t0 = time.perf_counter()
                        model.decode_step(params, tok, caches, pos)
                        _sync(device)
                        step_s[name].append(time.perf_counter() - t0)
    got, want = got[0, -1].float(), want[0, -1].float()
    scale, err = float(want.abs().max()), float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= LIVE_LOGITS_RTOL * scale):
        _fail(f"launch: {arch} decode step with flash-decode: logits differ by {err:.3e} "
              f"(> {LIVE_LOGITS_RTOL} x scale {scale:.3e})")
    step_ms = {k: 1e3 * float(np.median(v)) for k, v in step_s.items()}
    _log(f"[launch] {arch} flash-decode (model axis of 1): {len(got_tokens)} requests x "
         f"{sizes.new_tokens} greedy tokens the same as without it; a decode step's last-token "
         f"logits max abs err {err:.3e} (scale {scale:.3e}, limit {LIVE_LOGITS_RTOL * scale:.3e}); "
         f"served decode {fd_ms:.2f} ms per token with the override, {plain_ms:.2f} without "
         f"(median of {len(live['timed'].decode_s)} steps each, host clock); one step in turns "
         f"({LAUNCH_ROUNDS} rounds of {LAUNCH_STEPS}): {step_ms['flash-decode']:.2f} ms with, "
         f"{step_ms['plain']:.2f} ms without (medians, host clock)")
    return dict(decode_ms=fd_ms, plain_decode_ms=plain_ms, logits_err=err,
                step_ms=step_ms["flash-decode"], plain_step_ms=step_ms["plain"],
                prefills=2 * len(got_tokens) + 1, cfg=cfg)


def launch_moe_ep(device, sizes: Sizes, seed: int, mesh) -> dict:
    """(b) granite-moe-1b prefills the live phase's first request with
    ``make_moe_apply_ep`` installed and without it: at a model axis of 1
    the per-rank capacity is ``moe_apply``'s and the slot order the same,
    so every layer keeps the same slots (keep and dest equal) and the
    last-token logits agree within LIVE_LOGITS_RTOL of their scale; the
    prefill ms of each (medians of LAUNCH_ROUNDS prefills in turns)."""
    arch = LIVE_ARCHS[1]
    cfg = sizes.arch_config(arch)
    ep = moe_ep.make_moe_apply_ep(mesh, cfg)
    if ep is None:
        _fail(f"launch: make_moe_apply_ep gave no override for {arch}")
    model, params, _ = _init_model(device, cfg, seed, "launch")
    rng = np.random.default_rng(seed + 3)
    tokens = np.concatenate([rng.integers(0, cfg.vocab_size, sizes.prefix_tokens),
                             rng.integers(0, cfg.vocab_size, sizes.user_tokens)])
    batch = {"tokens": torch.as_tensor(tokens[None, :], device=device)}
    S = len(tokens) + sizes.new_tokens
    timed = TimedModel(model, device)
    runs = {"moe_apply": dict(rules={}, owner=moe, s=[]),
            "EP": dict(rules={"moe_apply": ep}, owner=moe_ep, s=[])}
    for rnd in range(LAUNCH_ROUNDS):                  # in turns: A B, B A, ...
        for name in (("moe_apply", "EP") if rnd % 2 == 0 else ("EP", "moe_apply")):
            run = runs[name]
            spy = RouteSpy(run["owner"].moe_route)
            run["owner"].moe_route = spy
            try:
                with torch.inference_mode(), shardctx.rules(run["rules"]):
                    logits, _ = timed.prefill(params, batch, S)
            finally:
                run["owner"].moe_route = spy.fn
            run["s"].append(timed.prefill_s[-1])
            if rnd == 0:
                run.update(logits=logits[0, -1].float(), routes=spy.routes)
    for run in runs.values():
        run["ms"] = 1e3 * float(np.median(run["s"]))
    a, b = runs["moe_apply"], runs["EP"]
    if len(a["routes"]) != len(b["routes"]) or not a["routes"]:
        _fail(f"launch: {arch}: {len(a['routes'])} routings without EP, {len(b['routes'])} with")
    for i, (x, y) in enumerate(zip(a["routes"], b["routes"])):
        if x["C"] != y["C"] or not (torch.equal(x["keep"], y["keep"])
                                    and torch.equal(x["dest"], y["dest"])):
            _fail(f"launch: {arch} layer {i}: EP kept other slots than moe_apply "
                  f"(C {y['C']} vs {x['C']})")
    scale = float(a["logits"].abs().max())
    err = float((b["logits"] - a["logits"]).abs().max())
    if not (torch.isfinite(b["logits"]).all() and err <= LIVE_LOGITS_RTOL * scale):
        _fail(f"launch: {arch} prefill with EP: logits differ by {err:.3e} "
              f"(> {LIVE_LOGITS_RTOL} x scale {scale:.3e})")
    kept = sum(int(r["keep"].sum()) for r in a["routes"])
    choices = sum(r["keep"].numel() for r in a["routes"])
    _log(f"[launch] {arch} expert-parallel prefill (model axis of 1) of {len(tokens)} tokens: "
         f"the same kept slots in all {len(a['routes'])} layers ({kept} of {choices} choices "
         f"kept, C={a['routes'][0]['C']}); last-token logits max abs err {err:.3e} (scale "
         f"{scale:.3e}); prefill {b['ms']:.2f} ms with EP, {a['ms']:.2f} ms without (medians "
         f"of {LAUNCH_ROUNDS} each, in turns, host clock)")
    return dict(prefill_ms=b["ms"], plain_prefill_ms=a["ms"], logits_err=err,
                prefills=2 * LAUNCH_ROUNDS, cfg=cfg)


def launch_specs(device) -> int:
    """(d) ``input_specs`` of every config x SHAPES cell (decode cells
    through an uninitialised model's cache shapes): every tensor on
    ``meta``, and the card's allocated memory unchanged. Returns the
    number of tensors."""
    before = torch.cuda.memory_allocated() if device.type == "cuda" else 0
    n = 0
    for arch in list_archs():
        for shape in SHAPES.values():
            model = make_model(get_config(arch)) if shape.kind == "decode" else None
            for t in _leaves(specs.input_specs(arch, shape, model)):
                if t.device.type != "meta":
                    _fail(f"launch: input_specs({arch}, {shape.name}) gave a tensor on {t.device}")
                n += 1
    after = torch.cuda.memory_allocated() if device.type == "cuda" else 0
    if after != before:
        _fail(f"launch: input_specs allocated {after - before} bytes on the card")
    _log(f"[launch] input_specs: {n} meta tensors for {len(list_archs())} configs x "
         f"{len(SHAPES)} shapes; device memory allocated {before} -> {after} bytes")
    return n


def phase_launch(device, sizes: Sizes, seed: int) -> dict:
    """Phase 10: the launch modules through a one-rank process group and a
    (data=1, model=1) mesh: (a) flash-decoding, (b) expert-parallel MoE,
    (c) the serving CLI with --live, (d) the input specs. Returns the K3
    launches its prefills must make (``k3_want``) beside their times."""
    t0 = time.perf_counter()
    with one_rank_group(device) as backend:
        mesh_ = launch_mesh.make_mesh((1, 1), ("data", "model"), device=device)
        _log(f"[launch] one-rank {backend} group (file store), mesh {tuple(mesh_.shape)} "
             f"{tuple(mesh_.mesh_dim_names)} on {device}")
        fd = launch_flash_decode(device, sizes, seed, mesh_)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ep = launch_moe_ep(device, sizes, seed, mesh_)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        argv = ["--live", "--arch", LIVE_ARCHS[0], "--requests", str(SERVE_REQUESTS),
                "--seed", str(seed)] + (["--device", "cpu"] if device.type == "cpu" else [])
        _log(f"[launch] repro_torch.launch.serve {' '.join(argv)}:")
        if serve_launcher.main(argv) != 0:
            _fail("launch: repro_torch.launch.serve --live did not exit 0")
        n_specs = launch_specs(device)
    # the serving CLI prefills each request with the reduced model
    k3_want = (sum(attn_layers(r["cfg"]) * r["prefills"] for r in (fd, ep))
               + attn_layers(get_config(LIVE_ARCHS[0]).reduced()) * SERVE_REQUESTS)
    _log(f"[launch] phase 10 took {time.perf_counter() - t0:.1f} s (host clock)")
    return dict(flash_decode=fd, moe_ep=ep, n_specs=n_specs, k3_want=k3_want)


# -- phase 8: estimator ------------------------------------------------------

# The b-combos of Tables I and II (benchmarks/common.py B_GRID)
TABLE1_GRID = ((8, 8, 8), (8, 8, 64), (8, 64, 8), (8, 64, 64),
               (64, 8, 8), (64, 8, 64), (64, 64, 8), (64, 64, 64))
WS_RTOL = 1e-4          # card vs CPU float32 working-set solve (as phase 6)
# Dependent levels of memory accesses per step of lane_engine.cuh, read
# from the code (a level is accesses issued together, each waiting on the
# one before; the request comes from a tile one step ahead, and the J-wide
# arrays are registers): a list hit reads hold[ik], length[k], hcnt[k],
# isghost[k], prv/nxt[ik] and k's holder column at once, then only
# stores; an attach (a cache hit or a miss) adds share[hcnt[k]]; a miss
# adds lengths[k]; each eviction reads its tail victim's cells and holder
# column at once (the tail is a shuffle), then share[hcnt[v]]. The timed
# chunk's mix of steps comes from the lanes' counters, its evictions from
# their holder bits: each attach sets one, each eviction clears one.
STEP_LEVELS = {"hit": 1, "attach": 2, "miss": 1, "eviction": 2}


def _max_abs_diff(x, y) -> float:
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    if x.shape != y.shape:
        return float("inf")
    return float(np.max(np.abs(x - y))) if x.size else 0.0


def _same_sim(a, b, what: str) -> float:
    """Exact equality of two SimResults: occupancy (the integers over one
    horizon), virtual lengths, counters and the evictions histogram.
    Returns the largest difference (0.0), failing on any other."""
    ca = (a.n_hit_list, a.n_hit_cache, a.n_miss, a.n_sets_recorded, a.n_primary, a.n_ripple)
    cb = (b.n_hit_list, b.n_hit_cache, b.n_miss, b.n_sets_recorded, b.n_primary, b.n_ripple)
    pairs = (("occupancy", a.dense_occupancy(), b.dense_occupancy()),
             ("vlen", a.final_vlen, b.final_vlen),
             ("hist", a.evictions_per_set, b.evictions_per_set),
             ("hits", a.hits_by_proxy, b.hits_by_proxy),
             ("reqs", a.reqs_by_proxy, b.reqs_by_proxy),
             ("counters", ca, cb))
    err = 0.0
    for name, x, y in pairs:
        d = _max_abs_diff(x, y)
        if d != 0.0:
            _fail(f"{what}: {name} differs (max abs diff {d})")
        err = max(err, d)
    return err


def _lane_results(runner, n: int, warmup: int, sparse: bool) -> list:
    return [fastsim._assemble(out, runner.elapsed, n, warmup, runner.J, runner.N,
                              _lcm_1_to(runner.J), "cuda", sparse)
            for out in runner.finish(n)]


def _c_lanes(params_of, traces_of, R: int, N: int, warmup: int, sparse: bool) -> tuple:
    """Lane r through the host C engine (fastsim_c), one lane after another;
    returns the results and the warm drivers (for the timed chunk)."""
    out, drivers = [], []
    for r in range(R):
        params = params_of(r)
        drv, name, scale = fastsim.make_chunk_driver(
            params, N, np.ones(N, np.int64), warmup, warmup, engine="c")
        if name != "c":
            _fail("the host C engine did not build")
        tr = traces_of(r)
        drv.feed(tr.proxies, tr.objects)
        out.append(fastsim._assemble(drv.finish(len(tr)), drv.elapsed, len(tr), warmup,
                                     len(params.allocations), N, scale, "c", sparse))
        drivers.append(drv)
    return out, drivers


def _hold_lanes(device, runner, host, lanes, c_lanes, errs: Errors, what: str) -> None:
    """Every lane's whole state on the card equals the host build's, and
    its outputs equal the host C engine's; the largest difference goes
    into errs (any difference fails)."""
    err = 0.0
    if device.type == "cuda":
        for k in runner.st:
            d = float((runner.st[k].cpu().to(torch.int64) - host.st[k].to(torch.int64))
                      .abs().max())
            if d != 0.0:
                _fail(f"{what}: state {k} on the card differs from the host build (max abs "
                      f"diff {d})")
            err = max(err, d)
    for r, (x, c) in enumerate(zip(lanes, c_lanes)):
        err = max(err, _same_sim(x, c, f"{what} lane {r} vs host C"))
    errs.max["lane_engine"] = max(errs.max["lane_engine"], err)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _check_routes(device, runners: dict) -> None:
    """Print the route each runner launches on, and fail where it is not
    the one expected (on the card; the host build has no routes)."""
    for what, (run, want) in runners.items():
        _log(f"[estimator] {what}: J={run.J} N={run.N}, route {run.route}"
             + (f" ({le_module.shared_bytes(run.J, run.N, 'shared')} B on the shared route; "
                f"the card allows {le_module.shared_limit(device)} B a block)"
                if device.type == "cuda" else ""))
        if device.type == "cuda" and run.route != want:
            _fail(f"{what}: route {run.route}, not {want}")


def phase_estimator(device, sizes: Sizes, errs: Errors, seed: int) -> dict:
    """The main path of the estimator loop (see the module docstring)."""
    res = {}
    # -- Table I system: 8 b-combos x R replicas as sweep lanes ------------
    sc = get_preset("table1", seed=7 + seed)
    wl, sysm = sc.workload, sc.system
    n, R = sizes.table1_requests, sizes.table1_replicas
    trace_seed, _ = derive_seeds(sc.seed)
    t0 = time.perf_counter()
    traces = [wl.sample(n, s) for s in ensemble_seeds(trace_seed, R)]
    sample_s = time.perf_counter() - t0
    combos = np.repeat(np.asarray(TABLE1_GRID, np.int64), R, axis=0)   # lane = combo * R + rep
    L = len(combos)
    P = np.stack([traces[lane % R].proxies for lane in range(L)])
    O = np.stack([traces[lane % R].objects for lane in range(L)])
    J, N, B = len(sysm.allocations), wl.n_objects, sysm.capacity()
    warmup = fastsim.default_warmup(n, TABLE1_GRID[-1])
    params = fastsim.SimParams(allocations=TABLE1_GRID[-1], physical_capacity=B)
    _log(f"[estimator] Table I system: J={J} N={N} B={B}, Zipf {wl.alphas}, "
         f"{len(TABLE1_GRID)} b-combos x {R} replicas = {L} lanes, {n} requests per lane "
         f"(the paper: 10^7; cut for time), warmup {warmup}; traces sampled in "
         f"{sample_s:.2f} s (set-up)")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() if device.type == "cuda" else 0
    t0 = time.perf_counter()
    card = BatchedCudaRunner(params, N, np.ones(N, np.int64), warmup, warmup, _lcm_1_to(J), L,
                             b_sweep=combos, bhat_sweep=combos, device=device)
    card.feed(P, O)
    _sync(device)
    wall = time.perf_counter() - t0
    lanes = _lane_results(card, n, warmup, False)
    # the same lanes once more on the device-memory route: a check, not a
    # route of the main path, so its launches are counted apart
    card_dev = BatchedCudaRunner(params, N, np.ones(N, np.int64), warmup, warmup, _lcm_1_to(J),
                                 L, b_sweep=combos, bhat_sweep=combos, device=device,
                                 route="device")
    before = le_module.lane_engine.launches
    card_dev.feed(P, O)
    res["forced_launches"] = le_module.lane_engine.launches - before
    lanes_dev = _lane_results(card_dev, n, warmup, False)
    _check_routes(device, {"Table I": (card, "shared"),
                           "Table I, forced": (card_dev, "device")})
    host = BatchedCudaRunner(params, N, np.ones(N, np.int64), warmup, warmup, _lcm_1_to(J), L,
                             b_sweep=combos, bhat_sweep=combos, device="cpu")
    host.feed(P, O)
    c_lanes, c_drivers = _c_lanes(
        lambda r: fastsim.SimParams(allocations=tuple(int(x) for x in combos[r]),
                                    physical_capacity=B),
        lambda r: traces[r % R], L, N, warmup, False)
    _hold_lanes(device, card, host, lanes, c_lanes, errs, "Table I")
    _hold_lanes(device, card_dev, host, lanes_dev, c_lanes, errs, "Table I, device-memory route")
    c_s = sum(c.elapsed_s for c in c_lanes)
    state_mb = sum(t[0].numel() * 4 for t in card.st.values()) / 1e6
    _log(f"[estimator] Table I: {L} lanes x {n} requests in {card.elapsed:.4f} s of launches "
         f"on route {card.route} ({len(card.launch_s)} timed launches; runner wall {wall:.3f} s "
         f"with the build and module load): {n / card.elapsed:.0f} requests/s per lane, "
         f"{L * n / card.elapsed:.0f} for all lanes; route {card_dev.route} (forced) "
         f"{card_dev.elapsed:.4f} s, {n / card_dev.elapsed:.0f} requests/s per lane; host build "
         f"{host.elapsed:.3f} s; host C engine {c_lanes[0].elapsed_s:.4f}"
         f" s for lane 0 ({n / c_lanes[0].elapsed_s:.0f} requests/s), {c_s:.3f} s for the {L} "
         f"lanes one after another ({L * n / c_s:.0f} requests/s); state {state_mb:.4f} MB per "
         f"lane; every lane of both routes equals the host build state for state and the C "
         f"engine output for output")
    for b in ((64, 64, 64), (8, 8, 64)):
        r = TABLE1_GRID.index(b) * R
        hp = lanes[r].dense_occupancy()[:, [0, 9, 99, 999]]
        _log(f"[estimator] Table I b={b} lane {r}: hit probability at ranks 1/10/100/1000 "
             f"{np.round(hp, 4).tolist()}; misses {lanes[r].n_miss}, sets recorded after "
             f"warmup {lanes[r].n_sets_recorded}")
    res["table1"] = dict(card=card, card_dev=card_dev, host=host, c_drivers=c_drivers, L=L,
                         n=n, c_s=c_s, combos=combos, traces=traces, R=R)

    # -- Fig. 2 system: R replicas at the published widths -----------------
    sc2 = get_preset("fig2_ripple", seed=23 + seed)
    sc2 = sc2.scaled(requests=sizes.fig2_requests / sc2.n_requests, catalogue=sizes.fig2_catalogue)
    wl2, sys2 = sc2.workload, sc2.system
    n2, R2, N2 = sc2.n_requests, sizes.fig2_replicas, wl2.n_objects
    J2, B2 = len(sys2.allocations), sys2.capacity()
    warm2 = sc2.warmup
    trace_seed2, _ = derive_seeds(sc2.seed)
    t0 = time.perf_counter()
    traces2 = [wl2.sample(n2, s) for s in ensemble_seeds(trace_seed2, R2)]
    sample_s = time.perf_counter() - t0
    p2 = sys2.to_sim_params()
    _log(f"[estimator] Fig. 2 system: J={J2} N={N2} B={B2}, allocations {sys2.allocations}, "
         f"Zipf {wl2.alphas[0]}..{wl2.alphas[-1]}, {R2} replicas, {n2} requests per lane (the "
         f"paper: 3 x 10^6; cut for time), warmup {warm2}; traces sampled in {sample_s:.2f} s")
    P2 = np.stack([t.proxies for t in traces2])
    O2 = np.stack([t.objects for t in traces2])
    card2 = BatchedCudaRunner(p2, N2, np.ones(N2, np.int64), warm2, warm2, _lcm_1_to(J2), R2,
                              device=device)
    _check_routes(device, {"Fig. 2": (card2, "device")})
    card2.feed(P2, O2)
    lanes2 = _lane_results(card2, n2, warm2, True)
    mem = (torch.cuda.max_memory_allocated() - mem0) / 1e9 if device.type == "cuda" else 0.0
    state2 = sum(t[0].numel() * 4 for t in card2.st.values())
    host2 = BatchedCudaRunner(p2, N2, np.ones(N2, np.int64), warm2, warm2, _lcm_1_to(J2), R2,
                              device="cpu")
    host2.feed(P2, O2)
    c2, _ = _c_lanes(lambda r: p2, lambda r: traces2[r], R2, N2, warm2, True)
    _hold_lanes(device, card2, host2, lanes2, c2, errs, "Fig. 2")
    del host2
    c2_s = sum(c.elapsed_s for c in c2)
    agg = np.zeros(8, np.int64)
    for x in lanes2:
        h = x.evictions_per_set[:8]
        agg[: len(h)] += h
    _log(f"[estimator] Fig. 2: {R2} lanes x {n2} requests in {card2.elapsed:.4f} s of launches "
         f"on route {card2.route}: "
         f"{n2 / card2.elapsed:.0f} requests/s per lane, {R2 * n2 / card2.elapsed:.0f} for all "
         f"lanes; host C engine {c2[0].elapsed_s:.4f} s for lane 0, {c2_s:.3f} s for the {R2} "
         f"lanes one after another ({R2 * n2 / c2_s:.0f} requests/s); state "
         f"{state2 / 1e6:.1f} MB per lane, {R2 * state2 / 1e9:.3f} GB for all (peak allocated "
         f"since the phase began {mem:.3f} GB); evictions per set, all lanes, 0..7: "
         f"{agg.tolist()}; every lane equals the host build and the C engine")
    res["fig2"] = dict(n=n2, R=R2, elapsed=card2.elapsed, c_s=c2_s)
    del card2

    # -- the Scenario path: Table I preset, 4 replicas, default backend vs c -
    scs = get_preset("table1", b=(64, 64, 8), seed=7 + seed).scaled(
        requests=sizes.scenario_requests / sc.n_requests)
    on = dataclasses.replace(scs, estimator=dataclasses.replace(scs.estimator, replications=4))
    if on.system.backend != "auto":
        _fail(f"scenario: the preset's backend is {on.system.backend!r}, not the default")
    off = dataclasses.replace(on, system=dataclasses.replace(on.system, backend="c"))
    _sync(device)
    t0 = time.perf_counter()
    rep = on.run(device=device)
    _sync(device)
    wall_on = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep_c = off.run()
    wall_off = time.perf_counter() - t0
    if not (rep.same_estimates(rep_c) and rep_c.same_estimates(rep)):
        _fail("scenario: the default backend's estimates differ from the c Report's")
    if rep.backend != "cuda" or not rep.ensemble["batched"]:
        _fail(f"scenario: ran on {rep.backend}, batched={rep.ensemble['batched']}")
    if not (np.all(np.isfinite(rep.hit_rate)) and rep.dense_hit_prob().shape == (3, N)):
        _fail("scenario: hit rates not finite or hit_prob of the wrong shape")
    route = (le_module.pick_route(J, N, le_module.shared_limit(device))
             if device.type == "cuda" else "host build")
    _log(f"[estimator] Scenario table1 b=(64, 64, 8), {scs.n_requests} requests x 4 replicas: "
         f"backend auto (ran {rep.backend}, route {route}) {wall_on:.3f} s wall (Report elapsed "
         f"{rep.elapsed_s:.4f} s, {rep.throughput_rps:.0f} requests/s), backend c {wall_off:.3f} s wall (elapsed "
         f"{rep_c.elapsed_s:.4f} s); same_estimates both ways; overall hit rate "
         f"{rep.overall_hit_rate:.6f}, per proxy {np.round(rep.hit_rate, 6).tolist()}")
    res["scenario"] = dict(sc=on, wall=wall_on, wall_c=wall_off, report=rep)

    # -- Table II: the working-set solve of the 8 combos, batched ----------
    ws = get_preset("table2_ws")
    lam = _rates_for(ws)
    _, length_seed = derive_seeds(ws.seed)
    lengths = ws.workload.object_lengths(length_seed).astype(np.float64)
    grid = np.asarray(TABLE1_GRID, np.float64)
    _sync(device)
    t0 = time.perf_counter()
    sols = solve_workingset_batch(lam, lengths, grid, "L1", device=device)
    ws_s = time.perf_counter() - t0
    cpu = solve_workingset_batch(lam, lengths, grid, "L1", device="cpu")
    rel = max(float(np.max(np.abs(a.t - b.t) / b.t)) for a, b in zip(sols, cpu))
    if not (rel <= WS_RTOL and all(s.converged for s in sols)):
        _fail(f"table2_ws: card vs CPU rel err t {rel:.2e} > {WS_RTOL} or not converged")
    _log(f"[estimator] Table II working set (L1), 8 combos batched on {device}: {ws_s:.3f} s; "
         f"card vs CPU float32 rel err t {rel:.2e}; outer steps per combo "
         f"{[s.iterations for s in sols]} (CPU {[s.iterations for s in cpu]}); b=(64,64,64) "
         f"h at ranks 1/10/100/1000 {np.round(sols[-1].h[:, [0, 9, 99, 999]], 4).tolist()}")
    return res


def profile_scenario(device, est: dict) -> dict:
    """The Scenario path once more under torch.profiler: the card's busy
    share of its wall time."""
    sc = est["scenario"]["sc"]
    r = _device_profile(lambda: sc.run(device=device), device)
    if r["busy_ms"] is None:
        _log(f"[estimator] profile Scenario.run: {r['wall_ms']:.2f} ms (host clock); device "
             f"time not measured (the profiler saw no device activity)")
        return r
    top = "; ".join(f"{k[:50]} x{n} {ms:.3f} ms" for k, ms, n in r["top"])
    _log(f"[estimator] profile Scenario.run: {r['wall_ms']:.2f} ms (host clock), card busy "
         f"{r['busy_ms']:.2f} ms, idle share {1 - r['busy_ms'] / r['wall_ms']:.3f}; largest: {top}")
    return r


def chunk_mix(before: dict, after: dict) -> dict:
    """The steps of the requests between two states of a runner, all lanes
    together: the shares of list hits, cache-hit attaches and misses (the
    lanes' counters), evictions a request (each attach sets one holder bit
    and each eviction clears one, so evictions = attaches - the change in
    set bits) and the dependent levels of memory accesses a request that
    this mix implies (STEP_LEVELS). ``before`` and ``after`` map the
    scalar names and "hold" to sums over the lanes."""
    d = {k: after[k] - before[k] for k in after}
    steps = d["n_hit_list"] + d["n_hit_cache"] + d["n_miss"]
    attaches = d["n_hit_cache"] + d["n_miss"]
    ev = attaches - d["hold"]
    lv = STEP_LEVELS
    levels = (lv["hit"] * d["n_hit_list"] + lv["attach"] * attaches + lv["miss"] * d["n_miss"]
              + lv["eviction"] * ev)
    return {"steps": steps, "list_hits": d["n_hit_list"] / steps,
            "attaches": d["n_hit_cache"] / steps, "misses": d["n_miss"] / steps,
            "evictions": ev / steps, "set_evictions": (d["n_prim"] + d["n_rip"]) / steps,
            "levels": levels / steps}


def lane_sums(runner) -> dict:
    """The lanes' scalars and set holder bits, summed over the lanes."""
    out = dict(zip(SCALARS, runner.st["sc"].to(torch.int64).sum(0).cpu().tolist()))
    out["hold"] = int(runner.st["hold"].to(torch.int64).sum())
    return out


def _launch_ms(runner, Pd, Od) -> float:
    """One launch of a runner's lanes over a chunk on the card (CUDA events)."""
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    runner._launch(Pd, Od)
    b.record()
    b.synchronize()
    runner.idx += Pd.shape[1]
    return a.elapsed_time(b)


def time_lane_engine(device, sizes: Sizes, est: dict) -> dict:
    """One chunk of sizes.est_chunk requests on each of the 32 warm Table I
    lanes: the kernel on the shared-memory route and on the device-memory
    route (CUDA events, median of 5 chunks after one), its host build, and
    the host C engine on the same lanes one after another; then every lane
    of both routes equals the host build, state for state. The bound counts
    the chunk's requests, the lanes' state read once and written once, and
    the constants."""
    t1 = est["table1"]
    card, card_dev, host = t1["card"], t1["card_dev"], t1["host"]
    drivers, L, R = t1["c_drivers"], t1["L"], t1["R"]
    m = sizes.est_chunk
    rng = np.random.default_rng(12345)
    lam = irm.rate_matrix(card.N, (0.75, 0.5, 1.0))
    chunks = [irm.sample_trace(lam, m, seed=int(rng.integers(2**31))) for _ in range(6 * R)]
    times, times_dev, plain, c_ms = [], [], [], []
    before = lane_sums(card)
    for i in range(6):
        tr = chunks[i * R:(i + 1) * R]
        P = np.stack([tr[lane % R].proxies for lane in range(L)]).astype(np.int32)
        O = np.stack([tr[lane % R].objects for lane in range(L)]).astype(np.int32)
        Pd, Od = torch.from_numpy(P).to(device), torch.from_numpy(O).to(device)
        times.append(_launch_ms(card, Pd, Od))
        times_dev.append(_launch_ms(card_dev, Pd, Od))
        t0 = time.perf_counter()
        host._run(P, O)
        plain.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for lane, drv in enumerate(drivers):
            drv.feed(P[lane], O[lane].astype(np.int64))
        c_ms.append(1e3 * (time.perf_counter() - t0))
    for run in (card, card_dev):
        for k in run.st:
            if not torch.equal(run.st[k].cpu(), host.st[k]):
                _fail(f"timed chunks, route {run.route}: state {k} differs from the host build")
    ms, ms_dev, plain_ms, c_med = (float(np.median(x[1:])) for x in (times, times_dev, plain,
                                                                       c_ms))
    mix = chunk_mix(before, lane_sums(card))
    state = sum(t.numel() * 4 for t in card.st.values())
    n_bytes = 2 * state + 2 * L * m * 4 + card.lengths.numel() * 4 + card.share.numel() * 4
    r = dict(ms=ms, plain_ms=plain_ms, library_ms=c_med,
             shape=f"{L} lanes x {m} requests",
             library="host C engine (fastsim_c), the lanes one after another")
    r["bound_ms"], r["bound_by"] = n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    _log(f"[timing] lane_engine ({r['shape']}, Table I system): kernel route {card.route} "
         f"{ms:.4f} ms per chunk, route {card_dev.route} {ms_dev:.4f} ms (median of 5 after "
         f"one), {L * m / ms * 1e3:.0f} requests/s for all lanes, {m / ms * 1e3:.0f} per lane "
         f"(route {card_dev.route} {m / ms_dev * 1e3:.0f}); host build {plain_ms:.4f} ms; host C "
         f"engine {c_med:.4f} ms; bound {r['bound_ms']:.6f} ms (bytes: {n_bytes / 1e6:.3f} MB); "
         f"{ms * 1e6 / m:.1f} ns per request per lane; steps: list hits "
         f"{mix['list_hits']:.4f}, cache-hit attaches {mix['attaches']:.4f}, misses "
         f"{mix['misses']:.4f}; evictions {mix['evictions']:.4f} a request (from the holder "
         f"bits; a miss's set alone {mix['set_evictions']:.4f}); {mix['levels']:.4f} dependent "
         f"levels of memory accesses a request (STEP_LEVELS {STEP_LEVELS}), "
         f"{ms * 1e6 / m / mix['levels']:.1f} ns a level; {min(L, sms)} of {sms} SMs hold a lane; "
         f"both routes equal the host build after the timed chunks")
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False     # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    sizes = Sizes()
    errs = Errors()

    card = phase_env()
    launch_plans(sizes)
    phase_kernels(device, sizes, errs, args.seed)
    reset_launches()                                  # the main path starts here
    served = phase_serving(device, sizes, errs, args.seed)
    served_launches = launches()
    grouped = phase_grouped(device, sizes, served, errs, args.seed)
    main_launches = launches()                        # ... and ends here
    _log(f"[serving] launches: {served_launches}")
    _log(f"[grouped] launches: { {k: main_launches[k] - served_launches[k] for k in KERNELS} }")
    if served_launches["paged_attention"] == 0 or (
            main_launches["shared_prefix_attention"] == 0):
        _fail(f"a kernel of the serving path was not launched: {main_launches}")
    models = phase_live_models(device, sizes, args.seed, card,
                               LIVE_ARCHS + MORE_ARCHS)           # the live paths
    for m in models:
        got = m["launches"]["flash_attention"]
        if got != m["k3_want"]:
            _fail(f"live: {m['name']}: K3 launched {got} times, not {m['k3_per_request']} "
                  f"global-attention layers x {m['k3_want'] // max(m['k3_per_request'], 1)} "
                  f"prefills or forwards = {m['k3_want']}")
    live_k3 = sum(m["launches"]["flash_attention"] for m in models)
    _log(f"[live] K3 launches: {live_k3} ("
         f"{', '.join(str(m['launches']['flash_attention']) + ' ' + m['name'] for m in models)})")
    phase_admission(device, sizes)
    timing = phase_timing(device, sizes, served, grouped, args.seed, models)
    for m in models:
        if m["k3_per_request"]:
            k3_ms = timing["k3_by_model"][m["name"]]
            _log(f"[live] {m['name']} K3 share of {'forward' if m['decode_ms'] is None else 'prefill'}"
                 f": {m['k3_per_request']} x {k3_ms:.4f} ms / {m['prefill_ms']:.2f} ms = "
                 f"{m['k3_per_request'] * k3_ms / m['prefill_ms']:.4f}")
    reset_launches()                                  # the estimator path starts here
    t_est = time.perf_counter()
    est = phase_estimator(device, sizes, errs, args.seed)
    est_launches = launches()                         # ... and ends here
    est_launches["lane_engine"] -= est["forced_launches"]
    _log(f"[estimator] launches: {est_launches}; and {est['forced_launches']} of the lane "
         f"engine on the forced device-memory route (a check, not counted)")
    if est_launches["lane_engine"] == 0:
        _fail(f"the estimator path did not launch the lane engine: {est_launches}")
    profile_scenario(device, est)
    timing["lane_engine"] = time_lane_engine(device, sizes, est)
    _log(f"[estimator] phase 8 took {time.perf_counter() - t_est:.1f} s (host clock, its "
         f"checks, profile and timing included)")
    train = phase_train(device, sizes, errs, args.seed, card)     # the training path
    timing["flash_attention_bwd"] = train["timing"]
    train_launches = {k: train["run"]["launches"][k] + train["mesh"]["launches"][k]
                      for k in ("flash_attention", "flash_attention_bwd")}
    train_k3 = train_launches["flash_attention"]
    _log(f"[train] K3 launches: {live_k3} on the live path, {train_k3} on the training paths "
         f"({train['run']['launches']['flash_attention']} in the run, "
         f"{train['mesh']['launches']['flash_attention']} in (e)-(g)); K3-bwd "
         f"{train_launches['flash_attention_bwd']}")
    reset_launches()                                  # the launch path starts here
    launch = phase_launch(device, sizes, args.seed)
    launch_k3 = launches()["flash_attention"]         # ... and ends here
    if launch_k3 != launch["k3_want"]:
        _fail(f"launch: K3 launched {launch_k3} times, not the {launch['k3_want']} its "
              f"prefills make")
    _log(f"[launch] K3 launches: {launch_k3} on the launch path")
    path_launches = dict(main_launches, flash_attention=live_k3 + train_k3 + launch_k3,
                         flash_attention_bwd=train_launches["flash_attention_bwd"],
                         lane_engine=est_launches["lane_engine"])

    rows = []
    for name, k in KERNELS.items():
        t = timing[name]
        rows.append({
            "name": name, "route": "cuda", "source": k["source"], "replaces": k["replaces"],
            "launches": path_launches[name], "max_abs_err": errs.max[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
        if name in ("lane_engine", "flash_attention_bwd"):   # what the yardstick is
            rows[-1]["library"] = t["library"]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
