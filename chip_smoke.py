#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port's serving paths and its estimator loop
once on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught to carry on):

1. env       card name and power limit, torch/CUDA versions, the build
             of every kernel under src/repro_torch/kernels/csrc with nvcc
             (one nvcc per source, all started together: K1, K2, K3 and
             the lane engine), each kernel's
             ptxas report (registers, spills) and the launch K1, K2 and K3
             get at this run's shapes (cluster size, stages, shared memory);
2. kernels   each CUDA kernel against its plain PyTorch version on the card,
             over the shape grids of tests/test_kernels.py and the port's
             tests in f32 and bf16 and at this run's own shapes, K2 also at
             a 4096-token prefix with lengths from 0 to S;
3. serving   the engine at the full qwen3-1.7b KV geometry admits three
             tenants over a 16384-block pool and takes 1024 requests; pages
             are written once when allocated, and every 64 requests the
             resident ones decode one token through paged attention (K1);
4. grouped   8 prefix groups of 16 resident requests decode through
             shared-prefix attention (K2) + suffix attention + LSE merge,
             held to the plain version and to K1 over each full table;
5. live      the engine in live mode with qwen3-1.7b at full width and
             depth (bf16 weights from --seed) serves 8 requests of 1280
             tokens, 16 new tokens each: each prompt is prefilled with its
             attention in flash attention (K3), then decoded greedily on
             dense caches; the first prefill is held to the same prefill
             with K3's plain version;
6. admission the working-set virtual allocations on the card against the
             port's own CPU solve;
7. timing    each kernel, its plain version and a PyTorch yardstick at the
             main path's shapes (CUDA events, L2 flushed between launches),
             K1 first at a small batch with a long context (B=4, ctx=4096),
             and also back to back in a CUDA graph and host-inclusive (the
             host clock around a call and a synchronize), K2 first at a
             long prefix with a small group;
8. estimator the paper's estimator loop at its published widths on the
             lane engine (one CUDA thread per lane): the Table I system
             (J=3, N=1000, B=1000, Zipf 0.75/0.5/1.0), its 8 b-combos x 4
             replicas as 32 sweep lanes of one batched runner, and the
             Fig. 2 system (J=9, N=1e6, 3x1000+3x2000+3x7000 units, Zipf
             0.5..4.5), 16 replicas (about 3.2 GB of state); every lane
             held exactly to the kernel's host build and to the host C
             engine; Scenario.run() of the Table I preset with 4
             replicas on its default backend ("auto", which runs the lane
             engine on the card) against backend="c" (same_estimates);
             the Table II working-set solve of the 8 combos batched on
             the card against the CPU; then the lane engine timed per
             chunk beside its host build, the host C engine and its byte
             bound, with the timed chunk's mix of steps read from the
             lanes' counters. Request counts per lane are cut from the
             paper's (printed); widths never are.

The line before the last lists each kernel as JSON (launches on its path:
K1 and K2 in phases 3-4, K3 in phase 5, the lane engine in phase 8; max
error; times; bound); the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.cacheblocks import layout_for  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
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
    flash_attention_plain,
)
from repro_torch.kernels.lane_engine import SCALARS, lane_engine  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_attention,
    paged_attention_plain,
)
from repro_torch.kernels.shared_prefix_attention import (  # noqa: E402
    shared_prefix_attention,
    shared_prefix_attention_plain,
)
from repro_torch.models import make_model  # noqa: E402
from repro_torch.scenario import get_preset  # noqa: E402
from repro_torch.scenario.runner import _rates_for, derive_seeds, ensemble_seeds  # noqa: E402
from repro_torch.serving import EngineConfig, ServingEngine, TenantSpec  # noqa: E402

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
    live_requests: int = 8          # phase 5: requests served by the model ...
    live_prompts: int = 2           # ... shared prompts of tenants A, B ...
    new_tokens: int = 16            # ... and tokens decoded for each
    # phase 8: requests per lane (the paper: 10^7 for Table I, 3 x 10^6
    # for Fig. 2) and lanes; the catalogue is cut only in CPU rehearsals
    table1_requests: int = 4_000_000
    table1_replicas: int = 4        # x 8 b-combos = 32 sweep lanes
    fig2_requests: int = 1_200_000
    fig2_replicas: int = 16
    fig2_catalogue: float = 1.0     # 1.0 = the published N = 10^6
    scenario_requests: int = 1_000_000
    est_chunk: int = 1 << 16        # requests per lane in a timed chunk

    def arch_config(self):
        cfg = get_config(self.arch)
        return cfg.reduced() if self.reduced else cfg


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
    long-prefix timing shapes, and of K3 at the model's head size."""
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
    for dtype in (torch.bfloat16, torch.float32):
        _log(f"[env] launch K3 {str(dtype)[6:]} D={D}: {k3_module.launch_plan(D, dtype)}")


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
K3_GRID = [  # B, T, S, H, KV, D, causal (tests/test_kernels.py, then causal T < S)
    (2, 128, 128, 4, 2, 64, True), (1, 256, 256, 8, 8, 128, True),
    (2, 100, 100, 4, 1, 64, False), (1, 64, 192, 4, 4, 64, False),
    (1, 128, 128, 4, 4, 256, True), (1, 64, 192, 4, 2, 64, True),
    (1, 200, 200, 8, 2, 128, True),
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
    T = sizes.prefix_tokens + sizes.user_tokens
    k3 = K3_GRID + [(1, T, T, H, KV, D, True)]    # the live phase's prefill
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
        for B, T_, S, H_, KV_, D_, causal in k3:
            q = _randn(gen, (B, T_, H_, D_), dtype, device)
            k = _randn(gen, (B, S, KV_, D_), dtype, device)
            v = _randn(gen, (B, S, KV_, D_), dtype, device)
            err = errs.check("flash_attention", flash_attention(q, k, v, causal=causal),
                             flash_attention_plain(q, k, v, causal=causal), ATOL[dtype],
                             f"K3 {dtype} B={B} T={T_} S={S} H={H_} KV={KV_} D={D_} causal={causal}")
            _log(f"[kernels] K3 {str(dtype)[6:]:8s} B={B} T={T_:4d} S={S:4d} H={H_:2d} KV={KV_} "
                 f"D={D_:3d} causal={int(causal)}: max abs err {err:.3e}")
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


def phase_live(device, sizes: Sizes, seed: int) -> dict:
    cfg = sizes.arch_config()
    model = make_model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    if device.type == "cuda":
        torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    _log(f"[live] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, H={cfg.n_heads} "
         f"KV={cfg.n_kv_heads} D={cfg.head_dim}, vocab {cfg.vocab_size}: {n_params / 1e9:.3f} B "
         f"bf16 parameters ({2 * n_params / 1e9:.2f} GB) drawn on {device} from seed {seed} in "
         f"{time.perf_counter() - t0:.2f} s (set-up)")
    layout = layout_for(cfg, block_tokens=sizes.block_tokens)
    pool_bytes = sizes.pool_blocks * layout.bytes_per_block
    timed = TimedModel(model, device)
    engine = ServingEngine(
        cfg,
        [TenantSpec("tenantA", 0.35 * pool_bytes), TenantSpec("tenantB", 0.35 * pool_bytes),
         TenantSpec("tenantC", 0.20 * pool_bytes)],
        EngineConfig(block_tokens=sizes.block_tokens, pool_blocks=sizes.pool_blocks),
        model=timed, params=params, device=device,
    )
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(0, cfg.vocab_size, sizes.prefix_tokens)
               for _ in range(sizes.live_prompts)]
    results, requests = [], []
    t0 = time.perf_counter()
    for i in range(sizes.live_requests):
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
    _log(f"[live] {sizes.live_requests} requests in {wall:.2f} s (host clock): prefill "
         f"{1e3 * np.median(timed.prefill_s[1:]):.2f} ms per request (median of requests "
         f"1-{sizes.live_requests - 1}; the first took {1e3 * timed.prefill_s[0]:.2f} ms), decode "
         f"{1e3 * np.median(timed.decode_s):.2f} ms per token (median of {len(timed.decode_s)} "
         f"steps); prefix-hit token ratio {st['prefix_hit_token_ratio']:.4f}, sharing ratio "
         f"{st['sharing_ratio']:.4f}")
    return dict(cfg=cfg, model=model, params=params, timed=timed, results=results,
                requests=requests)


def check_live_against_plain(live: dict, sizes: Sizes) -> float:
    """The first request's prefill again, with K3's plain version: the
    last-token logits within LIVE_LOGITS_RTOL of their scale and the same
    first greedy token."""
    tokens = live["requests"][0]
    dev = live["params"]["embed"].device
    batch = {"tokens": torch.as_tensor(tokens[None, :], device=dev)}
    with torch.inference_mode(), plain_prefill_attention():
        want, _ = live["model"].prefill(live["params"], batch, len(tokens) + sizes.new_tokens)
    got, want = live["timed"].first_logits, want.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and err <= LIVE_LOGITS_RTOL * scale):
        _fail(f"live: K3 prefill logits differ from the plain prefill by {err:.3e} "
              f"(> {LIVE_LOGITS_RTOL} x scale {scale:.3e})")
    first = int(live["results"][0].output[0, 0])
    top2 = torch.topk(want[0, -1], 2).values
    if first != int(torch.argmax(want[0, -1])):
        _fail(f"live: first greedy token {first} != plain prefill's "
              f"{int(torch.argmax(want[0, -1]))}")
    _log(f"[live] first prefill, K3 vs plain attention: last-token logits max abs err "
         f"{err:.3e} (scale {scale:.3e}, limit {LIVE_LOGITS_RTOL * scale:.3e}); first greedy "
         f"token {first} in both (plain top-2 margin {float(top2[0] - top2[1]):.3e})")
    return err


def _device_profile(fn, device) -> dict:
    """Host-clock ms of ``fn()`` under torch.profiler, the card's busy ms
    (the sum of kernel and copy times; one stream, so they do not
    overlap) and the largest device consumers. Device figures are None
    where the profiler saw no device activity."""
    from torch.autograd import DeviceType
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
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    rows.sort(key=lambda r: -r[1])
    return dict(wall_ms=wall, busy_ms=busy if rows else None, top=rows[:6])


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
            r = out[name] = _device_profile(fn, dev)
            if r["busy_ms"] is None:
                _log(f"[live] profile {name}: {r['wall_ms']:.2f} ms (host clock); device time "
                     f"not measured (the profiler saw no device activity)")
                continue
            top = "; ".join(f"{k[:60]} x{n} {ms:.3f} ms" for k, ms, n in r["top"])
            _log(f"[live] profile {name}: {r['wall_ms']:.2f} ms (host clock), card busy "
                 f"{r['busy_ms']:.2f} ms, idle share {1 - r['busy_ms'] / r['wall_ms']:.3f}; "
                 f"largest: {top}")
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


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

def median_ms(fn, flush: torch.Tensor, n: int = 30, warmup: int = 5) -> float:
    """Median of n launches, each timed with CUDA events, the L2 cache
    flushed before each by a 256 MiB write (which leaves the cache full of
    dirty lines that the launch pays to write back as it evicts them)."""
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
    return float(np.median(times))


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
    extra = (f" (back to back {r['graph_ms']:.4f} ms, host-inclusive {r['host_ms']:.4f} ms)"
             if "graph_ms" in r else "")
    _log(f"[timing] {name} ({r['shape']}): kernel {r['ms']:.4f} ms{extra}, plain "
         f"{r['plain_ms']:.4f} ms, library {lib}, bound {r['bound_ms']:.4f} ms "
         f"({r['bound_by']}){seq}")


def phase_timing(device, sizes: Sizes, served: dict, grouped: dict, seed: int) -> Dict[str, dict]:
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
    # K3 at the live phase's prefill: one prompt of T tokens, causal
    B, T = 1, sizes.prefix_tokens + sizes.user_tokens
    gen = torch.Generator(device=device).manual_seed(seed + 4)
    q3 = _randn(gen, (B, T, H, D), torch.bfloat16, device)
    k3, v3 = (_randn(gen, (B, T, KV, D), torch.bfloat16, device) for _ in range(2))
    k3_bytes = 2 * (q3.numel() + k3.numel() + v3.numel() + q3.numel())
    k3_flops = 4.0 * B * H * D * T * (T + 1) / 2         # the (t, s <= t) pairs only
    # yardstick: one SDPA call, layouts permuted beforehand (not timed)
    qs, ks, vs = (x.permute(0, 2, 1, 3).contiguous() for x in (q3, k3, v3))
    res["flash_attention"] = dict(
        ms=median_ms(lambda: flash_attention(q3, k3, v3, causal=True), flush),
        plain_ms=median_ms(lambda: flash_attention_plain(q3, k3, v3, causal=True), flush),
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), flush),
        shape=f"B={B} T=S={T} H={H} KV={KV} D={D} causal",
    )
    res["flash_attention"]["bound_ms"], res["flash_attention"]["bound_by"] = bound_ms(
        k3_bytes, k3_flops, q3.dtype)
    for name, r in res.items():
        _log_timing(name, r)
    return res


# -- phase 8: estimator ------------------------------------------------------

# The b-combos of Tables I and II (benchmarks/common.py B_GRID)
TABLE1_GRID = ((8, 8, 8), (8, 8, 64), (8, 64, 8), (8, 64, 64),
               (64, 8, 8), (64, 8, 64), (64, 64, 8), (64, 64, 64))
WS_RTOL = 1e-4          # card vs CPU float32 working-set solve (as phase 6)
# Loads on a list-hit step of lane_engine.cuh, read from the code: O[off],
# hold[ik], head[i], prv[ik] and nxt[ik], head[i] again after the unlink's
# stores. A cache-hit attach or a miss adds the eviction loop's loads per
# victim (tail, nxt, res_since, hcnt, the holder column); the timed
# chunk's mix of steps is read from the lanes' counters.
HIT_STEP_LOADS = 5


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
    host = BatchedCudaRunner(params, N, np.ones(N, np.int64), warmup, warmup, _lcm_1_to(J), L,
                             b_sweep=combos, bhat_sweep=combos, device="cpu")
    host.feed(P, O)
    c_lanes, c_drivers = _c_lanes(
        lambda r: fastsim.SimParams(allocations=tuple(int(x) for x in combos[r]),
                                    physical_capacity=B),
        lambda r: traces[r % R], L, N, warmup, False)
    _hold_lanes(device, card, host, lanes, c_lanes, errs, "Table I")
    c_s = sum(c.elapsed_s for c in c_lanes)
    state_mb = sum(t[0].numel() * 4 for t in card.st.values()) / 1e6
    _log(f"[estimator] Table I: {L} lanes x {n} requests in {card.elapsed:.4f} s of launches "
         f"({len(card.launch_s)} timed launches; runner wall {wall:.3f} s with the build and "
         f"module load): {n / card.elapsed:.0f} requests/s per lane, {L * n / card.elapsed:.0f} "
         f"for all lanes; host build {host.elapsed:.3f} s; host C engine {c_lanes[0].elapsed_s:.4f}"
         f" s for lane 0 ({n / c_lanes[0].elapsed_s:.0f} requests/s), {c_s:.3f} s for the {L} "
         f"lanes one after another ({L * n / c_s:.0f} requests/s); state {state_mb:.4f} MB per "
         f"lane; every lane's state equals the host build's and its outputs the C engine's")
    for b in ((64, 64, 64), (8, 8, 64)):
        r = TABLE1_GRID.index(b) * R
        hp = lanes[r].dense_occupancy()[:, [0, 9, 99, 999]]
        _log(f"[estimator] Table I b={b} lane {r}: hit probability at ranks 1/10/100/1000 "
             f"{np.round(hp, 4).tolist()}; misses {lanes[r].n_miss}, sets recorded after "
             f"warmup {lanes[r].n_sets_recorded}")
    res["table1"] = dict(card=card, host=host, c_drivers=c_drivers, L=L, n=n, c_s=c_s,
                         combos=combos, traces=traces, R=R)

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
    _log(f"[estimator] Fig. 2: {R2} lanes x {n2} requests in {card2.elapsed:.4f} s of launches: "
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
    _log(f"[estimator] Scenario table1 b=(64, 64, 8), {scs.n_requests} requests x 4 replicas: "
         f"backend auto (ran {rep.backend}) {wall_on:.3f} s wall (Report elapsed "
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


def time_lane_engine(device, sizes: Sizes, est: dict) -> dict:
    """One chunk of sizes.est_chunk requests on each of the 32 warm Table I
    lanes: the kernel (CUDA events, median of 5 chunks), its host build,
    and the host C engine on the same lanes one after another. The bound
    counts the chunk's requests, the lanes' state read once and written
    once, and the constants."""
    t1 = est["table1"]
    card, host, drivers, L, R = t1["card"], t1["host"], t1["c_drivers"], t1["L"], t1["R"]
    m = sizes.est_chunk
    rng = np.random.default_rng(12345)
    lam = irm.rate_matrix(card.N, (0.75, 0.5, 1.0))
    chunks = [irm.sample_trace(lam, m, seed=int(rng.integers(2**31))) for _ in range(6 * R)]
    times, plain, c_ms = [], [], []
    sc0 = card.st["sc"].to(torch.int64).sum(0).cpu()
    for i in range(6):
        tr = chunks[i * R:(i + 1) * R]
        P = np.stack([tr[lane % R].proxies for lane in range(L)]).astype(np.int32)
        O = np.stack([tr[lane % R].objects for lane in range(L)]).astype(np.int32)
        Pd, Od = torch.from_numpy(P).to(device), torch.from_numpy(O).to(device)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        card._launch(Pd, Od)
        b.record()
        b.synchronize()
        card.idx += m
        times.append(a.elapsed_time(b))
        t0 = time.perf_counter()
        host._run(P, O)
        plain.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for lane, drv in enumerate(drivers):
            drv.feed(P[lane], O[lane].astype(np.int64))
        c_ms.append(1e3 * (time.perf_counter() - t0))
    ms, plain_ms, c_med = (float(np.median(x[1:])) for x in (times, plain, c_ms))
    # the chunks' mix of steps, from the counters of all lanes
    d = dict(zip(SCALARS, (card.st["sc"].to(torch.int64).sum(0).cpu() - sc0).tolist()))
    steps = d["n_hit_list"] + d["n_hit_cache"] + d["n_miss"]
    mix = {k: d[k] / steps for k in ("n_hit_list", "n_hit_cache", "n_miss")}
    set_evict_per_req = (d["n_prim"] + d["n_rip"]) / steps     # a miss's set only
    state = sum(t.numel() * 4 for t in card.st.values())
    n_bytes = 2 * state + 2 * L * m * 4 + card.lengths.numel() * 4 + card.share.numel() * 4
    r = dict(ms=ms, plain_ms=plain_ms, library_ms=c_med, shape=f"{L} lanes x {m} requests",
             library="host C engine (fastsim_c), the lanes one after another")
    r["bound_ms"], r["bound_by"] = n_bytes / HBM_BYTES_PER_S * 1e3, "bytes"
    per_req_ns = ms * 1e6 / m
    _log(f"[timing] lane_engine ({r['shape']}, Table I system): kernel {ms:.4f} ms per chunk "
         f"(median of 5 after one), {L * m / ms * 1e3:.0f} requests/s for all lanes, "
         f"{m / ms * 1e3:.0f} per lane; host build {plain_ms:.4f} ms; host C engine "
         f"{c_med:.4f} ms; bound {r['bound_ms']:.6f} ms (bytes: {n_bytes / 1e6:.3f} MB); "
         f"{per_req_ns:.1f} ns per request per lane; steps: list hits {mix['n_hit_list']:.4f}, "
         f"cache-hit attaches {mix['n_hit_cache']:.4f}, misses {mix['n_miss']:.4f}; evictions "
         f"of a miss's set {set_evict_per_req:.4f} a request (an attach's are not counted); a "
         f"list hit is {HIT_STEP_LOADS} loads, read from the code; the other steps add the "
         f"eviction loop's; "
         f"{min(L, torch.cuda.get_device_properties(device).multi_processor_count)} of "
         f"{torch.cuda.get_device_properties(device).multi_processor_count} SMs hold a lane")
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
    reset_launches()                                  # the live path starts here
    live = phase_live(device, sizes, args.seed)
    live_launches = launches()                        # ... and ends here
    _log(f"[live] launches: {live_launches}")
    want = live["cfg"].n_layers * sizes.live_requests
    if live_launches["flash_attention"] != want:
        _fail(f"live: K3 launched {live_launches['flash_attention']} times, not "
              f"{live['cfg'].n_layers} layers x {sizes.live_requests} prefills = {want}")
    check_live_against_plain(live, sizes)
    profile_live(live, sizes)
    prefill_ms = 1e3 * float(np.median(live["timed"].prefill_s[1:]))
    del live
    phase_admission(device, sizes)
    timing = phase_timing(device, sizes, served, grouped, args.seed)
    k3_ms = timing["flash_attention"]["ms"]
    _log(f"[live] K3 share of prefill: {live_launches['flash_attention'] // sizes.live_requests}"
         f" x {k3_ms:.4f} ms / {prefill_ms:.2f} ms = "
         f"{live_launches['flash_attention'] / sizes.live_requests * k3_ms / prefill_ms:.4f}")
    reset_launches()                                  # the estimator path starts here
    t_est = time.perf_counter()
    est = phase_estimator(device, sizes, errs, args.seed)
    est_launches = launches()                         # ... and ends here
    _log(f"[estimator] launches: {est_launches}")
    if est_launches["lane_engine"] == 0:
        _fail(f"the estimator path did not launch the lane engine: {est_launches}")
    profile_scenario(device, est)
    timing["lane_engine"] = time_lane_engine(device, sizes, est)
    _log(f"[estimator] phase 8 took {time.perf_counter() - t_est:.1f} s (host clock, its "
         f"checks, profile and timing included)")
    path_launches = dict(main_launches, flash_attention=live_launches["flash_attention"],
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
        if name == "lane_engine":      # its yardstick is no PyTorch call
            rows[-1]["library"] = t["library"]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
