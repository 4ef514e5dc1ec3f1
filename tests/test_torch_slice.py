"""The whole serving data plane at a small size, through both packages on
the CPU: the same request stream gives the same engine results and
stats, the same pages written into both pools give the same bits, and
decode through paged attention (K1) and grouped shared-prefix decode (K2
+ suffix + LSE merge) agree within the bf16 tolerance of
``tests/test_kernels.py`` (2e-2). The reference kernels run in Pallas
interpret mode. Also runs ``chip_smoke.py``'s phases on the CPU at a
small size, so the script the card runs stays exercised here, its live
phase (the reduced qwen3, granite-moe-1b, recurrentgemma-2b, deepseek-v2,
xlstm and llava served by the engine in live mode, hubert's forwards)
and its training phase included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cacheblocks import layout_for as jlayout_for
from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import TenantSpec as JTenantSpec
from repro_torch.cacheblocks import layout_for
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.serving import EngineConfig, ServingEngine, TenantSpec
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

BT, POOL, N_REQ, PREFIX, USER, EVERY = 4, 96, 40, 16, 8, 8
BF16_ATOL = 2e-2


def _engines():
    out = []
    for get, lay, Eng, Cfg, Spec, kw in (
        (jget_config, jlayout_for, JServingEngine, JEngineConfig, JTenantSpec, {}),
        (get_config, layout_for, ServingEngine, EngineConfig, TenantSpec, {"device": "cpu"}),
    ):
        cfg = dataclasses.replace(get("qwen3-1.7b").reduced(), n_kv_heads=2)  # G = 2
        pool_bytes = POOL * lay(cfg, block_tokens=BT).bytes_per_block
        tenants = [Spec("tenantA", 0.35 * pool_bytes), Spec("tenantB", 0.35 * pool_bytes),
                   Spec("tenantC", 0.20 * pool_bytes)]
        out.append(Eng(cfg, tenants, Cfg(block_tokens=BT, pool_blocks=POOL), **kw))
    return out


def _bf16(a):
    a = np.asarray(a, np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a.copy()).to(torch.bfloat16)


def _gather(kp, vp, table):
    """Reference pool layer (KV, P, page, D) -> (n * page, KV, D) K and V."""
    KV, _, page, D = kp.shape
    return tuple(np.asarray(x[:, table].astype(jnp.float32)).reshape(KV, -1, D).transpose(1, 0, 2)
                 for x in (kp, vp))


def test_slice_through_both_packages():
    jeng, teng = _engines()
    cfg = teng.cfg
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_blocks = (PREFIX + USER) // BT
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, PREFIX) for _ in range(2)]
    written, requests, decoded = {}, [], 0
    for i in range(N_REQ):
        t = int(rng.choice(3, p=[0.4, 0.4, 0.2]))
        tenant = ("tenantA", "tenantB", "tenantC")[t]
        pi = int(rng.integers(0, 2)) if t < 2 else -1
        head = prompts[pi] if t < 2 else rng.integers(0, cfg.vocab_size, PREFIX)
        tokens = np.concatenate([head, rng.integers(0, cfg.vocab_size, USER)])
        a, b = jeng.submit(tenant, tokens), teng.submit(tenant, tokens)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        requests.append((tenant, pi, tokens))
        assert jeng.cache.pages == teng.cache.pages
        for key in teng.cache._keys_for(tokens):          # write new pages once
            page = teng.cache.pages.get(key)
            if page is not None and written.get(page) != key:
                k, v = rng.standard_normal((2, BT, KV, D)).astype(np.float32)
                jeng.pool.write_block(0, page, jnp.asarray(k), jnp.asarray(v))
                teng.pool.write_block(0, page, torch.from_numpy(k), torch.from_numpy(v))
                written[page] = key
        if (i + 1) % EVERY == 0:
            tables = [teng.cache.block_table(tn, tk) for tn, _, tk in requests[-EVERY:]]
            tables = np.stack([tb for tb in tables if len(tb) == n_blocks]).astype(np.int32)
            q = _bf16(rng.standard_normal((len(tables), H, D)))
            cl = np.full(len(tables), n_blocks * BT, np.int32)
            want = jops.paged_attention(q[0], *jeng.pool.layer_pool(0), jnp.asarray(tables),
                                        jnp.asarray(cl), interpret=True)
            got = ops.paged_attention(q[1], *teng.pool.layer_pool(0), torch.from_numpy(tables),
                                      torch.from_numpy(cl))
            np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                       atol=BF16_ATOL)
            decoded += len(tables)
    assert decoded > N_REQ // 2
    assert jeng.stats() == teng.stats()
    assert teng.stats()["evictions"] > 0
    np.testing.assert_array_equal(
        teng.pool.k_pages.view(torch.int16).numpy(),
        np.asarray(jeng.pool.k_pages).view(np.int16),
    )

    # grouped decode: 2 prompts x 2 resident requests each
    groups = {}
    for tenant, pi, tokens in reversed(requests):
        table = teng.cache.block_table(tenant, tokens)
        if pi >= 0 and len(table) == n_blocks and len(groups.setdefault(pi, [])) < 2:
            groups[pi].append(table)
    tables = np.stack([np.stack(groups[p]) for p in sorted(groups)])   # (P, M, n_blocks)
    P, M = tables.shape[:2]
    n_pre = PREFIX // BT
    kp, vp = jeng.pool.layer_pool(0)
    pk, pv = (np.stack(x) for x in zip(*(_gather(kp, vp, tables[p, 0, :n_pre]) for p in range(P))))
    sk, sv = (np.stack(x).reshape(P, M, USER, KV, D) for x in zip(
        *(_gather(kp, vp, tables[p, m, n_pre:]) for p in range(P) for m in range(M))))
    q = _bf16(rng.standard_normal((P, M, H, D)))
    args = [_bf16(x) for x in (pk, pv)]
    sargs = [_bf16(x) for x in (sk, sv)]
    plens, slens = np.full(P, PREFIX, np.int32), np.full((P, M), USER, np.int32)
    want = jops.shared_prefix_decode(q[0], args[0][0], args[1][0], jnp.asarray(plens),
                                     sargs[0][0], sargs[1][0], jnp.asarray(slens))
    got = ops.shared_prefix_decode(q[1], args[0][1], args[1][1], torch.from_numpy(plens),
                                   sargs[0][1], sargs[1][1], torch.from_numpy(slens))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=BF16_ATOL)


def test_chip_smoke_phases_on_cpu_at_small_size():
    import chip_smoke as cs

    sizes = cs.Sizes(reduced=True, pool_blocks=256, block_tokens=4, n_requests=64,
                     n_prompts=2, prefix_tokens=16, user_tokens=8, decode_every=16,
                     groups=2, group_size=2, n_objects=64)
    dev, errs = torch.device("cpu"), cs.Errors()
    cs.phase_kernels(dev, sizes, errs, seed=0)
    served = cs.phase_serving(dev, sizes, errs, seed=0)
    cs.phase_grouped(dev, sizes, served, errs, seed=0)
    assert served["decoded"] > 0 and served["stats"]["requests"] == 64
    assert cs.phase_admission(dev, sizes) > 1.0       # sharing frees memory


def test_chip_smoke_k1_yardstick_computes_k1():
    """The SDPA call that chip_smoke.py times beside K1, on K/V gathered
    through the tables, computes what K1's plain version does."""
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels.paged_attention import paged_attention_plain

    g = torch.Generator().manual_seed(0)
    B, H, KV, D, page, P, ctx = 3, 8, 2, 64, 16, 40, 72
    q = torch.randn((B, H, D), generator=g)
    kp, vp = (torch.randn((KV, P, page, D), generator=g) for _ in range(2))
    bt = torch.randperm(P, generator=g)[: B * 6].reshape(B, 6).to(torch.int32)
    cl = torch.full((B,), ctx, dtype=torch.int32)
    qs, kg, vg = cs.k1_sdpa_inputs(q, kp, vp, bt, ctx)
    got = F.scaled_dot_product_attention(qs, kg, vg, enable_gqa=True)[:, :, 0]
    np.testing.assert_allclose(got.numpy(), paged_attention_plain(q, kp, vp, bt, cl).numpy(),
                               atol=2e-5)


def test_chip_smoke_live_phase_on_cpu_at_small_size():
    """The live phase with the reduced qwen3 (K3's plain version on the
    CPU), and its check against the plain prefill."""
    import chip_smoke as cs

    sizes = cs.Sizes(reduced=True, pool_blocks=256, block_tokens=4, prefix_tokens=16,
                     user_tokens=8, new_tokens=4)
    live = cs.phase_live(torch.device("cpu"), sizes, seed=0)
    assert len(live["results"]) == sizes.live_requests == 8
    assert [r.output.shape for r in live["results"]] == [(1, 4)] * 8
    assert len(live["timed"].prefill_s) == 8 and len(live["timed"].decode_s) == 8 * 3
    assert cs.check_live_against_plain(live, sizes) == 0.0   # plain against itself here
    prof = cs.profile_live(live, sizes)
    assert prof["prefill"]["wall_ms"] > 0 and prof["decode step"]["busy_ms"] is None


def test_chip_smoke_live_phase_serves_three_models_on_cpu_at_small_size():
    """The extended live phase: the reduced qwen3, granite-moe-1b and
    recurrentgemma-2b in turn, each with its check (K3 against the plain
    prefill, recurrentgemma's local layers with their window of 32; and
    recurrentgemma's decode consistency, its prompts longer than its
    window). On the CPU the wrappers run their plain versions and count no
    launch."""
    import chip_smoke as cs

    sizes = cs.Sizes(reduced=True, pool_blocks=256, block_tokens=4, prefix_tokens=32,
                     user_tokens=8, new_tokens=4)
    models = cs.phase_live_models(torch.device("cpu"), sizes, seed=0, card="cpu")
    assert [m["name"] for m in models] == ["qwen3-1.7b", "granite-moe-1b-a400m",
                                           "recurrentgemma-2b"]
    assert [m["k3_per_request"] for m in models] == [2, 2, 2]
    assert all(m["launches"] == dict.fromkeys(cs.KERNELS, 0) for m in models)
    assert all(m["k3_err"] == 0.0 for m in models)              # plain against itself here
    assert 0.0 < models[2]["decode_err"] < 1.0
    assert all(m["prefill_ms"] > 0 and m["decode_ms"] > 0 and m["n_params"] > 0
               for m in models)
    assert sizes.prefix_tokens + sizes.user_tokens > sizes.arch_config("recurrentgemma-2b").window
    # the parameter count walks the whole tree, a tail of blocks included
    import dataclasses
    import math

    from repro_torch.models import make_model
    from repro_torch.models.convert import param_shapes

    def numel(shapes):
        if isinstance(shapes, dict):
            return sum(numel(v) for v in shapes.values())
        if isinstance(shapes, list):
            return sum(numel(v) for v in shapes)
        return math.prod(shapes)

    for m in models:
        assert m["n_params"] == numel(param_shapes(sizes.arch_config(m["name"])))
    cfg = dataclasses.replace(sizes.arch_config("recurrentgemma-2b"), n_layers=8)
    params = make_model(cfg).init(torch.Generator().manual_seed(0))
    assert len(params["tail"]) == 2
    assert sum(t.numel() for t in cs._leaves(params)) == numel(param_shapes(cfg))


def test_chip_smoke_live_phase_serves_the_mla_xlstm_and_frontend_models_on_cpu_at_small_size():
    """The live phase's other models: the reduced deepseek-v2 (MLA, MoE
    with shared experts, its routing replayed in the check), xlstm (its
    decode consistency), llava (text requests and one with an image, each
    prefill held to the plain one) and hubert (forwards over frames, no
    engine, no decode step). On the CPU the wrappers run their plain
    versions and count no launch."""
    import chip_smoke as cs

    sizes = cs.Sizes(reduced=True, pool_blocks=256, block_tokens=4, prefix_tokens=32,
                     user_tokens=8, new_tokens=4, audio_frames=40)
    models = cs.phase_live_models(torch.device("cpu"), sizes, seed=0, card="cpu",
                                  archs=cs.MORE_ARCHS)
    assert [m["name"] for m in models] == list(cs.MORE_ARCHS)
    assert [m["k3_per_request"] for m in models] == [2, 0, 2, 2]
    # four requests each; llava one more with its image
    assert [m["k3_want"] for m in models] == [8, 0, 10, 8]
    assert all(m["launches"] == dict.fromkeys(cs.KERNELS, 0) for m in models)
    ds, xl, lv, hb = models
    assert ds["k3_err"] == lv["k3_err"] == lv["image_err"] == hb["k3_err"] == 0.0
    assert 0.0 < xl["decode_err"] < 1.0
    assert hb["decode_ms"] is None and hb["prefill_ms"] > 0
    assert lv["image_prefill_ms"] > 0 and lv["image_decode_ms"] > 0
    assert all(m["n_params"] > 0 for m in models)
    # the K3 shapes the kernels and timing phases take from the live phase
    shapes = cs.live_k3_shapes(sizes)
    assert (1, 40, 40, 4, 4, 24, 16, True) in shapes                   # MLA, padded
    assert (1, 40 + 8, 40 + 8, 4, 4, 16, 16, True) in shapes            # llava's image request
    assert (1, 40, 40, 4, 4, 16, 16, False) in shapes                   # the encoder
    full = cs.Sizes()
    assert full.arch_config("deepseek-v2-236b").n_layers == 4
    assert (1, 1280, 1280, 128, 128, 192, 128, True) in cs.live_k3_shapes(full)
    assert (1, 2432, 2432, 32, 8, 128, 128, True) in cs.live_k3_shapes(full)
    assert (1, 1000, 1000, 16, 16, 80, 80, False) in cs.live_k3_shapes(full)


def test_chip_smoke_route_tape_replays_an_moe_prefill():
    """chip_smoke.RouteTape: a prefill replaying a recorded routing gives
    the recorded prefill's logits, and pins it where the attention
    differs (here: the plain prefill with a perturbed attention output)."""
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import make_model, shardctx
    from repro_torch.kernels import ops

    cfg = get_config("granite-moe-1b-a400m").reduced()
    m = make_model(cfg, compute_dtype=torch.float32)
    p = m.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 40),
                                     generator=torch.Generator().manual_seed(1))}
    tape = cs.RouteTape()
    with shardctx.rules({"moe_apply": tape}):
        want, _ = m.prefill(p, batch, 44)
    assert len(tape.routes) == cfg.n_layers
    with shardctx.rules({"moe_apply": cs.RouteTape(tape.routes)}):
        got, _ = m.prefill(p, batch, 44)
    assert torch.equal(got, want)
    kernel = ops.flash_attention
    ops.flash_attention = lambda q, k, v, *, causal=True, window=0: 1.01 * kernel(
        q, k, v, causal=causal, window=window)
    try:
        own = cs.RouteTape()
        with shardctx.rules({"moe_apply": own}):
            m.prefill(p, batch, 44)
    finally:
        ops.flash_attention = kernel
    ch = cs.route_changes(tape.routes, own.routes)
    assert ch["of_tokens"] == 40 * cfg.n_layers and ch["of_choices"] == 40 * cfg.n_layers * 2
    assert ch["tokens"] > 0 and cs.route_changes(tape.routes, tape.routes)["tokens"] == 0


def test_chip_smoke_route_tape_replays_a_loss_and_its_gradients():
    """chip_smoke.RouteTape over a loss and gradient pass (bf16 compute,
    as phase 9's holds run): recording computes moe_apply's own function,
    and replaying the recorded routing from the weights' own router pass
    gives the same loss and the same gradients, the router's included."""
    import dataclasses

    import chip_smoke as cs
    from repro_torch.models import make_model, shardctx
    from repro_torch.training import TrainConfig
    from repro_torch.training.train_step import make_grad_fn
    from repro_torch.training.tree import leaves

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), n_layers=2)
    model = make_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    batch = cs._train_batch(cfg, cs.Sizes(reduced=True, train_batch=2, train_seq=32), 0,
                            torch.device("cpu"))
    grad_fn = make_grad_fn(model, TrainConfig())
    want_loss, _, want = grad_fn(params, batch)
    tape = cs.RouteTape()
    with shardctx.rules({"moe_apply": tape}):
        loss, _, got = grad_fn(params, batch)
    with shardctx.rules({"moe_apply": cs.RouteTape(tape.routes)}):
        again_loss, _, again = grad_fn(params, batch)
    assert len(tape.routes) == cfg.n_layers
    assert float(loss) == float(want_loss) == float(again_loss)
    for w, g, a in zip(leaves(want), leaves(got), leaves(again)):
        assert torch.equal(g, w) and torch.equal(a, w)


_TRAIN_PHASE = """
import json, os
import torch
import torch.distributed as dist
import chip_smoke as cs
torch.set_num_threads(1)
sizes = cs.Sizes(reduced=True, train_batch=2, train_seq=32, train_steps=5, grad_layers=2,
                 audio_frames=24, window_seq=48, xlstm_seq=256, pool_blocks=256,
                 block_tokens=4, prefix_tokens=16, user_tokens=8, new_tokens=4,
                 live_requests=4)
errs = cs.Errors()
out = cs.phase_train(torch.device("cpu"), sizes, errs, seed=0, card="cpu")
mesh = out["mesh"]
runs = {a: dict(losses=[r["loss"] for r in mesh[a]["steps"]],
                grads=mesh[a]["grads"]["worst_rel"], grad_launches=mesh[a]["grads"]["launches"],
                tokens=mesh[a]["steps"][0]["tokens_per_s"])
        for a in cs.TRAIN_ARCHS}
print(json.dumps(dict(
    n_bwd_shapes=len(cs.bwd_shapes(sizes)), bwd_err=errs.max["flash_attention_bwd"],
    worst_rel=out["grads"]["worst_rel"], steps=out["run"]["steps"],
    profile_wall_ms=out["run"]["profile_wall_ms"], profile_busy_ms=out["run"]["profile_busy_ms"],
    timing=out["timing"], initialized=dist.is_initialized(), window=cs.sizes_window(sizes),
    mesh_steps={k: v for k, v in mesh["mesh_steps"].items() if k in ("losses", "calls")},
    moe_mesh_steps={k: v for k, v in mesh["moe_mesh_steps"].items() if k in ("losses", "calls")},
    mesh_ckpt=mesh["mesh_ckpt"], mesh_timing=mesh["mesh_timing"], runs=runs,
    grad_only={k: mesh[cs.GRAD_ONLY_ARCH][k] for k in ("worst_rel", "loss_diff", "launches")},
    launches=mesh["launches"],
    placed={k: {f: v[f] for f in ("losses", "calls", "kinds", "split")}
            for k, v in mesh.items() if k.startswith(("h1_", "h2_"))},
    placed_timing={k: v for k, v in mesh["placed_timing"].items() if k != "cfg"},
    split_cache={k: v for k, v in mesh["split_cache"].items() if k != "cfg"},
    partitioned={k: {f: v[f] for f in ("losses", "calls", "kinds", "split")}
                 for k, v in mesh.items() if k.startswith(("i1_", "i5_", "i8_dm"))},
    partitioned_timing=mesh["partitioned_timing"],
    megatron_serve={k: {f: x for f, x in v.items() if f != "cfg"}
                    for k, v in mesh.items()
                    if k in ("megatron_serve", "i8_serve") or k.startswith("i7_")},
    partitioned_grads=mesh["i6"], layer_bytes=mesh["layer_bytes"],
    recurrent=dict(steps={f: mesh["i9_steps"][f] for f in ("losses", "calls", "kinds", "split")},
                   serve={k: v for k, v in mesh["i9_serve"].items() if k != "cfg"},
                   bytes={str(m): r for m, r in mesh["i9_bytes"].items()}),
    xlstm_run=dict(losses=[r["loss"] for r in mesh[cs.XL_ARCH]["steps"]],
                   launches=mesh[cs.XL_ARCH]["launches"]),
    i10={k: ({f: x for f, x in v.items() if f not in ("cfg", "plain", "placed")}
             if isinstance(v, dict) else v)
         for k, v in mesh.items() if k.startswith("i10_")},
    per_rank=out["per_rank"],
    rank_bytes={name: {str(n): r for n, r in v.items()}
                for name, v in mesh["rank_bytes"].items()})), flush=True)
os._exit(0)     # no interpreter teardown after the gloo group (see test_torch_launch.py)
"""


@pytest.fixture(scope="module")
def train_phase():
    """Phase 9 at a small size, in a process of its own (its (e) part opens
    a one-rank gloo group): the JSON of what the tests below hold."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _TRAIN_PHASE], cwd=root, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": f"{root / 'src'}:{root}"})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_chip_smoke_train_phase_on_cpu_at_small_size(train_phase):
    """Phase 9 at a small size: the K3-bwd checks over its shape grid
    (the plain versions against themselves on the CPU), the gradient hold
    (2 layers of the reduced qwen3), the launcher's run with its per-step
    records and the profiled step."""
    out = train_phase
    assert out["n_bwd_shapes"] == 12
    assert out["bwd_err"] == 0.0 and out["worst_rel"] == 0.0
    steps = out["steps"]
    assert [r["step"] for r in steps] == [0, 1, 2, 3, 4]
    assert steps[-1]["loss"] < steps[0]["loss"] and out["profile_wall_ms"] > 0
    assert out["profile_busy_ms"] is None and out["timing"] is None


def test_chip_smoke_train_phase_steps_on_a_mesh_as_without_one(train_phase):
    """Phase 9 (e) at a small size: a one-rank gloo group (gone after the
    phase) and a (data=1) mesh; the data-parallel steps equal the plain
    ones (checked in the phase, which fails otherwise), with the loss's
    sums and one all-reduce a gradient leaf counted; the placed state's
    checkpoint round trip; the step timed with and without the mesh."""
    out = train_phase
    assert not out["initialized"]
    assert len(out["mesh_steps"]["losses"]) == 3 and out["mesh_steps"]["calls"] == 13 + 3
    assert out["mesh_ckpt"]["bytes"] > 0
    t = out["mesh_timing"]
    assert t["calls"] == 16 and t["mesh_ms"] > 0 and t["plain_ms"] > 0
    assert [len(v) for v in t["all_ms"].values()] == [4, 4]
    # granite-moe's steps: its MoE layers' aux sums (and their transposes)
    assert out["moe_mesh_steps"]["calls"] > out["mesh_steps"]["calls"]


def test_chip_smoke_train_phase_trains_the_other_families(train_phase):
    """Phase 9 (f) and (g) at a small size: granite-moe-1b and
    recurrentgemma-2b (its sequence past its window) take 5 steps through
    the launcher with falling losses, each with its gradient hold (the
    plain route against itself on the CPU: granite's replayed routing
    gives the same gradients); deepseek-v2's one-layer hold."""
    out = train_phase
    assert out["window"][0] < out["window"][1]
    for arch, r in out["runs"].items():
        assert len(r["losses"]) == 5 and r["losses"][-1] < r["losses"][0], arch
        assert r["grads"] == 0.0 and r["grad_launches"] == [0, 0], arch
        assert r["tokens"] > 0
    assert out["grad_only"]["worst_rel"] == 0.0 and out["grad_only"]["loss_diff"] == 0.0
    assert out["launches"]["flash_attention"] == 0        # no kernel on the CPU


def test_chip_smoke_train_phase_places_the_state_leaf_by_leaf(train_phase):
    """Phase 9 (h) at a small size, on a (data=1, model=1) mesh of the
    one-rank gloo group: ZeRO-1 (h1; qwen3 with compression, so residuals
    are placed too) and the parameters on "model" (h2), each for qwen3 and
    granite-moe-1b, equal to the plain steps (checked in the phase), with
    a reduce-scatter and an all-gather a parameter leaf under ZeRO-1 and
    an all-gather a parameter and no reduce-scatter on "model"; (h3) the
    step timed with ZeRO-1 and replicated; (h4) the live requests on split
    caches; (h5) the per-rank bytes arithmetic."""
    out = train_phase
    n_leaves = {"qwen3-1.7b": 13, "granite-moe-1b-a400m": 12}
    assert sorted(out["placed"]) == sorted(f"{h}_{a}" for h in ("h1", "h2") for a in n_leaves)
    for key, r in out["placed"].items():
        part, arch = key.split("_", 1)
        n = n_leaves[arch]
        assert len(r["losses"]) == (3 if arch == "qwen3-1.7b" else 2)
        if part == "h1":
            assert r["kinds"]["reduce_scatter"] == n and r["kinds"]["all_gather"] == n
            assert r["split"] == (3 if arch == "qwen3-1.7b" else 2) * n     # mu, nu (, residual)
        else:
            assert r["kinds"]["reduce_scatter"] == 0 and r["kinds"]["all_gather"] == n
            assert r["split"] == 3 * n                                     # params, mu, nu
        assert r["calls"] == sum(r["kinds"].values())
    t = out["placed_timing"]
    assert t["zero1_ms"] > 0 and t["replicated_ms"] > 0
    assert [len(v) for v in t["all_ms"].values()] == [4, 4]
    assert t["kinds"]["zero1"]["reduce_scatter"] == 13 and t["kinds"]["replicated"] == dict(
        all_reduce=13 + 3, reduce_scatter=0, all_gather=0, total=16)
    sc = out["split_cache"]
    assert sc["logits_err"] == 0.0 and sc["prefills"] == 2 * 4 + 2
    assert sc["split_decode_ms"] > 0 and sc["whole_decode_ms"] > 0
    assert sc["split_step_ms"] > 0 and sc["whole_step_ms"] > 0
    rb = out["rank_bytes"]
    assert len(rb) == 3 and all(set(v) == {"1", "2", "4", "8"} for v in rb.values())
    q = rb["qwen3-1.7b"]
    assert q["1"]["zero1"] == q["1"]["replicated"] and q["2"]["zero1"][0] < q["1"]["zero1"][0]
    assert rb["kv_cache"]["2"] * 2 == rb["kv_cache"]["1"]


def test_chip_smoke_train_phase_partitions_over_model(train_phase):
    """Phase 9 (i) at a small size, in the one-rank gloo group: (i1) the
    reduced qwen3 placed as Megatron places it, on a (data=1, model=1)
    mesh with compression and on a mesh of "model" alone, equal to the
    plain steps (checked in the phase), with no gather and the all-reduces
    predicted: 13 gradient leaves, the loss's 3, the norm's 1 (and the
    compression's 2), per layer 2 + 1 + 2 of the model group at --remat
    (the recomputation of each one-layer tile stops before its last sum)
    and the norms' packed sum; (i2) the step timed partitioned, gathered
    and plain; (i3) the live requests partitioned, the logits equal; (i5)
    the reduced granite-moe-1b with its experts on their columns and on
    their expert dim, equal to the plain steps, its all-reduces: 12
    gradient leaves, the loss's 3, the norm's 1, per layer the aux loss's
    2 + 2 + 1 and the model group's 2 + 1 + 3 at --remat; (i6) the reduced
    deepseek-v2's one-layer loss and gradients partitioned, equal to the
    plain ones, 7 model-group all-reduces (MLA 1 + 3, the MoE 1 + 2); (i7)
    granite's and deepseek-v2's live requests partitioned, the logits
    equal; the layer arithmetic of (i4); and K3 and K3-bwd at each rank's
    heads (GQA's and MLA's; (i10)'s hubert and llava at 2 ranks) against
    their plain versions. (i8) the
    embedding and the head split on their vocabulary too: qwen3's steps
    equal to the plain ones with 4 more all-reduces (the lookup's, the
    loss's 2, the head's input gradient) and its embedding split too,
    deepseek-v2's one-layer gradients equal with 4 more model-group
    all-reduces, qwen3's live requests with the logits equal, per pass one
    all-reduce more (the lookup) and one all-gather of the logits; the
    arithmetic of "partitioned + vocab" below "partitioned" at every
    rank count."""
    out = train_phase
    want = 13 + 3 + 1 + 5 * 2 + 1
    for key, comp in (("i1_dm", True), ("i1_m", False)):
        r = out["partitioned"][key]
        assert len(r["losses"]) == 3
        assert r["kinds"] == dict(all_reduce=want + (2 if comp else 0), reduce_scatter=0,
                                  all_gather=0)
        assert r["split"] == 7 * (3 if comp else 2) + 7     # params, mu, nu (, residuals)
    for role in ("column", "expert"):
        r = out["partitioned"][f"i5_{role}"]
        assert len(r["losses"]) == 3
        assert r["kinds"] == dict(all_reduce=12 + 3 + 1 + 5 * 2 + 6 * 2, reduce_scatter=0,
                                  all_gather=0)
        assert r["split"] == 7 * 3                           # params, mu, nu
    t = out["partitioned_timing"]
    assert set(t["ms"]) == {"partitioned", "gathered", "plain"} and min(t["ms"].values()) > 0
    assert t["kinds"]["partitioned"] == dict(all_reduce=want, reduce_scatter=0, all_gather=0,
                                             total=want)
    assert t["kinds"]["gathered"]["all_gather"] == 13
    r = out["partitioned"]["i8_dm"]
    assert len(r["losses"]) == 3
    assert r["kinds"] == dict(all_reduce=want + 4, reduce_scatter=0, all_gather=0)
    assert r["split"] == 8 * 3                               # params, mu, nu; the embedding
    serves = out["megatron_serve"]
    assert sorted(serves) == ["i7_deepseek-v2-236b", "i7_granite-moe-1b-a400m", "i8_serve",
                              "megatron_serve"]
    for key, sv in serves.items():      # 4 requests each (live_requests, more_requests)
        vocab = key == "i8_serve"       # held to megatron_serve's tokens: no plain run
        assert sv["logits_err"] == 0.0 and sv["prefills"] == (1 if vocab else 2) * 4 + 2
        assert sv["kinds"] == ({"all_reduce": 2 * (2 * 2 + 1), "all_gather": 2} if vocab
                               else {"all_reduce": 2 * 2 * 2})
    g = out["partitioned_grads"]
    assert g["kinds"] == {"all_reduce": 7} and g["split"] == 10
    assert g["vocab"]["kinds"] == {"all_reduce": 7 + 4} and g["vocab"]["split"] == 10 + 2
    assert g["vocab"]["loss"] == g["loss"]
    lb = out["layer_bytes"]
    assert set(lb) == {"2", "4", "8"} and lb["2"]["experts"] == 2 * lb["4"]["experts"]
    assert all(r["gb_vocab"] < r["gb"] for r in lb.values())
    q = out["rank_bytes"]["qwen3-1.7b"]
    for n in ("2", "4", "8"):
        assert q[n]["partitioned + vocab"][0] < q[n]["partitioned"][0]
        assert q[n]["partitioned + vocab"][1] < q[n]["partitioned"][1]
    # at 1 rank nothing splits; the reduced vocabulary (512) divides over 8
    assert q["1"]["partitioned + vocab"] == q["1"]["partitioned"] == q["1"]["replicated"]
    gqa, mla = " D=16/16 (padded to 64)", " D=24/16 (padded to 64)"
    # then (i10)'s at 2 ranks: hubert's encoder (K3 and K3-bwd), llava's K3
    front = {"flash_attention": ["hubert-xlarge", "llava-next-mistral-7b"],
             "flash_attention_bwd": ["hubert-xlarge"]}
    for name in ("flash_attention", "flash_attention_bwd"):
        assert [r["heads"] for r in out["per_rank"][name]][:4] == [
            "H=2 KV=2" + gqa, "H=1 KV=1" + gqa, "H=2 KV=2" + mla, "H=1 KV=1" + mla]
        assert [(r["arch"], r["heads"], r["m"]) for r in out["per_rank"][name]][4:] == [
            (arch, "H=2 KV=2" + gqa, 2) for arch in front[name]]
        assert all(r["max_abs_err"] == 0.0 for r in out["per_rank"][name])


def test_chip_smoke_train_phase_partitions_recurrentgemma(train_phase):
    """Phase 9 (i9) at a small size, in the one-rank gloo group: the reduced
    recurrentgemma (8 layers: two tiles of (rglru, rglru, local) and two
    RG-LRU layers in the tail; a sequence past its window) placed with the
    RG-LRU on its width, MQA's query heads split, the MLP and the
    vocabulary, equal to the plain steps (checked in the phase), with the
    collectives predicted: 63 gradient leaves, the loss's 3, the norm's 1,
    wk's and wv's packed sum, the vocabulary's 4, 4 a layer of the model
    group and at --remat each tile's 5 again; an all-gather a RG-LRU layer
    (the tiles' again at --remat) and a reduce-scatter each; its live
    requests (the reduced config's 6 layers) with prompts past the window
    partitioned, the logits equal, the states on their width; (i4)'s
    arithmetic at 2, 4, 5 and 8 ranks."""
    r = train_phase["recurrent"]
    steps = r["steps"]
    assert len(steps["losses"]) == 3
    assert steps["kinds"] == dict(all_reduce=63 + 3 + 1 + 1 + 4 + 4 * 8 + 2 * 5,
                                  reduce_scatter=6, all_gather=6 + 4)
    # params, mu, nu of the split leaves: 8 in each of 4 RG-LRU groups, wq
    # and wo, 3 in each of 5 MLPs, the embedding
    assert steps["split"] == 3 * (8 * 4 + 2 + 3 * 5 + 1)
    sv = r["serve"]
    assert sv["logits_err"] == 0.0 and sv["prefills"] == 2 * 4 + 2
    # served at the reduced config's depth: 6 layers, 4 of them RG-LRU
    assert sv["kinds"] == {"all_reduce": 2 * (2 * 6 + 1), "all_gather": 2 * (4 + 1)}
    b = r["bytes"]
    assert sorted(b) == ["2", "4", "5", "8"]
    # the reduced widths: H=4, W=64, d_ff=128, V=512; 5 divides none of them
    assert b["2"]["families"] == b["4"]["families"] == ["attn", "mlp", "rglru", "vocab"]
    assert b["8"]["families"] == ["mlp", "rglru", "vocab"] and b["5"]["families"] == []
    assert b["2"]["held_gb"] > b["4"]["held_gb"] > b["8"]["held_gb"]


def test_chip_smoke_train_phase_trains_xlstm(train_phase):
    """Phase 9 (f) at a small size: the reduced xlstm-125m takes 3
    launcher steps of 2 x 256 tokens (its sLSTM's loop forward and
    backward, remat's forward again) with a falling loss, and launches no
    kernel (no attention; on the CPU nothing launches)."""
    r = train_phase["xlstm_run"]
    assert len(r["losses"]) == 3 and r["losses"][-1] < r["losses"][0]
    assert r["launches"]["flash_attention"] == r["launches"]["flash_attention_bwd"] == 0


def test_chip_smoke_train_phase_partitions_xlstm_and_the_frontends(train_phase):
    """Phase 9 (i10) at a small size, in the one-rank gloo group: the
    reduced xlstm-125m (12 layers: two tiles of five mLSTM blocks and an
    sLSTM) placed on its heads and vocabulary, equal to the plain steps
    (checked in the phase), with the collectives predicted: 71 gradient
    leaves, the loss's 3, the norm's 1, w_in's sum, the vocabulary's 4, 4
    a layer of the model group and at --remat 2 a layer again (the
    recomputation reaches each tile's last sum, which the sLSTM's GLU
    reads); an all-gather an mLSTM layer (twice at --remat) and a
    reduce-scatter each; its live requests partitioned, logits equal, 2
    all-reduces a layer and pass and one for the lookup, an all-gather an
    mLSTM layer and one of the logits; hubert's 4-layer steps (its frames
    in: the vocabulary's 3, no lookup) and 4 forwards, and llava's image
    request, partitioned and equal to plain; no K3 on the CPU."""
    r = train_phase["i10"]
    steps = r["i10_xlstm_steps"]
    assert len(steps["losses"]) == 3
    assert steps["kinds"] == dict(all_reduce=71 + 3 + 1 + 1 + 4 + 4 * 12 + 2 * 12,
                                  reduce_scatter=10, all_gather=10 + 10)
    # params, mu, nu of the split leaves: 11 in each of 5 mLSTM groups, 6 in
    # the sLSTM's, the embedding
    assert steps["split"] == 3 * (11 * 5 + 6 + 1)
    sv = r["i10_xlstm_serve"]
    assert sv["logits_err"] == 0.0 and sv["prefills"] == 2 * 4 + 2
    assert sv["kinds"] == {"all_reduce": 2 * (2 * 12 + 1), "all_gather": 2 * (10 + 1)}
    hub = r["i10_hubert_steps"]
    assert hub["kinds"] == dict(all_reduce=15 + 3 + 1 + 3 + 4 * (2 * 2 + 2) - 4,
                                reduce_scatter=0, all_gather=0)
    assert hub["losses"][0] > 0 and len(hub["losses"]) == 2
    fw = r["i10_hubert_forwards"]
    assert fw["logits_err"] == 0.0 and fw["families"] == ["attn", "mlp", "vocab"]
    assert fw["kinds"] == {"all_reduce": 4 * 2 * 2, "all_gather": 4}
    image = r["i10_image"]
    assert image["logits_err"] == 0.0 and len(image["tokens"]) == 4
    assert image["T"] == 8 + 16 + 8
    assert r["i10_k3"] == {"steps": [0, 0], "forwards": [0, 0], "image": [0, 0]}


_LAUNCH_PHASE = """
import json, os, sys
import torch
import torch.distributed as dist
import chip_smoke as cs
torch.set_num_threads(1)
sizes = cs.Sizes(reduced=True, pool_blocks=256, block_tokens=4, prefix_tokens=16,
                 user_tokens=8, new_tokens=4, live_requests=4)
out = cs.phase_launch(torch.device("cpu"), sizes, seed=0)
keep = ("decode_ms", "plain_decode_ms", "step_ms", "plain_step_ms", "prefill_ms",
        "plain_prefill_ms", "logits_err", "prefills")
print(json.dumps(dict(
    initialized=dist.is_initialized(), k3_want=out["k3_want"], n_specs=out["n_specs"],
    rounds=cs.LAUNCH_ROUNDS, serve_requests=cs.SERVE_REQUESTS,
    **{part: {k: v for k, v in out[part].items() if k in keep}
       for part in ("flash_decode", "moe_ep")})), flush=True)
os._exit(0)     # no interpreter teardown after the gloo group (see test_torch_launch.py)
"""


def test_chip_smoke_launch_phase_on_cpu_at_small_size():
    """Phase 10 at a small size through a one-rank gloo group (the card's
    run takes NCCL), in a process of its own: the reduced qwen3 served
    with and without the flash-decode override (the same tokens), the
    reduced granite-moe-1b's prefills with and without EP (the same kept
    slots), the serving CLI with --live, and the meta-device input specs;
    the group is gone after the phase."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    res = subprocess.run([sys.executable, "-c", _LAUNCH_PHASE], cwd=root, capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": f"{root / 'src'}:{root}"})
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert not out["initialized"]
    fd, ep = out["flash_decode"], out["moe_ep"]
    assert fd["decode_ms"] > 0 and fd["plain_decode_ms"] > 0 and fd["prefills"] == 2 * 4 + 1
    assert fd["step_ms"] > 0 and fd["plain_step_ms"] > 0 and fd["logits_err"] == 0.0
    assert ep["prefill_ms"] > 0 and ep["plain_prefill_ms"] > 0 and ep["logits_err"] == 0.0
    assert ep["prefills"] == 2 * out["rounds"]
    # 2 global-attention layers a prefill of the reduced models, 60 CLI requests
    assert out["k3_want"] == 2 * (9 + 2 * out["rounds"]) + 2 * out["serve_requests"]
    assert out["n_specs"] > 0


def test_chip_smoke_bwd_timing_shapes():
    """K3-bwd is timed at the training shapes of qwen3-1.7b (the main
    path's, first), granite-moe-1b, deepseek-v2's MLA and hubert's encoder,
    B=4, which reach every head size the kernel is built for; phase 9's
    checks take qwen3's shape at a ragged T as well."""
    import chip_smoke as cs

    full = cs.Sizes()
    shapes = cs.bwd_timing_shapes(full)
    assert shapes == [(4, 1024, 16, 8, 128, 128, True), (4, 1024, 16, 8, 64, 64, True),
                      (4, 1024, 128, 128, 192, 128, True), (4, 1000, 16, 16, 80, 80, False)]
    assert sorted({cs.kernel_head_dim(max(s[4:6])) for s in shapes}) == [64, 128, 256]
    assert cs.bwd_shapes(full)[-1] == (4, 1000, 16, 8, 128, 128, True)
    # recurrentgemma-2b's local attention: its training shape with its window
    assert cs.windowed_shape(full) == (1, 4096, 10, 1, 256, 256, True, 2048)
    assert cs.windowed_shape(full) in cs.bwd_shapes(full)
    assert cs.attended_pairs(4096, 4096, True, 2048) == 6_292_480
    assert cs.attended_pairs(4096, 4096, True) == 4096 * 4097 // 2


def test_chip_smoke_estimator_phase_on_cpu_at_small_size():
    """Phase 8 at a small size: the lane engine's host build in the place
    of the kernel (every lane still held to the host C engine), the
    Scenario path on its default backend with device="cpu" (the lane
    engine's host build) against backend="c",
    and the batched working-set solve."""
    import chip_smoke as cs

    sizes = cs.Sizes(table1_requests=20_000, table1_replicas=2, fig2_requests=6_000,
                     fig2_replicas=2, fig2_catalogue=0.001, scenario_requests=10_000)
    errs = cs.Errors()
    est = cs.phase_estimator(torch.device("cpu"), sizes, errs, seed=0)
    t1 = est["table1"]
    assert t1["L"] == 16 and t1["card"].idx == 20_000 and t1["card"].elapsed > 0
    assert est["fig2"]["R"] == 2 and est["fig2"]["n"] == 6_000
    assert errs.max["lane_engine"] == 0.0
    rep = est["scenario"]["report"]
    assert rep.backend == "cuda" and rep.replications == 4 and rep.ensemble["batched"]
    assert cs.profile_scenario(torch.device("cpu"), est)["busy_ms"] is None


@pytest.mark.parametrize("kw", [dict(), dict(ghost_retention=False),
                                 dict(ripple_allocations=(10, 12, 9))])
def test_chip_smoke_counts_a_chunks_evictions_from_the_holder_bits(kw):
    """chip_smoke.chunk_mix derives a chunk's evictions from the lanes'
    counters and holder bits (no counter of its own); it equals the
    evictions the per-operation engine (FastSharedLRU) reports for the
    same requests."""
    import chip_smoke as cs
    from repro_torch.core import fastsim_cuda
    from repro_torch.core.fastsim import FastSharedLRU, SimParams
    from repro_torch.core.irm import rate_matrix, sample_trace

    N, n, cut = 200, 6_000, 2_000
    tr = sample_trace(rate_matrix(N, [0.8, 1.0, 0.6]), n, seed=5)
    p = SimParams(allocations=(8, 8, 6), physical_capacity=60, **kw)
    run = fastsim_cuda.CudaChunkRunner(p, N, np.ones(N, np.int64), 1_000, 1_000, 6,
                                       device="cpu")
    ref = FastSharedLRU(N, (8, 8, 6), 60, **kw)
    requests = list(zip(tr.proxies.tolist(), tr.objects.tolist()))
    run.feed(tr.proxies[:cut], tr.objects[:cut])
    for i, k in requests[:cut]:
        ref.get_autofetch(i, k, 1)
    before = cs.lane_sums(run)
    run.feed(tr.proxies[cut:], tr.objects[cut:])
    n_ev = sum(len(ref.get_autofetch(i, k, 1)[1]) for i, k in requests[cut:])
    mix = cs.chunk_mix(before, cs.lane_sums(run))
    assert mix["steps"] == n - cut and n_ev > 0
    assert round(mix["evictions"] * (n - cut)) == n_ev
    assert mix["list_hits"] + mix["attaches"] + mix["misses"] == pytest.approx(1.0)
    assert mix["levels"] > 1.0
