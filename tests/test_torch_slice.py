"""The whole serving data plane at a small size, through both packages on
the CPU: the same request stream gives the same engine results and
stats, the same pages written into both pools give the same bits, and
decode through paged attention (K1) and grouped shared-prefix decode (K2
+ suffix + LSE merge) agree within the bf16 tolerance of
``tests/test_kernels.py`` (2e-2). The reference kernels run in Pallas
interpret mode. Also runs ``chip_smoke.py``'s phases on the CPU at a
small size, so the script the card runs stays exercised here, its live
phase (the reduced model served by the engine in live mode) included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
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
