"""The port's block pool and shared prefix cache against the reference.

Pages are compared bit for bit (as 16-bit patterns); the cache manager is
a host copy, so the same request stream must give identical lookups, page
ids, eviction and ripple counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cacheblocks import BlockPool as JBlockPool
from repro.cacheblocks import SharedPrefixCache as JSharedPrefixCache
from repro.cacheblocks import layout_for as jlayout_for
from repro.configs import get_config as jget_config
from repro_torch.cacheblocks import BlockPool, SharedPrefixCache, layout_for
from repro_torch.configs import get_config
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

L, KV, NB, BT, D = 2, 2, 12, 4, 8


def _bits_np(a):
    return np.asarray(a).view(np.uint16)


def _bits_t(t):
    return t.cpu().view(torch.int16).numpy().view(np.uint16)


def _pools():
    return JBlockPool(NB, BT, KV, D, L), BlockPool(NB, BT, KV, D, L, device="cpu")


def _write_same(jpool, pool, writes, seed=0):
    rng = np.random.default_rng(seed)
    for layer, block in writes:
        k = rng.standard_normal((BT, KV, D)).astype(np.float32)
        v = rng.standard_normal((BT, KV, D)).astype(np.float32)
        jpool.write_block(layer, block, jnp.asarray(k), jnp.asarray(v))
        pool.write_block(layer, block, torch.from_numpy(k), torch.from_numpy(v))


def test_write_block_and_layer_pool_bit_exact():
    jpool, pool = _pools()
    assert pool.k_pages.dtype == torch.bfloat16
    assert pool.k_pages.shape == tuple(jpool.k_pages.shape)
    _write_same(jpool, pool, [(0, 3), (1, 3), (0, 7), (1, 0), (0, 3)])
    np.testing.assert_array_equal(_bits_t(pool.k_pages), _bits_np(jpool.k_pages))
    np.testing.assert_array_equal(_bits_t(pool.v_pages), _bits_np(jpool.v_pages))
    for layer in range(L):
        (jk, jv), (k, v) = jpool.layer_pool(layer), pool.layer_pool(layer)
        assert k.shape == (KV, NB, BT, D)
        assert k.data_ptr() == pool.k_pages[layer].data_ptr()   # a view
        np.testing.assert_array_equal(_bits_t(k), _bits_np(jk))
        np.testing.assert_array_equal(_bits_t(v), _bits_np(jv))


def test_load_numpy_round_trips_a_reference_pool():
    jpool, pool = _pools()
    _write_same(jpool, pool, [(0, 1), (1, 5), (1, 11)], seed=1)
    jk, jv = np.asarray(jpool.k_pages), np.asarray(jpool.v_pages)
    assert jk.dtype.name == "bfloat16"            # ml_dtypes: not a torch dtype
    fresh = BlockPool(NB, BT, KV, D, L, device="cpu")
    fresh.load_numpy(jk, jv)
    np.testing.assert_array_equal(_bits_t(fresh.k_pages), jk.view(np.uint16))
    np.testing.assert_array_equal(_bits_t(fresh.v_pages), jv.view(np.uint16))
    f32 = BlockPool(NB, BT, KV, D, L, dtype=torch.float32, device="cpu")
    f32.load_numpy(jk.astype(np.float32), jv.astype(np.float32))
    np.testing.assert_array_equal(f32.k_pages.numpy(), jk.astype(np.float32))
    with pytest.raises(ValueError, match="do not fit"):
        fresh.load_numpy(jk[:1], jv[:1])


def test_pool_accounting_matches_reference():
    jpool, pool = _pools()
    for p in (jpool, pool):
        a = p.alloc(5)
        p.free(a[:2])
        p.alloc(3)
    assert pool._free == jpool._free
    assert (pool.used_blocks, pool.high_water) == (jpool.used_blocks, jpool.high_water)
    with pytest.raises(MemoryError):
        pool.alloc(NB)


def _caches(pool_blocks=48, block_tokens=4, allocs=(10, 10, 6), ripple=None):
    """The same cache built in both packages: (reference, port)."""
    out = []
    for get, lay, Pool, Cache, kw in (
        (jget_config, jlayout_for, JBlockPool, JSharedPrefixCache, {}),
        (get_config, layout_for, BlockPool, SharedPrefixCache, {"device": "cpu"}),
    ):
        cfg = get("qwen3-1.7b").reduced()
        layout = lay(cfg, block_tokens=block_tokens)
        pool = Pool(pool_blocks, block_tokens, cfg.n_kv_heads, cfg.head_dim, 1, **kw)
        bpb = layout.bytes_per_block
        names = [f"t{i}" for i in range(len(allocs))]
        out.append(Cache(
            pool, layout, {n: a * bpb for n, a in zip(names, allocs)},
            physical_capacity_bytes=pool_blocks * bpb,
            ripple_allocations=(
                None if ripple is None else {n: a * bpb for n, a in zip(names, ripple)}
            ),
        ))
    return out


def _stream(n, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 512, 12) for _ in range(4)]
    for _ in range(n):
        t = int(rng.integers(0, 3))
        head = prompts[rng.integers(0, 4)] if t < 2 else rng.integers(0, 512, 12)
        yield f"t{t}", np.concatenate([head, rng.integers(0, 512, 8)])


@pytest.mark.parametrize("ripple", [None, (12, 12, 8)])
def test_prefix_cache_same_stream_same_state(ripple):
    jc, tc = _caches(ripple=ripple)
    evictions = 0
    for tenant, toks in _stream(300, seed=7):
        a, b = jc.lookup(tenant, toks), tc.lookup(tenant, toks)
        assert (a.cached_blocks, a.cached_tokens, a.block_ids, a.keys) == (
            b.cached_blocks, b.cached_tokens, b.block_ids, b.keys)
        assert (a.hit_list, a.hit_cache, a.evictions, a.ripple_evictions) == (
            b.hit_list, b.hit_cache, b.evictions, b.ripple_evictions)
        (pa, sa), (pb, sb) = (
            c.insert(tenant, toks, start_block=a.cached_blocks) for c in (jc, tc)
        )
        assert pa == pb
        evictions += sb.total_evictions
        assert (sa.total_evictions, sa.total_ripple, sa.new_pages, sa.result.name) == (
            sb.total_evictions, sb.total_ripple, sb.new_pages, sb.result.name)
        np.testing.assert_array_equal(jc.block_table(tenant, toks), tc.block_table(tenant, toks))
    assert jc.pages == tc.pages
    assert jc.sharing_ratio() == tc.sharing_ratio()
    assert [jc.vlen_bytes(t) for t in jc.tenants] == [tc.vlen_bytes(t) for t in tc.tenants]
    assert jc.pool.used_blocks == tc.pool.used_blocks
    assert evictions > 0 and tc.sharing_ratio() > 1.0   # the stream exercised both
