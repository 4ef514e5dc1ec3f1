"""The port's MoE feed-forward against the reference's ``moe_apply``, on
the CPU, in f32.

Reduced granite-moe-1b (E = 8, top-2, no shared expert) and reduced
deepseek-v2 (E = 8, top-2, two shared experts), the reference's
parameters carried across as numpy, inputs from a seed. Outputs and the
aux loss are held to atol 1e-5 (observed below 6e-7: the same products, sums
in another order). The capacity drops, the drop-free decode case, the
lower-index rule for ties and the per-chunk capacity of the launcher's
``moe_chunks`` must be the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import shardctx as jshardctx
from repro_torch.configs import get_config
from repro_torch.models import make_model, moe, shardctx
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ATOL = 1e-5
CONFIGS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]


def _setup(name, seed=0):
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, cfg, jp, p


def _x(cfg, B, T, seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, cfg.d_model)).astype(np.float32)


def _both(jcfg, cfg, jp, p, x, **kw):
    want, jaux = jmoe.moe_apply(jnp.asarray(x), jp, jcfg, **kw)
    got, aux = moe.moe_apply(torch.from_numpy(x), p, cfg, **kw)
    return (got.numpy(), float(aux)), (np.asarray(want), float(jaux))


def _route(cfg, p, x, **kw):
    return moe.moe_route(torch.from_numpy(x.reshape(-1, x.shape[-1])), p, cfg, **kw)


@pytest.mark.parametrize("name", CONFIGS)
def test_moe_init_tree_matches_reference(name):
    jcfg, cfg, jp, _ = _setup(name)
    port = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), port) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    assert port["router"].dtype == torch.float32 == moe.moe_init(
        torch.Generator().manual_seed(0), cfg, torch.bfloat16)["router"].dtype   # router in f32
    assert ("shared" in port) == (cfg.n_shared_experts > 0)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0], ids=["cf1.25", "drops", "drop-free"])
def test_moe_apply_matches_reference(name, cf):
    """Training/prefill capacity. At cf = 0.5 the capacity is half the
    mean load, so assignments are dropped, and the reference drops the
    same ones: the outputs agree. At cf = E nothing can be dropped."""
    jcfg, cfg, jp, p = _setup(name)
    x = _x(cfg, 2, 24)
    (got, aux), (want, jaux) = _both(jcfg, cfg, jp, p, x, capacity_factor=cf)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(jaux, abs=ATOL)
    keep = _route(cfg, p, x, capacity_factor=cf)["keep"]
    if cf < 1:
        assert int((~keep).sum()) > 0
    if cf == cfg.n_experts:
        assert bool(keep.all())


@pytest.mark.parametrize("name", CONFIGS)
def test_moe_no_drop_decode_matches_reference(name):
    """The decode path: C = N, nothing is dropped."""
    jcfg, cfg, jp, p = _setup(name)
    x = _x(cfg, 3, 1, seed=2)
    (got, aux), (want, jaux) = _both(jcfg, cfg, jp, p, x, no_drop=True)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(jaux, abs=ATOL)
    r = _route(cfg, p, x, no_drop=True)
    assert r["C"] == 3 and bool(r["keep"].all())


@pytest.mark.parametrize("name", CONFIGS)
def test_equal_router_logits_pick_the_lowest_experts(name):
    """A zero router gives every expert the same probability: top-k must
    be experts 0..k-1 for every token, as jax.lax.top_k breaks ties."""
    jcfg, cfg, jp, p = _setup(name)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _x(cfg, 2, 8, seed=3)
    r = _route(cfg, p, x)
    assert r["top_i"].tolist() == [list(range(cfg.top_k))] * 16
    (got, aux), (want, jaux) = _both(jcfg, cfg, jp, p, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(jaux, abs=ATOL)
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    assert moe.top_k_lower_index(probs, 3)[1].tolist() == [[1, 2, 4]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1]).tolist() == [[1, 2, 4]]


def test_moe_chunks_per_chunk_capacity_matches_reference():
    """The launcher's per-shard capacity (``moe_chunks`` in shardctx): a
    different drop pattern, the same in both packages."""
    jcfg, cfg, jp, p = _setup("granite-moe-1b-a400m")
    x = _x(cfg, 2, 24, seed=4)
    with jshardctx.rules({"moe_chunks": 4}), shardctx.rules({"moe_chunks": 4}):
        (got, aux), (want, jaux) = _both(jcfg, cfg, jp, p, x, capacity_factor=0.75)
        chunked = _route(cfg, p, x, capacity_factor=0.75)["keep"]
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(jaux, abs=ATOL)
    assert not torch.equal(chunked, _route(cfg, p, x, capacity_factor=0.75)["keep"])


def test_transformer_honours_the_moe_apply_override():
    """TransformerLM._moe runs an installed ``moe_apply`` and falls back to
    the gather dispatch when it returns None; decode never consults it."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    m = make_model(cfg, compute_dtype=torch.float32)
    params = m.init(torch.Generator().manual_seed(0))
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (1, 6),
                                    generator=torch.Generator().manual_seed(1))}
    base = m.forward_logits(params, toks)
    calls = []

    def declined(h, p, c, *, capacity_factor):
        calls.append(capacity_factor)
        return None

    with shardctx.rules({"moe_apply": declined}):
        np.testing.assert_array_equal(m.forward_logits(params, toks).numpy(), base.numpy())
        _, caches = m.prefill(params, toks, 8)
        n = len(calls)
        m.decode_step(params, toks["tokens"][:, -1:], caches, torch.tensor([6]))
    assert calls == [cfg.capacity_factor] * n and n == 2 * cfg.n_layers
    with shardctx.rules({"moe_apply": lambda h, p, c, **kw: (torch.zeros_like(h),
                                                             torch.zeros(()))}):
        assert not torch.allclose(m.forward_logits(params, toks), base)
