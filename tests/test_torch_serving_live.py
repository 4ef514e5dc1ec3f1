"""The port's live serving mode against the reference's, on the CPU.

Both engines get the same reduced model (qwen3, stablelm, granite-moe,
recurrentgemma, deepseek-v2, xlstm and llava's text path; the
reference's parameters carried across with
``from_jax_params``, f32 compute) and the same numpy
request stream; greedy decode must give the same tokens, and the cache
accounting the same results and stats. Temperature / top-k sampling is
held in distribution only: a ``torch.Generator`` does not give
``jax.random``'s bits.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cacheblocks import layout_for as jlayout_for
from repro.configs import get_config as jget_config
from repro.models import make_model as jmake_model
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import TenantSpec as JTenantSpec
from repro.serving.sampler import sample_token as jsample_token
from repro_torch.cacheblocks import layout_for
from repro_torch.configs import get_config
from repro_torch.models import from_jax_params, make_model
from repro_torch.serving import EngineConfig, ServingEngine, TenantSpec, greedy_decode, sample_token
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

BT, POOL, PREFIX, USER, NEW = 4, 48, 12, 6, 4


def _engines(name="qwen3-1.7b", kw=None):
    """(reference engine, port engine) over the same model and pool."""
    kw = {"n_kv_heads": 2} if kw is None else kw
    jcfg = dataclasses.replace(jget_config(name).reduced(), **kw)
    cfg = dataclasses.replace(get_config(name).reduced(), **kw)
    jm = jmake_model(jcfg, compute_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    m = make_model(cfg, compute_dtype=torch.float32)
    p = from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    out = []
    for c, lay, Eng, Cfg, Spec, live in (
        (jcfg, jlayout_for, JServingEngine, JEngineConfig, JTenantSpec,
         dict(model=jm, params=jp)),
        (cfg, layout_for, ServingEngine, EngineConfig, TenantSpec,
         dict(model=m, params=p, device="cpu")),
    ):
        pool_bytes = POOL * lay(c, block_tokens=BT).bytes_per_block
        tenants = [Spec("tenantA", 0.35 * pool_bytes), Spec("tenantB", 0.35 * pool_bytes),
                   Spec("tenantC", 0.20 * pool_bytes)]
        out.append(Eng(c, tenants, Cfg(block_tokens=BT, pool_blocks=POOL), **live))
    return out


def _serve_both(name="qwen3-1.7b", kw=None):
    """Six requests (shared prompts and a private one) through both
    engines: the same tokens, results and stats."""
    jeng, teng = _engines(name, kw)
    rng = np.random.default_rng(0)
    vocab = teng.cfg.vocab_size
    prompts = [rng.integers(0, vocab, PREFIX) for _ in range(2)]
    for tenant, pi in (("tenantA", 0), ("tenantB", 0), ("tenantC", -1), ("tenantA", 1),
                       ("tenantB", 1), ("tenantA", 0)):
        head = prompts[pi] if pi >= 0 else rng.integers(0, vocab, PREFIX)
        tokens = np.concatenate([head, rng.integers(0, vocab, USER)])
        a, b = jeng.submit(tenant, tokens, NEW), teng.submit(tenant, tokens, NEW)
        assert b.output.dtype == np.int32 and b.output.shape == (1, NEW)
        np.testing.assert_array_equal(b.output, np.asarray(a.output))
        ra, rb = dataclasses.asdict(a), dataclasses.asdict(b)
        ra.pop("output"), rb.pop("output")
        assert ra == rb
    assert teng.stats() == jeng.stats()
    assert teng.stats()["prefix_hit_token_ratio"] > 0      # the shared prompts hit


def test_live_engine_matches_reference():
    _serve_both()


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "recurrentgemma-2b"])
def test_live_engine_matches_reference_moe_and_hybrid(name):
    """granite-moe-1b (MoE; decode drop-free) and recurrentgemma-2b (RG-LRU
    states and a local ring buffer; its cache objects are state snapshots,
    so the pool accounts them as the reference does)."""
    _serve_both(name, {})


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "xlstm-125m", "llava-next-mistral-7b"])
def test_live_engine_matches_reference_mla_xlstm_and_vision(name):
    """deepseek-v2 (MLA's latent cache written in place at each step; MoE
    with shared experts, decode drop-free), xlstm (mLSTM and sLSTM states;
    state-snapshot objects in the pool) and llava (text requests: the
    engine is text-only, as the reference's)."""
    _serve_both(name, {})


def test_live_engine_decode_round_trip():
    """tests/test_system.py's round trip: the same prompt twice gives the
    same outputs, the second served from the shared cache."""
    _, eng = _engines("stablelm-1.6b", {})
    prompt = np.arange(16) % eng.cfg.vocab_size
    r1 = eng.submit("tenantA", prompt, max_new_tokens=4)
    r2 = eng.submit("tenantB", prompt, max_new_tokens=4)
    np.testing.assert_array_equal(r1.output, r2.output)
    assert r2.cached_tokens == 16 and r2.new_tokens == 4


def test_live_engine_needs_a_card_by_default(monkeypatch):
    cfg = get_config("qwen3-1.7b").reduced()
    m = make_model(cfg)
    p = m.init(torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, [TenantSpec("A", 1e6)], EngineConfig(pool_blocks=64), model=m, params=p)


def test_greedy_decode_shape_and_ties():
    logits = torch.tensor([[[0.0, 2.0, 2.0, 1.0]]])       # a tie: the first maximum wins
    assert int(sample_token(logits[:, 0])[0]) == int(jsample_token(jnp.asarray(logits[:, 0]))[0]) == 1

    class Fixed:                                           # decode always favours token 3
        def decode_step(self, params, tokens, caches, position):
            return torch.tensor([[[0.0, 0.0, 0.0, 1.0]]]).expand(tokens.shape[0], 1, 4), caches

    out = greedy_decode(Fixed(), None, logits.expand(2, 1, 4), None, start_pos=5, n_steps=3)
    assert out.dtype == torch.int32 and out.tolist() == [[1, 3, 3], [1, 3, 3]]


def test_sample_token_distribution():
    """softmax(logits / T) over the top k, for both packages: frequencies
    of 20000 draws within 0.015 (about 4.5 standard errors) of it."""
    logits = np.array([1.0, 0.2, -0.5, 2.0, 0.9, -3.0], np.float32)
    temp, k, n = 0.7, 3, 20000
    top = np.argsort(logits)[-k:]
    want = np.zeros_like(logits)
    want[top] = np.exp(logits[top] / temp) / np.exp(logits[top] / temp).sum()
    batch = np.broadcast_to(logits, (n, logits.size))
    got = sample_token(torch.from_numpy(batch.copy()), torch.Generator().manual_seed(0),
                       temperature=temp, top_k=k)
    ref = jsample_token(jnp.asarray(batch), jax.random.PRNGKey(0), temperature=temp, top_k=k)
    assert got.dtype == torch.int32 and got.shape == (n,)
    for draws in (got.numpy(), np.asarray(ref)):
        freq = np.bincount(draws, minlength=logits.size) / n
        np.testing.assert_allclose(freq, want, atol=0.015)
        assert freq[np.setdiff1d(np.arange(logits.size), top)].sum() == 0
    with pytest.raises(ValueError, match="Generator"):
        sample_token(torch.from_numpy(batch.copy()), temperature=temp)
