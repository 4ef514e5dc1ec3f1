"""The port's models against the reference's, on the CPU.

Reduced configs: qwen3-1.7b with ``n_kv_heads=2`` (G = 2, qk-norm, tied
embeddings), stablelm-1.6b (MHA, untied head), granite-moe-1b (MoE, E = 8
top-2, global attention through K3's plain version) and recurrentgemma-2b
(tiles of ``(rglru, rglru, local)``, MQA, window 32); recurrentgemma also
with a tail of two RG-LRU blocks and with prompts longer than its window;
deepseek-v2-236b (MLA: the expanded prefill through K3's plain version,
the absorbed decode over the latent cache; MoE with shared experts),
xlstm-125m (tiles of five mLSTM blocks and an sLSTM) and
llava-next-mistral-7b's text path (GQA G = 4; its image path is in
tests/test_torch_frontends.py); hubert-xlarge's parameter tree (its
encoder in that file too).
The reference's parameters are carried across with ``from_jax_params``;
inputs are numpy arrays from a seed. In f32 both packages do the same
arithmetic with sums in another order (the port's prefill attention is
the dense plain version of K3, the reference's a chunked scan; the port's
RG-LRU scan a doubling scan), so logits of scale ~4 and every cache are
held to atol 1e-4 (observed below 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import make_model as jmake_model
from repro_torch.configs import get_config
from repro_torch.models import attention, from_jax_params, layers, make_model
from repro_torch.models.convert import param_shapes
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ARCHS = {"qwen3-1.7b": {"n_kv_heads": 2}, "stablelm-1.6b": {}, "granite-moe-1b-a400m": {},
         "recurrentgemma-2b": {}, "deepseek-v2-236b": {}, "xlstm-125m": {},
         "llava-next-mistral-7b": {}}
TREES = list(ARCHS) + ["hubert-xlarge"]     # the encoder: its tree here, the rest elsewhere
F32_ATOL = 1e-4
B, T = 2, 24


def _cfgs(name, **extra):
    kw = dict(ARCHS.get(name, {}), **extra)
    return (dataclasses.replace(jget_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def _models(name, dtype="float32", **extra):
    """(reference model, its params, port model, port params)."""
    jcfg, cfg = _cfgs(name, **extra)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = jmake_model(jcfg, param_dtype=jdt, compute_dtype=jdt)
    jp = jm.init(jax.random.PRNGKey(0))
    m = make_model(cfg, param_dtype=tdt, compute_dtype=tdt)
    return jm, jp, m, from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _tokens(cfg, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, T))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _same_tree(got, want, atol):
    """Two cache trees (port: tensors; reference: arrays) of one structure,
    shapes equal, values within atol."""
    got = jax.tree.map(_np, got)
    want = jax.tree.map(_np, want)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol)


# -- layers -------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.array([[0, 1, 2, 7, 100]] * 2, np.int32)
    np.testing.assert_allclose(
        _np(layers.rmsnorm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)}, 1e-6)),
        _np(jlayers.rmsnorm(jnp.asarray(x), {"scale": jnp.asarray(scale)}, 1e-6)), atol=1e-6)
    np.testing.assert_allclose(
        _np(layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)),
        _np(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)), atol=2e-5)
    w = {n: rng.standard_normal(s).astype(np.float32) / 4
         for n, s in (("w_gate", (16, 32)), ("w_up", (16, 32)), ("w_down", (32, 16)))}
    h = rng.standard_normal((3, 16)).astype(np.float32)
    # a bf16 activation against f32 weights: both promote the product to f32
    got = layers.mlp_apply(torch.from_numpy(h).bfloat16(), {n: torch.from_numpy(a) for n, a in w.items()})
    want = jlayers.mlp_apply(jnp.asarray(h).astype(jnp.bfloat16), {n: jnp.asarray(a) for n, a in w.items()})
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)


def test_initializers_follow_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = layers.dense_init(gen, 256, 512)
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2.0 / 16 + 1e-7          # truncated at +-2 sigma
    # std of N(0, 1) truncated at +-2 is 0.8796; 131072 draws: +-1%
    assert abs(float(w.std()) * 16 / 0.8796 - 1) < 0.01
    e = layers.embed_init(gen, 1000, 64, torch.bfloat16)
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) * 8 - 1) < 0.02


@pytest.mark.parametrize("causal,window,q_offset,valid", [
    (True, 0, 0, None),
    (True, 8, 0, None),                 # local window
    (False, 0, 0, [40, 13]),            # decode-style valid lengths
    (True, 0, 5, [40, 30]),             # offset queries
])
def test_chunked_attention_matches_reference(causal, window, q_offset, valid):
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 12, 4, 16), (2, 40, 2, 16), (2, 40, 2, 16)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, kv_chunk=16)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw,
                                   kv_valid_len=None if valid is None else jnp.asarray(valid))
    got = attention.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw,
                                      kv_valid_len=None if valid is None else torch.tensor(valid))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("window", [0, 4])
def test_gqa_prefill_and_decode_match_the_reference(window):
    """bf16 activations through f32 weights: q/k/v, the attention output
    and the cache are f32 in both packages, with the same values; then
    decode steps on that cache (a ring buffer when windowed)."""
    jcfg, cfg = _cfgs("qwen3-1.7b")
    jp = jattn.gqa_init(jax.random.PRNGKey(1), jcfg)
    p = {n: ({k: torch.from_numpy(np.array(a)) for k, a in v.items()} if isinstance(v, dict)
             else torch.from_numpy(np.array(v))) for n, v in jp.items()}
    x = np.random.default_rng(2).standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    jout, jc = jattn.gqa_prefill(jnp.asarray(x[:, :10]).astype(jnp.bfloat16), jp, jcfg, 13,
                                 window=window)
    out, c = attention.gqa_prefill(torch.from_numpy(x[:, :10]).bfloat16(), p, cfg, 13,
                                   window=window)
    assert out.dtype == c["k"].dtype == torch.float32 and jc["k"].dtype == jnp.float32
    np.testing.assert_allclose(_np(out), _np(jout), atol=1e-5)
    np.testing.assert_allclose(_np(c["k"]), _np(jc["k"]), atol=1e-5)
    np.testing.assert_allclose(_np(c["v"]), _np(jc["v"]), atol=1e-5)
    if window:      # the ring-buffer alignment is the transformer's (tested below): start empty
        jc = {n: jnp.zeros_like(a) for n, a in jc.items()}
        c = {n: torch.zeros_like(a) for n, a in c.items()}
    for t in range(10, 13):
        pos = np.full(2, t, np.int32)
        jd, jc = jattn.gqa_decode_step(jnp.asarray(x[:, t:t + 1]), jp, jcfg, jc,
                                       jnp.asarray(pos), window=window)
        d, c = attention.gqa_decode_step(torch.from_numpy(x[:, t:t + 1].copy()), p, cfg, c,
                                         torch.from_numpy(pos), window=window)
        np.testing.assert_allclose(_np(d), _np(jd), atol=1e-5)
        np.testing.assert_allclose(_np(c["k"]), _np(jc["k"]), atol=1e-5)


# -- the model --------------------------------------------------------------

@pytest.mark.parametrize("name", TREES)
def test_param_tree_matches_reference_init(name):
    jcfg, cfg = _cfgs(name)
    jtree = jax.eval_shape(jmake_model(jcfg).init, jax.random.PRNGKey(0))
    shapes = jax.tree.map(lambda a: tuple(a.shape), jtree)
    assert shapes == param_shapes(cfg)
    port = make_model(cfg).init(torch.Generator().manual_seed(0))
    assert jax.tree.map(lambda a: tuple(a.shape), port) == shapes


def _forward_prefill_decode(name, T_, **extra):
    """forward, the zeroed caches, prefill of T_ - 1 tokens and a decode
    step, each against the reference in f32."""
    jm, jp, m, p = _models(name, **extra)
    toks = np.random.default_rng(0).integers(0, m.cfg.vocab_size, (B, T_))
    full_j = jm.forward_logits(jp, {"tokens": jnp.asarray(toks)})
    full = m.forward_logits(p, {"tokens": torch.as_tensor(toks)})
    assert full.shape == (B, T_, m.cfg.vocab_size)
    np.testing.assert_allclose(_np(full), _np(full_j), atol=F32_ATOL)

    zeros, jzeros = m.init_cache(B, T_ + 8, device="cpu"), jm.init_cache(B, T_ + 8)
    _same_tree(zeros, jzeros, 0.0)
    # zeros, but for the xLSTM blocks' stabilizers m, which start at -1e30
    assert all(t.dtype == torch.float32 and (not t.any() or bool((t == -1e30).all()))
               for t in jax.tree.leaves(zeros))

    jlast, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :-1])}, T_ + 8)
    last, c = m.prefill(p, {"tokens": torch.as_tensor(toks[:, :-1])}, T_ + 8)
    assert last.shape == (B, 1, m.cfg.vocab_size)
    np.testing.assert_allclose(_np(last), _np(jlast), atol=F32_ATOL)
    _same_tree(c, jc, F32_ATOL)

    pos = np.full(B, T_ - 1, np.int32)
    jd, jc = jm.decode_step(jp, jnp.asarray(toks[:, -1:]), jc, jnp.asarray(pos))
    d, c = m.decode_step(p, torch.as_tensor(toks[:, -1:]), c, torch.as_tensor(pos))
    np.testing.assert_allclose(_np(d), _np(jd), atol=F32_ATOL)
    _same_tree(c, jc, F32_ATOL)
    return m


@pytest.mark.parametrize("name", ARCHS)
def test_forward_prefill_decode_match_reference_f32(name):
    _forward_prefill_decode(name, T)


@pytest.mark.parametrize("case,T_,extra", [
    ("tail", T, dict(n_layers=8)),             # 2 tiles of 3 blocks and a tail of 2
    ("past-window", 44, dict(n_layers=8)),     # prompt 43 > window 32: roll, decode wraps
])
def test_recurrentgemma_tail_and_ring_buffer_match_reference(case, T_, extra):
    m = _forward_prefill_decode("recurrentgemma-2b", T_, **extra)
    assert m.n_tiles == 2 and m.tail_kinds == ("rglru", "rglru")
    if case == "past-window":
        assert T_ - 1 > m.cfg.window
        _, c = m.prefill(m.init(torch.Generator().manual_seed(0)),
                         {"tokens": torch.zeros((1, T_), dtype=torch.long)}, T_ + 8)
        assert c["blocks"]["g2"]["k"].shape[2] == m.cfg.window     # the ring buffer


@pytest.mark.parametrize("name", ARCHS)
def test_decode_consistency(name):
    """prefill(T-1) + decode(token T-1) == forward logits at T-1, within
    3e-3 of the logits' scale (tests/test_models.py's check, MoE drop-free
    as there)."""
    extra = {}
    if get_config(name).moe:        # drop-free: the capacity grows with the tokens
        extra["capacity_factor"] = float(get_config(name).reduced().n_experts)
    _, _, m, p = _models(name, **extra)
    toks = torch.as_tensor(_tokens(m.cfg, seed=3))
    full = m.forward_logits(p, {"tokens": toks})
    last, caches = m.prefill(p, {"tokens": toks[:, : T - 1]}, cache_len=T + 8)
    lg, _ = m.decode_step(p, toks[:, T - 1:], caches, torch.full((B,), T - 1))
    scale = float(full[:, T - 1].abs().max()) + 1e-6
    assert float((last[:, 0] - full[:, T - 2]).abs().max()) < 3e-3 * max(scale, 1)
    assert float((lg[:, 0] - full[:, T - 1]).abs().max()) < 3e-3 * max(scale, 1)


@pytest.mark.parametrize("name", [n for n in ARCHS if n != "xlstm-125m"])
def test_bf16_model_matches_reference(name):
    """bf16 parameters and compute, as on the card. Both round every
    product to bf16 (relative spacing 2^-8), at different points, so the
    logits agree to a few of those steps of their scale: 3% (observed ~1%)."""
    jm, jp, m, p = _models(name, "bfloat16")
    toks = _tokens(m.cfg, seed=4)
    jlast, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, T + 4)
    last, c = m.prefill(p, {"tokens": torch.as_tensor(toks)}, T + 4)
    block = c["blocks"]["g2" if "g2" in c["blocks"] else "g0"]
    attn_cache = block.get("k", block.get("c_kv", block.get("conv")))   # GQA, MLA, mLSTM
    assert last.dtype == attn_cache.dtype == torch.bfloat16
    scale = float(np.abs(_np(jlast)).max())
    np.testing.assert_allclose(_np(last), _np(jlast), atol=0.03 * scale)


def test_bf16_xlstm_matches_reference_block_by_block():
    """xlstm in bf16: each block, from the same input, within 3% of its
    output's scale (observed 0.4-1.7%: the two packages' bf16 products
    differ by a step in a few elements, the conv and the gates carry
    that on). The whole model is not compared: 12 blocks carry those
    steps down the residual stream through exponential gates (11% of the
    logits' scale at the reduced width; in f32 the models agree to 1e-4,
    test_forward_prefill_decode_match_reference_f32)."""
    from repro.models import layers as jl
    from repro.models import xlstm as jx
    from repro_torch.models import xlstm

    jm, jp, m, p = _models("xlstm-125m", "bfloat16")
    x = np.random.default_rng(4).standard_normal((B, T, m.cfg.d_model)).astype(np.float32)
    for g, kind in enumerate(m.cfg.block_pattern):
        jb = jax.tree.map(lambda a: a[0], jp["blocks"][f"g{g}"])
        tb = jax.tree.map(lambda a: a[0], p["blocks"][f"g{g}"])
        jh = jl.rmsnorm(jnp.asarray(x).astype(jnp.bfloat16), jb["ln1"], m.cfg.norm_eps)
        th = layers.rmsnorm(torch.from_numpy(x).bfloat16(), tb["ln1"], m.cfg.norm_eps)
        np.testing.assert_array_equal(_np(th), _np(jh))
        fwd = {"mlstm": (jx.mlstm_block_forward, xlstm.mlstm_block_forward),
               "slstm": (jx.slstm_block_forward, xlstm.slstm_block_forward)}[kind]
        want = _np(fwd[0](jh, jb["core"], jm.cfg))
        got = fwd[1](th, tb["core"], m.cfg)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), want, atol=0.03 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "xlstm-125m", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
def test_unported_architectures_raise(name):
    """The four models that raised until MLA, xLSTM and the frontends were
    ported build now; a block kind, an attention or a modality that no
    model has still raises."""
    cfg = get_config(name).reduced()
    assert make_model(cfg).n_tiles == 2
    for bad in (dict(block_pattern=("mamba",)), dict(attention="linear"),
                dict(modality="video")):
        with pytest.raises(NotImplementedError, match="not a part of the models"):
            make_model(dataclasses.replace(cfg, **bad))


def test_from_jax_params_checks_the_tree():
    jm, jp, m, _ = _models("qwen3-1.7b", "bfloat16")
    tree = jax.tree.map(np.asarray, jp)
    p = from_jax_params(tree, m.cfg, device="cpu")
    wq = p["blocks"]["g0"]["attn"]["wq"]
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.view(torch.int16).numpy(),
                                  tree["blocks"]["g0"]["attn"]["wq"].view(np.int16))
    bad = dict(tree, lm_head=tree["embed"].T)
    with pytest.raises(ValueError, match="expected keys"):
        from_jax_params(bad, m.cfg, device="cpu")
    bad = dict(tree, embed=tree["embed"][:10])
    with pytest.raises(ValueError, match="embed: expected shape"):
        from_jax_params(bad, m.cfg, device="cpu")
    jm, jp, m, _ = _models("recurrentgemma-2b", n_layers=8)
    tree = jax.tree.map(np.asarray, jp)
    p = from_jax_params(tree, m.cfg, device="cpu")
    assert len(p["tail"]) == 2 and p["blocks"]["g0"]["core"]["log_lambda"].dtype == torch.float32
    with pytest.raises(ValueError, match="tail: expected a list of 2 blocks"):
        from_jax_params(dict(tree, tail=tree["tail"][:1]), m.cfg, device="cpu")
