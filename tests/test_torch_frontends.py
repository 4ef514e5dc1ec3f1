"""The vision and audio frontends and the encoder against the reference on
the CPU.

Reduced configs: llava-next-mistral-7b (vision_dim 32, 8 image tokens
first, GQA) and hubert-xlarge (encoder-only, 2 layers, conv positional
embedding of kernel 128 over precomputed frames, masked frames), with the
reference's parameters carried across and f32 compute; inputs are numpy
arrays from a seed. The embeddings agree within 1e-5 (the same products
in another order) and the logits of scale ~4 within 1e-4 (observed below
1e-5), as in tests/test_torch_models.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import make_model as jmake_model
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import from_jax_params, make_model
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ATOL = 1e-4
B, T = 2, 24


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _models(name, **extra):
    jcfg = dataclasses.replace(jget_config(name).reduced(), **extra)
    cfg = dataclasses.replace(get_config(name).reduced(), **extra)
    jm = jmake_model(jcfg, param_dtype=jnp.float32, compute_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    m = make_model(cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    return jm, jp, m, from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _audio(cfg, seed=0, T_=T, masked=True):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, T_, cfg.d_model)).astype(np.float32)
    batch = {"frames": frames}
    if masked:
        batch["mask"] = rng.random((B, T_)) < 0.3
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def _image(cfg, seed=1, T_=T):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, T_))
    img = rng.standard_normal((B, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "image_embeds": jnp.asarray(img)},
            {"tokens": torch.from_numpy(tokens), "image_embeds": torch.from_numpy(img)})


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T_", [24, 200])
def test_audio_embed_matches_reference(masked, T_):
    """The frame projection, the mask (frames replaced by mask_embed before
    the conv) and the conv positional embedding (kernel 128 padded (64,
    63), depthwise cross-correlation, tanh gelu); T=200 is longer than
    the kernel."""
    jm, jp, m, p = _models("hubert-xlarge")
    jb, tb = _audio(m.cfg, seed=2, T_=T_, masked=masked)
    want = jm._embed(jp, jb)
    got = m._embed(p, tb)
    assert got.shape == (B, T_, m.cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5)
    if masked:          # a masked frame's embedding does not depend on its frame
        jb2 = dict(jb, frames=jb["frames"] + 10.0 * jb["mask"][..., None])
        tb2 = dict(tb, frames=tb["frames"] + 10.0 * tb["mask"][..., None])
        np.testing.assert_allclose(_np(m._embed(p, tb2)), _np(got), atol=1e-5)
        np.testing.assert_allclose(_np(jm._embed(jp, jb2)), _np(want), atol=1e-5)


def test_encoder_forward_matches_reference_and_runs_k3_bidirectional(monkeypatch):
    """hubert's forward_logits: every layer's attention reaches the K3 op
    once, non-causal (the encoder), at the head size 16."""
    jm, jp, m, p = _models("hubert-xlarge")
    jb, tb = _audio(m.cfg, seed=3)
    want = jm.forward_logits(jp, jb)
    seen = []
    op = ops.flash_attention

    def record(q, k, v, *, causal=True, window=0):
        seen.append((q.shape[-1], causal))
        return op(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(ops, "flash_attention", record)
    got = m.forward_logits(p, tb)
    assert got.shape == (B, T, m.cfg.vocab_size)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    assert seen == [(m.cfg.head_dim, False)] * m.cfg.n_layers
    # bidirectional: the first frame's logits see the last frame
    tb2 = dict(tb, frames=tb["frames"].clone())
    tb2["frames"][:, -1] += 1.0
    assert not torch.allclose(m.forward_logits(p, tb2)[:, 0], got[:, 0])


def test_encoder_has_no_decode_step():
    _, _, m, p = _models("hubert-xlarge")
    with pytest.raises(ValueError, match="encoder-only"):
        m.decode_step(p, torch.zeros((1, 1), dtype=torch.long), {}, torch.zeros(1))


def test_projector_embed_matches_reference():
    """The two-layer projector (tanh gelu between), image tokens first;
    a batch without image_embeds embeds its tokens alone."""
    jm, jp, m, p = _models("llava-next-mistral-7b")
    jb, tb = _image(m.cfg)
    got = m._embed(p, tb)
    assert got.shape == (B, m.cfg.n_image_tokens + T, m.cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(jm._embed(jp, jb)), atol=1e-5)
    np.testing.assert_array_equal(_np(got[:, m.cfg.n_image_tokens:]),
                                  _np(m._embed(p, {"tokens": tb["tokens"]})))


def test_vision_prefill_with_image_then_decode_matches_reference():
    """llava: prefill of the image tokens and T-1 text tokens, then one
    decode step at position n_image_tokens + T - 1 (the image offset),
    held to the reference and to the forward over the whole sequence."""
    jm, jp, m, p = _models("llava-next-mistral-7b")
    jb, tb = _image(m.cfg, seed=4)
    n_img = m.cfg.n_image_tokens
    full = m.forward_logits(p, tb)
    np.testing.assert_allclose(_np(full), _np(jm.forward_logits(jp, jb)), atol=ATOL)

    jpre = dict(jb, tokens=jb["tokens"][:, :-1])
    tpre = dict(tb, tokens=tb["tokens"][:, :-1])
    jlast, jc = jm.prefill(jp, jpre, n_img + T + 4)
    last, c = m.prefill(p, tpre, n_img + T + 4)
    np.testing.assert_allclose(_np(last), _np(jlast), atol=ATOL)
    assert c["blocks"]["g0"]["k"].shape[2] == n_img + T + 4
    pos = np.full(B, n_img + T - 1, np.int32)
    jd, _ = jm.decode_step(jp, jb["tokens"][:, -1:], jc, jnp.asarray(pos))
    d, _ = m.decode_step(p, tb["tokens"][:, -1:], c, torch.from_numpy(pos))
    np.testing.assert_allclose(_np(d), _np(jd), atol=ATOL)
    np.testing.assert_allclose(_np(d[:, 0]), _np(full[:, -1]), atol=ATOL)
