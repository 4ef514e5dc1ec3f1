"""The port's training attention and loss against the reference's, on the CPU.

* ``ops.flash_attention`` under autograd (the ``FlashAttention`` function:
  K3's plain forward with its lse and ``flash_attention_bwd_plain``, the
  plain version of K3-bwd) against ``jax.grad`` of the reference's
  ``chunked_attention(..., kv_chunk=8)``, whose custom VJP is the
  memory-safe backward K3-bwd ports: the shapes of
  ``tests/test_kernels.py``'s gradient test (B=2, T=32, H=4, KV=2, D=16,
  padded to 64 by the op) and G = 1, 2 and 4, causal and not, T not a
  multiple of the chunk, MLA's 192/128 and hubert's 80 (padded to 256 and
  128), and the windowed ``chunked_attention`` (window 16, ``FlashGrouped``).
  Both sides in f32: atol 2e-4, that test's bound.
* ``TransformerLM.loss`` against the reference's ``model.loss`` for every
  config at reduced size, f32/f32, the reference's parameters carried
  across with ``from_jax_params``; and the parameters' gradients against
  ``jax.grad`` for qwen3 (G = 2), granite-moe-1b (the aux term),
  recurrentgemma-2b (the windowed VJP) and deepseek-v2 (padded MLA).

The cases marked ``cuda`` (the kernels on the card) are in
``tests/test_torch_flash_grad_cuda.py``, which imports no JAX.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_archs
from repro.models import attention as jattn
from repro.models import make_model as jmake_model
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ops
from repro_torch.models import attention, from_jax_params, make_model
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ATOL = 2e-4

GRID = [  # B, T, H, KV, Dqk, Dv, causal
    (2, 32, 4, 2, 16, 16, True),       # tests/test_kernels.py's gradient test
    (2, 32, 4, 2, 16, 16, False),
    (2, 32, 4, 4, 16, 16, True),       # G = 1
    (1, 30, 4, 1, 16, 16, True),       # G = 4, T not a multiple of the chunk
    (1, 30, 4, 1, 16, 16, False),
    (1, 24, 2, 2, 192, 128, True),     # MLA's widths, padded to 256
    (2, 20, 2, 2, 80, 80, False),      # hubert's, padded to 128
    (1, 20, 4, 2, 64, 64, True),       # a width the kernel takes as it is
]


def _arrays(seed, B, T, H, KV, Dqk, Dv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H, Dqk), (B, T, KV, Dqk), (B, T, KV, Dv))]


def _jax_grads(arrays, **kw):
    def f(q, k, v):
        return (jattn.chunked_attention(q, k, v, kv_chunk=8, **kw) ** 2).sum()

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))]


def _torch_grads(fn, arrays):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    (fn(*ts) ** 2).sum().backward()
    return [t.grad.numpy() for t in ts]


@pytest.mark.parametrize("B,T,H,KV,Dqk,Dv,causal", GRID)
def test_flash_attention_grads_match_reference_vjp(B, T, H, KV, Dqk, Dv, causal):
    arrays = _arrays(0, B, T, H, KV, Dqk, Dv)
    want = _jax_grads(arrays, causal=causal)
    before = k3.flash_attention.launches
    got = _torch_grads(lambda q, k, v: ops.flash_attention(q, k, v, causal=causal), arrays)
    assert k3.flash_attention.launches == before        # the CPU never launches
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("T,causal", [(40, True), (37, True)])
def test_windowed_attention_grads_match_reference_vjp(T, causal):
    """recurrentgemma's local blocks: ``FlashGrouped`` (window 16), with S
    a multiple of the chunk (the reference's custom VJP) and not (its
    plain AD through the padded scan): the same gradient."""
    arrays = _arrays(1, 2, T, 4, 1, 16, 16)
    want = _jax_grads(arrays, causal=causal, window=16)
    got = _torch_grads(lambda q, k, v: attention.chunked_attention(
        q, k, v, causal=causal, window=16, kv_chunk=8), arrays)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, atol=ATOL, err_msg=f"d{name}")


def test_grad_mode_picks_the_autograd_function(monkeypatch):
    """Under autograd the op runs the forward with its lse and the plain
    backward; without it (serving, or no input requiring grad) the forward
    alone, without the lse."""
    calls = []
    for name in ("flash_attention_plain", "flash_attention_fwd_plain",
                 "flash_attention_bwd_plain"):
        real = getattr(k3, name)
        monkeypatch.setattr(k3, name, lambda *a, _r=real, _n=name, **kw: calls.append(_n)
                            or _r(*a, **kw))
    q, k, v = (torch.from_numpy(a) for a in _arrays(2, 1, 16, 4, 2, 64, 64))
    ops.flash_attention(q, k, v)
    with torch.no_grad():
        ops.flash_attention(q.requires_grad_(), k, v)
    assert calls == ["flash_attention_plain"] * 2
    calls.clear()
    ops.flash_attention(q, k, v).sum().backward()
    assert calls == ["flash_attention_fwd_plain", "flash_attention_bwd_plain"]


def test_plain_lse_is_the_log_sum_exp_of_the_scores():
    q, k, v = (torch.from_numpy(a) for a in _arrays(3, 2, 12, 4, 2, 16, 16))
    out, lse = k3.flash_attention_fwd_plain(q, k, v, causal=True)
    assert lse.shape == (2, 4, 12) and lse.dtype == torch.float32
    s = torch.einsum("bthd,bshd->bhts", q, k.repeat_interleave(2, dim=2)) / 4.0
    s = s.masked_fill(torch.ones(12, 12, dtype=torch.bool).triu(1), float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-5, rtol=0)
    torch.testing.assert_close(out, k3.flash_attention_plain(q, k, v), atol=0, rtol=0)
    # no key: out 0, lse -1e30 (the kernel's m + log(max(l, 1e-30)))
    out0, lse0 = k3.flash_attention_fwd_plain(q, k[:, :0], v[:, :0], causal=False)
    assert float(out0.abs().max()) == 0.0 and float(lse0.max()) == float(np.float32(-1e30))


# -- the model's loss and its gradients ---------------------------------------

KW = {"qwen3-1.7b": {"n_kv_heads": 2}}
B, T = 2, 24


def _models(name, **changes):
    changes = {**KW.get(name, {}), **changes}
    jcfg = dataclasses.replace(jget_config(name).reduced(), **changes)
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    jm = jmake_model(jcfg, param_dtype=jnp.float32, compute_dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0))
    m = make_model(cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    return jcfg, jm, jp, m, from_jax_params(jax.tree.map(np.asarray, jp), cfg, device="cpu")


def _batch(cfg, seed=0, batch_size=B, seq=T):
    """Numpy arrays: tokens (or an audio model's frames), labels and a
    mask with some positions off; a vision model's image embeddings."""
    B, T = batch_size, seq
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32),
         "mask": rng.random((B, T)) < 0.8}
    if cfg.modality == "audio":
        b["frames"] = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    if cfg.modality == "vision_text":
        b["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)
    return b


@pytest.mark.parametrize("name", list_archs())
def test_loss_matches_reference(name):
    jcfg, jm, jp, m, p = _models(name)
    batch = _batch(jcfg)
    want, wmet = jm.loss(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, met = m.loss(p, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), atol=1e-4)
    np.testing.assert_allclose(float(met["ce"]), float(wmet["ce"]), atol=1e-4)
    np.testing.assert_allclose(float(met["aux"]), float(wmet["aux"]), atol=1e-4)


def _leaves_with_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("name", ["qwen3-1.7b", "granite-moe-1b-a400m", "recurrentgemma-2b",
                                  "deepseek-v2-236b", "xlstm-125m", "hubert-xlarge",
                                  "llava-next-mistral-7b"])
@pytest.mark.parametrize("remat", [False, True])
def test_parameter_grads_match_reference(name, remat):
    """Every parameter's gradient of the loss (f32) against ``jax.grad``:
    atol 2e-4 on gradients scaled to their largest magnitude (1 or more);
    recomputing each tile (``remat``) changes no number. xlstm-125m runs
    its sLSTM's time loop and, at T = 24, the quadratic mLSTM; hubert-xlarge
    its audio frontend and non-causal encoder; llava its projector's image
    tokens before the text."""
    _hold_grads(name, remat, B, T)


@pytest.mark.parametrize("remat", [False, True])
def test_xlstm_chunkwise_grads_match_reference(remat):
    """xlstm-125m at T = 512 (B = 1), a length at which both sides' mLSTM
    takes its chunkwise form (two chunks of 256, the scaled state carried
    between them) and the sLSTM loops 512 steps: every parameter's
    gradient as above, on one tile of the pattern (five mLSTM layers and
    the sLSTM). Over both tiles the two f32 sides part by up to 2.2e-4 on
    the embedding, each about 1e-4 from a float64 run of the port
    (``scripts/xlstm_grad_rounding.py``): the exponential gates amplify
    f32 rounding with depth, where one tile keeps it near 2e-5."""
    _hold_grads("xlstm-125m", remat, 1, 512, n_layers=6)


def _hold_grads(name, remat, batch_size, seq, **changes):
    jcfg, jm, jp, m, p = _models(name, **changes)
    m.remat = remat
    batch = _batch(jcfg, seed=1, batch_size=batch_size, seq=seq)
    jgrads = jax.grad(lambda q: jm.loss(q, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    tp = jax.tree.map(lambda t: t, p)
    flat = list(_leaves_with_paths(tp))
    inputs = [t.detach().requires_grad_() for _, t in flat]
    it = iter(inputs)
    tree = jax.tree.map(lambda t: next(it), tp)
    loss, _ = m.loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    want = dict(_leaves_with_paths(jax.tree.map(np.asarray, jgrads)))
    assert set(want) == {path for path, _ in flat}
    for (path, t), g in zip(flat, grads):
        g = np.zeros(t.shape, np.float32) if g is None else g.numpy()
        w = want[path]
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g / scale, w / scale, atol=ATOL, err_msg=path)
