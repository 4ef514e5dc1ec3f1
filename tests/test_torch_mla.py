"""MLA (deepseek-v2-236b's attention) and the padded K3 op, against the
reference on the CPU.

The reduced deepseek-v2 config (H=4, q_lora 32, latent 16, rope 8, nope
16, v 16: D_qk = 24, D_v = 16) with the reference's parameters carried
across; inputs are numpy arrays from a seed. In f32 both packages do the
same arithmetic with sums in another order (the port's expanded form runs
K3's dense plain version, the reference a chunked scan), so outputs and
caches of scale ~1 are held to atol 1e-5 (observed below 2e-6).

``ops.flash_attention`` pads head sizes the kernel is not built for with
zero columns; on the CPU the padded plain version must equal the unpadded
one exactly in f32 and bf16 (a zero column adds an exact zero).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as k3_module
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain, kernel_head_dim
from repro_torch.models import attention
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ATOL = 1e-5
NAME = "deepseek-v2-236b"


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _layer(seed=1):
    """(reference config, its MLA params, port config, the same params)."""
    jcfg, cfg = jget_config(NAME).reduced(), get_config(NAME).reduced()
    jp = jattn.mla_init(jax.random.PRNGKey(seed), jcfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, jp, cfg, p


def _x(cfg, B=2, T=13, seed=2):
    return np.random.default_rng(seed).standard_normal((B, T, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("causal", [True, False])
def test_mla_forward_matches_reference(causal):
    jcfg, jp, cfg, p = _layer()
    x = _x(cfg)
    want = jattn.mla_forward(jnp.asarray(x), jp, jcfg, causal=causal)
    got = attention.mla_forward(torch.from_numpy(x), p, cfg, causal=causal)
    assert got.shape == (2, 13, cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


def test_mla_prefill_and_decode_steps_match_reference():
    """The latent cache of a prefill of 10 tokens padded to 13 rows, then
    three absorbed decode steps, each writing its row in place."""
    jcfg, jp, cfg, p = _layer()
    x = _x(cfg)
    jout, jc = jattn.mla_prefill(jnp.asarray(x[:, :10]), jp, jcfg, 13)
    out, c = attention.mla_prefill(torch.from_numpy(x[:, :10].copy()), p, cfg, 13)
    assert c["c_kv"].shape == (2, 13, cfg.kv_lora_rank)
    assert c["k_rope"].shape == (2, 13, cfg.qk_rope_head_dim)
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL)
    for n in ("c_kv", "k_rope"):
        np.testing.assert_allclose(_np(c[n]), _np(jc[n]), atol=ATOL)
    for t in range(10, 13):
        pos = np.full(2, t, np.int32)
        jd, jc = jattn.mla_decode_step(jnp.asarray(x[:, t:t + 1]), jp, jcfg, jc, jnp.asarray(pos))
        cache = c
        d, c = attention.mla_decode_step(torch.from_numpy(x[:, t:t + 1].copy()), p, cfg, c,
                                         torch.from_numpy(pos))
        assert c["c_kv"] is cache["c_kv"]                       # written in place
        np.testing.assert_allclose(_np(d), _np(jd), atol=ATOL)
        for n in ("c_kv", "k_rope"):
            np.testing.assert_allclose(_np(c[n]), _np(jc[n]), atol=ATOL)


def test_absorbed_decode_matches_the_expanded_forward():
    """Decode in the latent space (W_uk absorbed into the query, W_uv
    applied after) gives the expanded form's output at each position,
    with positions of the two rows apart."""
    _, _, cfg, p = _layer(seed=3)
    x = torch.from_numpy(_x(cfg, T=12, seed=4))
    full = attention.mla_forward(x, p, cfg)
    _, c = attention.mla_prefill(x[:, :8], p, cfg, 12)
    for t in range(8, 12):
        d, c = attention.mla_decode_step(x[:, t:t + 1], p, cfg, c, torch.full((2,), t))
        np.testing.assert_allclose(_np(d[:, 0]), _np(full[:, t]), atol=ATOL)
    # rows at different positions: row 1 is one token behind
    _, c = attention.mla_prefill(x[:, :8], p, cfg, 12)
    pos = torch.tensor([8, 7])
    d, _ = attention.mla_decode_step(torch.stack([x[0, 8:9], x[1, 7:8]]), p, cfg, c, pos)
    np.testing.assert_allclose(_np(d[0, 0]), _np(full[0, 8]), atol=ATOL)
    np.testing.assert_allclose(_np(d[1, 0]), _np(full[1, 7]), atol=ATOL)


def test_mla_bf16_matches_reference():
    """bf16 parameters and activations, as on the card: both round each
    product to bf16 (relative step 2^-8) at different points; outputs of
    scale ~1 agree within 3% of it (observed ~1%)."""
    jcfg, cfg = jget_config(NAME).reduced(), get_config(NAME).reduced()
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jattn.mla_init(jax.random.PRNGKey(5), jcfg))
    p = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16(), jp)
    x = _x(cfg, seed=6)
    want, jc = jattn.mla_prefill(jnp.asarray(x).astype(jnp.bfloat16), jp, jcfg, 16)
    got, c = attention.mla_prefill(torch.from_numpy(x).bfloat16(), p, cfg, 16)
    assert got.dtype == c["c_kv"].dtype == torch.bfloat16
    scale = float(np.abs(_np(want)).max())
    np.testing.assert_allclose(_np(got), _np(want), atol=0.03 * scale)


# -- the padded K3 op ----------------------------------------------------------

PADDED = [   # B, T, S, H, KV, D_qk, D_v, causal
    (2, 40, 40, 4, 4, 24, 16, True),       # the reduced MLA: 24/16 -> 64
    (1, 64, 64, 8, 8, 192, 128, True),     # deepseek-v2's MLA: 192/128 -> 256
    (1, 50, 50, 4, 4, 80, 80, False),      # hubert-xlarge's encoder: 80 -> 128
    (2, 40, 40, 4, 2, 80, 80, True),       # D=80 with GQA, causal
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,KV,Dqk,Dv,causal", PADDED)
def test_padded_flash_attention_equals_the_unpadded_function(monkeypatch, B, T, S, H, KV, Dqk,
                                                            Dv, causal, dtype):
    """One call of the kernel's wrapper, at the padded head size and the
    true scale 1/sqrt(D_qk); the result is the unpadded plain version's,
    bit for bit."""
    calls = []
    wrapper = k3_module.flash_attention

    def record(q, k, v, *, causal=True, sm_scale=None, window=0):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1], sm_scale))
        return wrapper(q, k, v, causal=causal, sm_scale=sm_scale, window=window)

    monkeypatch.setattr(ops, "_flash", record)
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dtype)
               for s in ((B, T, H, Dqk), (B, S, KV, Dqk), (B, S, KV, Dv)))
    got = ops.flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == (B, T, H, Dv) and got.dtype == dtype
    assert torch.equal(got, want)
    D = kernel_head_dim(max(Dqk, Dv))
    assert calls == [(D, D, D, pytest.approx(1 / math.sqrt(Dqk)))]


def test_kernel_head_dim():
    assert [kernel_head_dim(d) for d in (16, 64, 80, 128, 192, 256)] == [64, 64, 128, 128,
                                                                         256, 256]
    with pytest.raises(ValueError, match="up to 256"):
        kernel_head_dim(320)


def test_mla_prefill_runs_k3_once_a_layer(monkeypatch):
    """The reduced model's prefill (2 MLA layers) reaches the K3 op once a
    layer, causal, at q/k width 24 and v width 16."""
    from repro_torch.models import make_model

    cfg = dataclasses.replace(get_config(NAME).reduced(), capacity_factor=8.0)
    m = make_model(cfg, compute_dtype=torch.float32)
    p = m.init(torch.Generator().manual_seed(0))
    seen = []
    op = ops.flash_attention

    def record(q, k, v, *, causal=True):
        seen.append((q.shape[-1], v.shape[-1], causal))
        return op(q, k, v, causal=causal)

    monkeypatch.setattr(ops, "flash_attention", record)
    m.prefill(p, {"tokens": torch.zeros((1, 9), dtype=torch.long)}, 12)
    assert seen == [(24, 16, True)] * cfg.n_layers
