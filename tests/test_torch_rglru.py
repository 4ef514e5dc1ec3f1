"""The port's RG-LRU block and causal conv1d against the reference's, on
the CPU, in f32.

Reduced recurrentgemma-2b (lru_width 64, conv kernel 4); the reference's
parameters carried across as numpy, inputs from a seed. The port's
doubling scan associates the same combine differently from
``jax.lax.associative_scan``, so the states agree to rounding: atol 1e-4
as ``tests/test_models.py`` holds scan against step (observed below 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro_torch.configs import get_config
from repro_torch.models import layers, rglru
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ATOL = 1e-4


def _setup(seed=2):
    name = "recurrentgemma-2b"
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    jp = jrglru.rglru_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_rglru_init_matches_the_reference_tree_and_range():
    jcfg, cfg, jp, _ = _setup()
    p = rglru.rglru_init(torch.Generator().manual_seed(0), cfg, lead=(3,))
    assert jax.tree.map(lambda a: tuple(a.shape)[1:], p) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    a_c = torch.exp(-rglru._C * torch.nn.functional.softplus(p["log_lambda"]))
    assert p["log_lambda"].dtype == torch.float32
    assert float(a_c.min()) >= 0.9 - 1e-6 and float(a_c.max()) <= 0.999 + 1e-6


@pytest.mark.parametrize("h0", [False, True])
def test_rglru_scan_matches_reference(h0):
    _, cfg, jp, p = _setup()
    rng = np.random.default_rng(0)
    xc = rng.standard_normal((2, 37, cfg.lru_width)).astype(np.float32)
    h_init = rng.standard_normal((2, cfg.lru_width)).astype(np.float32) if h0 else None
    want, want_last = jrglru.rglru_scan(jnp.asarray(xc), jp,
                                        None if h_init is None else jnp.asarray(h_init))
    got, got_last = rglru.rglru_scan(torch.from_numpy(xc), p,
                                     None if h_init is None else torch.from_numpy(h_init))
    assert got.dtype == torch.float32 and got_last.shape == (2, cfg.lru_width)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    np.testing.assert_allclose(_np(got_last), _np(want_last), atol=ATOL)


def test_rglru_scan_matches_step():
    """tests/test_models.py's scan-vs-step case on the port."""
    _, cfg, _, p = _setup()
    xc = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 12, cfg.lru_width))
                          .astype(np.float32))
    h_seq, h_last = rglru.rglru_scan(xc, p)
    h = torch.zeros((2, cfg.lru_width))
    for t in range(12):
        out, h = rglru.rglru_step(xc[:, t], p, h)
        np.testing.assert_allclose(_np(out), _np(h_seq[:, t]), atol=ATOL)
    np.testing.assert_allclose(_np(h), _np(h_last), atol=ATOL)


@pytest.mark.parametrize("T", [1, 2, 5, 64, 100])
def test_linear_scan_is_the_recurrence(T):
    g = torch.Generator().manual_seed(T)
    a, b = torch.rand((3, T, 5), generator=g), torch.randn((3, T, 5), generator=g)
    h, want = torch.zeros((3, 5)), []
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(rglru.linear_scan(a, b), torch.stack(want, 1), atol=1e-5,
                               rtol=1e-5)


def test_causal_conv1d_and_its_step_match_reference():
    rng = np.random.default_rng(3)
    jp = jlayers.conv1d_init(jax.random.PRNGKey(4), 16, 4)
    jp = dict(jp, b=jnp.asarray(rng.standard_normal(16).astype(np.float32)))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    want = jlayers.causal_conv1d(jnp.asarray(x), jp)
    got = layers.causal_conv1d(torch.from_numpy(x), p)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)
    state, jstate = torch.zeros((2, 3, 16)), jnp.zeros((2, 3, 16))   # token by token
    for t in range(9):
        out, state = layers.causal_conv1d_step(torch.from_numpy(x[:, t]), state, p)
        jout, jstate = jlayers.causal_conv1d_step(jnp.asarray(x[:, t]), jstate, jp)
        np.testing.assert_allclose(_np(out), _np(got[:, t]), atol=1e-6)
        np.testing.assert_allclose(_np(out), _np(jout), atol=1e-6)
        np.testing.assert_array_equal(_np(state), _np(jstate))
    init = layers.conv1d_init(torch.Generator().manual_seed(0), 16, 4, lead=(2,))
    assert init["w"].shape == (2, 4, 16) and not init["b"].any()
    assert float(init["w"].abs().max()) <= 2.0 / 2 + 1e-6        # truncated at 2 sigma


@pytest.mark.parametrize("T", [2, 11])
def test_rglru_block_prefill_and_step_match_reference(T):
    """The block's prefill output and state (the conv state left-padded
    when T < K-1), then three decode steps from that state."""
    jcfg, cfg, jp, p = _setup()
    x = np.random.default_rng(5).standard_normal((2, T + 3, cfg.d_model)).astype(np.float32)
    want, jst = jrglru.rglru_block_prefill(jnp.asarray(x[:, :T]), jp, jcfg)
    got, st = rglru.rglru_block_prefill(torch.from_numpy(x[:, :T]), p, cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    assert st["conv"].shape == (2, cfg.conv1d_size - 1, cfg.lru_width)
    assert st["h"].dtype == torch.float32
    for k in ("h", "conv"):
        np.testing.assert_allclose(_np(st[k]), _np(jst[k]), atol=ATOL)
    full = rglru.rglru_block_forward(torch.from_numpy(x), p, cfg)
    want_full = jrglru.rglru_block_forward(jnp.asarray(x), jp, jcfg)
    np.testing.assert_allclose(_np(full), _np(want_full), atol=ATOL)
    for t in range(T, T + 3):
        want, jst = jrglru.rglru_block_step(jnp.asarray(x[:, t:t + 1]), jp, jcfg, jst)
        got, st = rglru.rglru_block_step(torch.from_numpy(x[:, t:t + 1].copy()), p, cfg, st)
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
        np.testing.assert_allclose(_np(got[:, 0]), _np(full[:, t]), atol=ATOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(_np(st[k]), _np(jst[k]), atol=ATOL)
