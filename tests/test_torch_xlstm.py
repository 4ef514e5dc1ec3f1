"""The xLSTM blocks (xlstm-125m) against the reference on the CPU.

The reduced xlstm config (d_model 64, 4 heads: the mLSTM's up-projection
128 wide, dh 32; the sLSTM's dh 16) with the reference's parameters
carried across; inputs are numpy arrays from a seed, f32. The gates are
exponential with a max-stabilizer, so the two packages' sums in another
order come back through exp: outputs of scale ~1 and the states are
held to atol 1e-4 (observed below 2e-5), the states' C and n relative
to their own scale (they grow with the sequence).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import xlstm as jx
from repro_torch.configs import get_config
from repro_torch.models import xlstm
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ATOL = 1e-4
NAME = "xlstm-125m"


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close_tree(got, want, atol=ATOL):
    assert sorted(got) == sorted(want)
    for n in want:
        g, w = _np(got[n]), _np(want[n])
        assert g.shape == w.shape, n
        np.testing.assert_allclose(g, w, atol=atol * max(1.0, float(np.abs(w).max())), err_msg=n)


def _block(kind, seed=1):
    jcfg, cfg = jget_config(NAME).reduced(), get_config(NAME).reduced()
    init = jx.mlstm_init if kind == "mlstm" else jx.slstm_init
    jp = init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, _t(jp)


def _x(cfg, T, B=2, seed=2):
    return np.random.default_rng(seed).standard_normal((B, T, cfg.d_model)).astype(np.float32)


def _qkvif(seed, B=2, T=64, H=2, dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, T, H, dh)).astype(np.float32) for _ in range(3))
    i_pre = rng.standard_normal((B, T, H)).astype(np.float32)
    f_pre = rng.standard_normal((B, T, H)).astype(np.float32) + 2.0
    return q, k, v, i_pre, f_pre


@pytest.mark.parametrize("form", ["parallel", "chunkwise"])
def test_mlstm_forms_match_reference(form):
    arrays = _qkvif(0)
    if form == "parallel":
        want = jx.mlstm_parallel(*map(jnp.asarray, arrays))
        got = xlstm.mlstm_parallel(*map(torch.from_numpy, arrays))
    else:
        want = jx.mlstm_chunkwise(*map(jnp.asarray, arrays), chunk=16)
        got = xlstm.mlstm_chunkwise(*map(torch.from_numpy, arrays), chunk=16)
    # h = num / den reaches ~30 where a gate's stabilized den is small:
    # rtol 2e-5 of each value (observed below 4e-6) beside atol 2e-5
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_mlstm_chunkwise_matches_quadratic():
    """tests/test_models.py's check on the port: the chunkwise form (4
    chunks of 16) is the quadratic form's function."""
    arrays = [torch.from_numpy(a) for a in _qkvif(1)]
    full = xlstm.mlstm_parallel(*arrays)
    chunked = xlstm.mlstm_chunkwise(*arrays, chunk=16)
    np.testing.assert_allclose(_np(full), _np(chunked), atol=2e-4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        xlstm.mlstm_chunkwise(*[a[:, :60] for a in arrays], chunk=16)


@pytest.mark.parametrize("T", [24, 512])
def test_mlstm_block_forward_matches_reference(T):
    """T=24 takes the parallel form, T=512 the chunkwise one (T >= 512
    and a multiple of 256), in both packages."""
    jcfg, jp, cfg, p = _block("mlstm")
    x = _x(cfg, T, B=1)
    want = jx.mlstm_block_forward(jnp.asarray(x), jp, jcfg)
    got = xlstm.mlstm_block_forward(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


@pytest.mark.parametrize("T", [2, 24, 256])
def test_mlstm_prefill_state_and_steps_match_reference(T):
    """The prefill's output and carried state (C, n, m and the conv rows,
    left-padded to 3 at T=2; one chunk of T at 24, chunks of 256 at 256),
    then three decode steps."""
    jcfg, jp, cfg, p = _block("mlstm", seed=3)
    x = _x(cfg, T + 3, seed=4)
    jout, js = jx.mlstm_block_prefill(jnp.asarray(x[:, :T]), jp, jcfg)
    out, st = xlstm.mlstm_block_prefill(torch.from_numpy(x[:, :T].copy()), p, cfg)
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL)
    _close_tree(st, js)
    assert st["conv"].shape == (2, 3, 2 * cfg.d_model)
    for t in range(T, T + 3):
        jd, js = jx.mlstm_block_step(jnp.asarray(x[:, t:t + 1]), jp, jcfg, js)
        d, st = xlstm.mlstm_block_step(torch.from_numpy(x[:, t:t + 1].copy()), p, cfg, st)
        np.testing.assert_allclose(_np(d), _np(jd), atol=ATOL)
        _close_tree(st, js)


def test_mlstm_state_init_matches_reference():
    jcfg, cfg = jget_config(NAME).reduced(), get_config(NAME).reduced()
    want = jx.mlstm_state_init(3, jcfg, jnp.bfloat16)
    got = xlstm.mlstm_state_init(3, cfg, torch.bfloat16)
    for n in want:
        assert tuple(got[n].shape) == want[n].shape
        assert str(got[n].dtype)[6:] == str(want[n].dtype)
        np.testing.assert_array_equal(_np(got[n]), _np(want[n]))


def test_slstm_forward_prefill_and_steps_match_reference():
    jcfg, jp, cfg, p = _block("slstm", seed=5)
    x = _x(cfg, 27, seed=6)
    want = jx.slstm_block_forward(jnp.asarray(x), jp, jcfg)
    got = xlstm.slstm_block_forward(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    jout, js = jx.slstm_block_prefill(jnp.asarray(x[:, :24]), jp, jcfg)
    out, st = xlstm.slstm_block_prefill(torch.from_numpy(x[:, :24].copy()), p, cfg)
    np.testing.assert_allclose(_np(out), _np(jout), atol=ATOL)
    _close_tree(st, js)
    assert all(t.dtype == torch.float32 for t in st.values())
    for t in range(24, 27):
        jd, js = jx.slstm_block_step(jnp.asarray(x[:, t:t + 1]), jp, jcfg, js)
        d, st = xlstm.slstm_block_step(torch.from_numpy(x[:, t:t + 1].copy()), p, cfg, st)
        np.testing.assert_allclose(_np(d), _np(jd), atol=ATOL)
        _close_tree(st, js)
    # the last step's output is the forward's at that position
    np.testing.assert_allclose(_np(d[:, 0]), _np(got[:, 26]), atol=ATOL)


def test_slstm_state_is_f32_whatever_the_compute_dtype():
    """bf16 activations and weights: the carried state stays f32, as the
    reference's; the outputs agree within 3% of their scale (both round
    the FFN's products to bf16 at other points; observed ~1%)."""
    jcfg, jp, cfg, p = _block("slstm", seed=7)
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    p = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16(), jp)
    x = _x(cfg, 16, seed=8)
    jout, js = jx.slstm_block_prefill(jnp.asarray(x).astype(jnp.bfloat16), jp, jcfg)
    out, st = xlstm.slstm_block_prefill(torch.from_numpy(x).bfloat16(), p, cfg)
    assert out.dtype == torch.bfloat16 and all(t.dtype == torch.float32 for t in st.values())
    scale = float(np.abs(_np(jout)).max())
    np.testing.assert_allclose(_np(out), _np(jout), atol=0.03 * scale)
