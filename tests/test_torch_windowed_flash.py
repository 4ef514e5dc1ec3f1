"""K3 and K3-bwd with a window against the reference's windowed attention,
on the CPU.

The reference runs its local blocks (recurrentgemma-2b's) through
``chunked_attention(..., window=)``: the ``_flash_grouped`` custom VJP,
whose forward ``_flash_fwd`` and backward ``_flash_grouped_bwd`` mask with
``_chunk_bias`` (key s is seen by query t when s > t - window, and s <= t
if causal). The port's models send the same calls to
``ops.flash_attention(..., window=)``: K3 and K3-bwd on the card, their
plain versions here. Inputs come from a numpy seed and are handed to both
packages.

* The plain windowed K3, out and lse, against the reference's
  ``_flash_fwd``: f32 atol 2e-5, bf16 2e-2 (``tests/test_kernels.py``'s
  tolerances). A window of at least T is the causal function exactly.
* ``ops.flash_attention(window=)`` under autograd against ``jax.grad`` of
  the reference's ``chunked_attention(window=, kv_chunk=8)``: atol 2e-4,
  that file's gradient bound, at windows of 1, 16 and 48 keys (each
  shorter than K3's 128-row query tile), T of 37 and 64, G of 1, 5 and
  10, causal and not, and head widths the op pads (16 and 80).
* A local block's ``gqa_forward`` and ``gqa_prefill``, and the reduced
  recurrentgemma's prefill and loss gradient, reach ``ops.flash_attention``
  with the window and never ``FlashGrouped``.

The cases marked ``cuda`` are in ``tests/test_torch_flash_grad_cuda.py``
and ``tests/test_torch_flash_attention.py``, which import no JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ops
from repro_torch.models import attention, make_model
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

FWD_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_ATOL = 2e-4

FWD_GRID = [  # B, T, H, KV, D, causal, window
    (2, 37, 4, 1, 16, True, 1),
    (1, 64, 10, 1, 64, True, 16),
    (2, 64, 5, 1, 64, False, 48),
    (1, 100, 4, 4, 128, True, 100),
    (1, 200, 10, 1, 256, True, 48),      # recurrentgemma's heads; the window below a tile
    (1, 300, 4, 2, 64, True, 100),       # T past a query tile and a window that is not a multiple of 64
]

GRAD_GRID = [  # B, T, H, KV, D, causal, window
    (2, 37, 4, 4, 16, True, 1),          # G = 1, padded 16 -> 64
    (2, 37, 5, 1, 16, True, 16),         # G = 5
    (1, 37, 10, 1, 16, True, 48),        # G = 10; a window past T
    (1, 64, 10, 1, 16, True, 16),
    (2, 64, 4, 4, 16, False, 16),
    (1, 64, 5, 1, 16, False, 48),
    (1, 37, 10, 1, 16, False, 1),
    (1, 64, 4, 2, 80, True, 48),         # padded 80 -> 128
    (2, 37, 10, 1, 64, True, 16),        # a width the kernel takes as it is
]


def _arrays(seed, B, T, H, KV, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, T, H, D), (B, T, KV, D), (B, T, KV, D))]


def _cast(a, dtype):
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,KV,D,causal,window", FWD_GRID)
def test_plain_windowed_k3_matches_reference_flash_fwd(B, T, H, KV, D, causal, window, dtype):
    """K3's plain version with its lse against the reference's ``_flash_fwd``
    (one chunk of T keys, the function of every chunking) on the same
    inputs; out in q's dtype, lse (B, H, T) f32."""
    arrays = _arrays(0, B, T, H, KV, D)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    q, k, v = (jnp.asarray(a).astype(jdt) for a in arrays)
    want_out, want_lse = jattn._flash_fwd(q.reshape(B, T, KV, H // KV, D), k, v, causal, window,
                                          0, T, 1.0 / np.sqrt(D), None)
    want_out = np.asarray(want_out.reshape(B, T, H, D).astype(jdt).astype(jnp.float32))
    want_lse = np.asarray(want_lse).reshape(B, T, H).transpose(0, 2, 1)
    out, lse = k3.flash_attention_fwd_plain(*(_cast(a, dtype) for a in arrays), causal=causal,
                                            window=window)
    assert out.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), want_out, atol=FWD_ATOL[dtype], rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=FWD_ATOL[dtype], rtol=0)
    # through the op, which pads the widths the kernel is not built for
    got = ops.flash_attention(*(_cast(a, dtype) for a in arrays), causal=causal, window=window)
    np.testing.assert_allclose(got.float().numpy(), want_out, atol=FWD_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_a_window_of_at_least_t_is_the_windowless_function(causal):
    """A window as long as the sequence or longer (recurrentgemma's live
    prompts: 1280 tokens against 2048) masks nothing the windowless mask
    keeps: out and lse equal to the last bit."""
    q, k, v = (torch.from_numpy(a) for a in _arrays(1, 2, 40, 4, 2, 64))
    want = k3.flash_attention_fwd_plain(q, k, v, causal=causal)
    for window in (40, 2048):
        got = k3.flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


def _jax_grads(arrays, causal, window):
    def f(q, k, v):
        return (jattn.chunked_attention(q, k, v, causal=causal, window=window,
                                        kv_chunk=8) ** 2).sum()

    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))]


@pytest.mark.parametrize("B,T,H,KV,D,causal,window", GRAD_GRID)
def test_windowed_op_grads_match_reference_vjp(B, T, H, KV, D, causal, window):
    """``ops.flash_attention(window=)`` under autograd (the
    ``FlashAttention`` function: K3's plain forward with its lse, then
    ``flash_attention_bwd_plain`` with the window) against ``jax.grad`` of
    the reference's windowed ``chunked_attention``; the CPU never
    launches a kernel."""
    arrays = _arrays(2, B, T, H, KV, D)
    want = _jax_grads(arrays, causal, window)
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    before = (k3.flash_attention.launches, k3.flash_attention_bwd.launches)
    (ops.flash_attention(*ts, causal=causal, window=window) ** 2).sum().backward()
    assert (k3.flash_attention.launches, k3.flash_attention_bwd.launches) == before
    for t, w, name in zip(ts, want, "qkv"):
        assert t.grad.shape == w.shape, name
        np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_ATOL, err_msg=f"d{name}")


def test_the_kernel_takes_a_window_only_with_a_key_for_every_row():
    """With a window the kernels take T <= S (every row sees a key: the
    models' calls have T = S) and a window >= 0; the wrapper refuses
    the rest before any launch."""
    q, k, v = (torch.zeros(s) for s in ((1, 8, 2, 64), (1, 4, 1, 64), (1, 4, 1, 64)))
    k3._check(q, k, v, 0)                      # no window: T > S is fine
    with pytest.raises(ValueError, match="T <= S"):
        k3._check(q, k, v, 4)
    with pytest.raises(ValueError, match="window=-1"):
        k3._check(q[:, :4], k, v, -1)


class _Recorder:
    """Records each ``ops.flash_attention`` call's (causal, window) and
    fails a call of ``FlashGrouped``."""

    def __init__(self, monkeypatch):
        self.calls, self.bwd_windows = [], []
        real, real_bwd = ops.flash_attention, k3.flash_attention_bwd_plain

        def spy(q, k, v, *, causal=True, window=0):
            self.calls.append((causal, window))
            return real(q, k, v, causal=causal, window=window)

        def bwd_spy(*args, window=0, **kw):
            self.bwd_windows.append(window)
            return real_bwd(*args, window=window, **kw)

        def refuse(*args, **kw):
            raise AssertionError("FlashGrouped reached from a model's sequence attention")

        monkeypatch.setattr(ops, "flash_attention", spy)
        monkeypatch.setattr(k3, "flash_attention_bwd_plain", bwd_spy)
        monkeypatch.setattr(attention.FlashGrouped, "apply", refuse)


def test_a_local_block_reaches_k3_with_its_window(monkeypatch):
    """recurrentgemma's local block: ``gqa_forward`` and ``gqa_prefill``
    (a prompt past the window of 32) call ``ops.flash_attention`` with
    the window, causal, once each, and never ``FlashGrouped``; the
    forward under autograd runs K3-bwd's plain version with the window."""
    cfg = get_config("recurrentgemma-2b").reduced()
    rec = _Recorder(monkeypatch)
    p = attention.gqa_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 40, cfg.d_model))
                         .astype(np.float32))
    with torch.no_grad():
        attention.gqa_prefill(x, p, cfg, 48, window=cfg.window)
    x.requires_grad_()
    attention.gqa_forward(x, p, cfg, window=cfg.window).sum().backward()
    assert rec.calls == [(True, cfg.window)] * 2
    assert rec.bwd_windows == [cfg.window] and x.grad is not None


def test_the_reduced_recurrentgemma_runs_k3_in_every_local_layer(monkeypatch):
    """The reduced recurrentgemma's prefill and its loss's gradient: one
    ``ops.flash_attention`` call with the window a local layer and pass,
    one K3-bwd (plain here) with it a local layer; no ``FlashGrouped``."""
    cfg = get_config("recurrentgemma-2b").reduced()
    n_local = sum(cfg.block_pattern[i % len(cfg.block_pattern)] == "local"
                  for i in range(cfg.n_layers))
    assert n_local == 2
    model = make_model(cfg, param_dtype=torch.float32, compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    rec = _Recorder(monkeypatch)
    with torch.no_grad():
        model.prefill(params, {"tokens": tokens}, 48)
    assert rec.calls == [(True, cfg.window)] * n_local
    rec.calls.clear()
    leaves = [params["embed"].requires_grad_()]
    loss, _ = model.loss(params, {"tokens": tokens, "labels": tokens})
    torch.autograd.grad(loss, leaves)
    assert rec.calls == [(True, cfg.window)] * n_local
    assert rec.bwd_windows == [cfg.window] * n_local
