"""K3-bwd and K3's lse on the card, against their plain versions; no JAX
(this file is collected on the card's machine).

With a window (recurrentgemma's local blocks: the keys s > t - window)
the same kernels are held at windows below a query tile, MQA at G = 10
and 5, windows of T or more (the causal kernels bit for bit), ragged T
and recurrentgemma's training shape (T = 4096, window 2048).

Every case is marked ``cuda`` and skips without a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_grad_cuda.py

Tolerances: f32 atol 2e-4 (``tests/test_kernels.py``'s gradient bound)
for the gradients and 1e-4 for the lse. bf16: each gradient within 2^-6 of
the plain version's largest magnitude: the kernel rounds P and dS to bf16
as the operands of the next products (2^-9 relative each) and the
gradients themselves to bf16 (2^-9), so about 2^-8 of the scale, with a
4x margin; the lse within 5e-2 (the bound on K2's lse in bf16).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as k3
from repro_torch.kernels import ops
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

GRID = [  # B, T, S, H, KV, D, causal
    (2, 32, 32, 4, 2, 64, True), (2, 32, 32, 4, 2, 64, False),
    (1, 100, 100, 4, 1, 64, True),      # G = 4, ragged tiles
    (1, 64, 192, 4, 4, 64, True),       # causal T < S: keys past T see no query
    (1, 192, 64, 4, 2, 128, False),     # T > S
    (2, 200, 200, 8, 2, 128, True),
    (1, 128, 128, 4, 4, 256, True), (1, 130, 130, 2, 1, 256, False),
    (1, 256, 256, 8, 1, 64, True),      # G = 8
    (1, 1024, 1024, 16, 8, 128, True),  # qwen3-1.7b's attention, one sequence
    # across the bf16 kernels' tiles (128 own rows a block, 64 streamed a step)
    (1, 1000, 1000, 4, 2, 128, True),   # T = S = 1000: the last tiles ragged
    (1, 129, 65, 4, 2, 128, False),     # one row past a block; S ends mid-step
    (1, 129, 65, 4, 2, 64, False),
    (1, 65, 200, 4, 4, 128, True),      # causal T < S: key tiles that see no query
    (3, 130, 130, 4, 2, 128, True),     # B = 3: a box ends at a batch boundary
    (1, 256, 256, 4, 4, 128, True),     # G = 1
    (1, 256, 256, 4, 2, 128, True),     # G = 2
    (1, 256, 256, 8, 1, 128, True),     # G = 8
]
PADDED = [  # B, T, H, KV, Dqk, Dv, causal: widths the op pads (D=16 of the reduced configs)
    (2, 32, 4, 2, 16, 16, True), (1, 96, 4, 4, 192, 128, True), (2, 80, 4, 4, 80, 80, False),
]
# B, T, H, KV, D, causal, window (keys s > t - window; T = S): recurrentgemma's
# local blocks. Windows below a query tile (128 rows), where a key tile lies
# wholly before the window of a block's later rows; windows that are not a
# multiple of the key tiles; MQA at G = 10 and at a rank's G = 5 at D = 256;
# windows of T or more (the causal kernel); ragged T; recurrentgemma's
# training shape
WINDOWED = [
    (1, 300, 4, 1, 64, True, 1), (1, 300, 4, 2, 128, True, 16),
    (1, 300, 10, 1, 256, True, 48), (1, 500, 5, 1, 256, True, 100),
    (2, 333, 4, 4, 64, False, 100), (1, 300, 4, 1, 128, False, 16),
    (1, 1000, 10, 1, 256, True, 200), (1, 1000, 5, 1, 256, True, 129),
    (2, 200, 4, 2, 128, True, 2048), (1, 1280, 10, 1, 256, True, 2048),
    (3, 130, 4, 2, 128, True, 64), (1, 1000, 8, 1, 64, True, 300),
    (1, 4096, 10, 1, 256, True, 2048),
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, shapes, dtype, device):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
            for s in shapes]


def _hold(got, want, dtype, what):
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert np.isfinite(g).all(), what
    atol = 2e-4 if dtype == torch.float32 else 2.0**-6 * max(float(np.abs(w).max()), 1e-30)
    np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,KV,D,causal", GRID)
def test_flash_attention_bwd_kernel_matches_plain(cuda_device, B, T, S, H, KV, D, causal,
                                                  dtype):
    q, k, v, do = _inputs(0, [(B, T, H, D), (B, S, KV, D), (B, S, KV, D), (B, T, H, D)], dtype,
                          cuda_device)
    out, lse = k3.flash_attention_fwd_plain(q, k, v, causal=causal)
    before = k3.flash_attention_bwd.launches
    got = k3.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert k3.flash_attention_bwd.launches == before + 1
    want = k3.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == dtype, name
        _hold(g, w, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,KV,D,window", [(4, 1024, 16, 8, 128, 0),
                                               (1, 4096, 10, 1, 256, 2048)])
def test_flash_attention_bwd_is_deterministic(cuda_device, B, T, H, KV, D, window):
    """Two calls at qwen3-1.7b's training shape and at recurrentgemma-2b's
    with its window (bf16, causal) give bit-identical dq, dk and dv: no
    atomics, sums in a fixed order."""
    q, k, v, do = _inputs(5, [(B, T, H, D), (B, T, KV, D), (B, T, KV, D), (B, T, H, D)],
                          torch.bfloat16, cuda_device)
    out, lse = k3.flash_attention_fwd(q, k, v, window=window)
    first = k3.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    second = k3.flash_attention_bwd(q, k, v, out, lse, do, window=window)
    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
def test_flash_attention_bwd_plan(cuda_device, D):
    """The launch plan: wgmma in bf16 (dK/dV in 128-column chunks at D =
    256), FMA in f32; every kernel's shared memory within an H100's opt-in
    (cudaDevAttrMaxSharedMemoryPerBlockOptin, 232,448 bytes)."""
    plan = k3.bwd_launch_plan(D, torch.bfloat16)
    assert plan["tensor_cores"] == "wgmma"
    assert plan["dkdv"]["columns"] == min(D, 128) and plan["dq"]["columns"] == D
    assert k3.bwd_launch_plan(D, torch.float32)["tensor_cores"] == "none (f32 FMA)"
    for part in ("dkdv", "dq"):
        assert 0 < plan[part]["smem_bytes"] <= 232448, (part, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,KV,D,causal", GRID + [(1, 16, 0, 2, 1, 64, False)])
def test_flash_attention_lse_matches_plain(cuda_device, B, T, S, H, KV, D, causal, dtype):
    """K3 with its lse: the same output as without it, and the plain
    lse (S = 0: -1e30)."""
    q, k, v = _inputs(1, [(B, T, H, D), (B, S, KV, D), (B, S, KV, D)], dtype, cuda_device)
    out, lse = k3.flash_attention_fwd(q, k, v, causal=causal)
    want_out, want_lse = k3.flash_attention_fwd_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert lse.shape == (B, H, T) and lse.dtype == torch.float32
    torch.testing.assert_close(out, k3.flash_attention(q, k, v, causal=causal), rtol=0, atol=0)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=1e-4 if dtype == torch.float32 else 5e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,S,H,KV,D,causal,window", [s[:2] + s[1:] for s in WINDOWED])
def test_windowed_flash_attention_matches_plain(cuda_device, B, T, S, H, KV, D, causal,
                                                window, dtype):
    """Windowed K3 with its lse against its plain version: out within 2e-5
    (f32) and 2e-2 (bf16) as K3's own checks, lse within 1e-4 and 5e-2;
    the launch without the lse gives the same out."""
    q, k, v = _inputs(6, [(B, T, H, D), (B, S, KV, D), (B, S, KV, D)], dtype, cuda_device)
    before = k3.flash_attention.launches
    out, lse = k3.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k3.flash_attention.launches == before + 1
    want_out, want_lse = k3.flash_attention_fwd_plain(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(out.float().cpu().numpy(), want_out.float().cpu().numpy(),
                               atol=2e-5 if dtype == torch.float32 else 2e-2, rtol=0)
    np.testing.assert_allclose(lse.cpu().numpy(), want_lse.cpu().numpy(),
                               atol=1e-4 if dtype == torch.float32 else 5e-2, rtol=0)
    torch.testing.assert_close(out, k3.flash_attention(q, k, v, causal=causal, window=window),
                               rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,KV,D,causal,window", WINDOWED)
def test_windowed_flash_attention_bwd_matches_plain(cuda_device, B, T, H, KV, D, causal, window,
                                                    dtype):
    """Windowed K3-bwd against its plain version on the kernel's own out
    and lse, at the tolerances of the windowless cases."""
    q, k, v, do = _inputs(7, [(B, T, H, D), (B, T, KV, D), (B, T, KV, D), (B, T, H, D)], dtype,
                          cuda_device)
    out, lse = k3.flash_attention_fwd(q, k, v, causal=causal, window=window)
    before = k3.flash_attention_bwd.launches
    got = k3.flash_attention_bwd(q, k, v, out, lse, do, causal=causal, window=window)
    torch.cuda.synchronize()
    assert k3.flash_attention_bwd.launches == before + 1
    want = k3.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal, window=window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == dtype, name
        if window == 1 and name != "dv":
            # each row sees its own key alone: P = 1 and dS = P (dP - delta)
            # = 0, so dq and dk are zero but for f32 rounding on both sides
            # (about 1e-6 here), which a bound relative to them cannot hold
            np.testing.assert_allclose(g.float().cpu().numpy(), 0.0, atol=1e-5, err_msg=name)
            continue
        _hold(g, w, dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_window_of_at_least_t_is_the_causal_kernel(cuda_device, dtype):
    """recurrentgemma's live prompt (1280 tokens) against its window of
    2048: K3's out and lse and K3-bwd's gradients equal the windowless
    causal kernels' bit for bit."""
    B, T, H, KV, D = 1, 1280, 10, 1, 256
    q, k, v, do = _inputs(8, [(B, T, H, D), (B, T, KV, D), (B, T, KV, D), (B, T, H, D)], dtype,
                          cuda_device)
    runs = []
    for window in (0, 2048):
        out, lse = k3.flash_attention_fwd(q, k, v, window=window)
        runs.append((out, lse) + k3.flash_attention_bwd(q, k, v, out, lse, do, window=window))
    torch.cuda.synchronize()
    for a, b, name in zip(*runs, ("out", "lse", "dq", "dk", "dv")):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,KV,Dqk,Dv,causal", PADDED)
@pytest.mark.parametrize("window", [0, 16])
def test_op_gradients_on_the_card_never_run_plain(monkeypatch, cuda_device, B, T, H, KV, Dqk,
                                                  Dv, causal, window, dtype):
    """``ops.flash_attention`` under autograd on CUDA tensors, with a
    window and without: one K3 and one K3-bwd launch, through the op's
    padding, never a plain version; the gradients are the plain route's
    (the same op on the CPU)."""
    arrays = [np.random.default_rng(2).standard_normal(s).astype(np.float32)
              for s in ((B, T, H, Dqk), (B, T, KV, Dqk), (B, T, KV, Dv))]

    def grads(device):
        ts = [torch.from_numpy(a).to(device, dtype).requires_grad_() for a in arrays]
        (ops.flash_attention(*ts, causal=causal, window=window).float() ** 2).sum().backward()
        return [t.grad for t in ts]

    want = grads("cpu")

    def refuse(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    for name in ("flash_attention_plain", "flash_attention_fwd_plain",
                 "flash_attention_bwd_plain"):
        monkeypatch.setattr(k3, name, refuse)
    n3, nb = k3.flash_attention.launches, k3.flash_attention_bwd.launches
    got = grads(cuda_device)
    torch.cuda.synchronize()
    assert (k3.flash_attention.launches, k3.flash_attention_bwd.launches) == (n3 + 1, nb + 1)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _hold(g, w, dtype, name)


@pytest.mark.cuda
def test_failed_backward_launch_raises(monkeypatch, cuda_device):
    """A K3-bwd launch that fails raises; nothing falls back to the plain
    backward."""
    class Refused:
        def repro_flash_attention_bwd(self, *args):
            return 1            # cudaErrorInvalidValue

    monkeypatch.setattr(k3, "_bwd_lib", lambda: Refused())
    q, k, v = _inputs(3, [(1, 64, 2, 64), (1, 64, 1, 64), (1, 64, 1, 64)], torch.bfloat16,
                      cuda_device)
    q.requires_grad_()
    out = ops.flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="flash_attention_bwd kernel launch failed"):
        out.float().sum().backward()


@pytest.mark.cuda
def test_reduced_train_step_gradients_on_the_card(cuda_device):
    """A reduced qwen3 (G = 2, head_dim 64) in f32 throughout (parameters,
    the cast copy and the model's activations): the loss's gradients on
    the card (K3 and K3-bwd in every layer) against the CPU's (the plain
    versions), every leaf within 1e-4 of its scale; the attention
    parameters' gradients are nonzero. Then one train step on the card."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import make_model
    from repro_torch.training import TrainConfig, make_train_step
    from repro_torch.training.train_step import init_train_state, make_loss_fn
    from repro_torch.training.tree import flatten_with_paths, leaves, tree_map, unflatten

    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), n_kv_heads=2, head_dim=64)
    model = make_model(cfg, compute_dtype=torch.float32)
    tcfg = TrainConfig(compute_dtype=torch.float32)
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 48))) for k in
             ("tokens", "labels")}
    loss_fn = make_loss_fn(model, tcfg)

    def grads(params, batch):
        ps = [p.detach().requires_grad_() for p in leaves(params)]
        loss, _ = loss_fn(unflatten(params, ps), batch)
        return float(loss.detach()), torch.autograd.grad(loss, ps)

    want_loss, want = grads(state["params"], batch)
    on_card = tree_map(lambda t: t.to(cuda_device), state)
    card_batch = {k: v.to(cuda_device) for k, v in batch.items()}
    n3, nb = k3.flash_attention.launches, k3.flash_attention_bwd.launches
    got_loss, got = grads(on_card["params"], card_batch)
    torch.cuda.synchronize()
    assert k3.flash_attention.launches == n3 + cfg.n_layers
    assert k3.flash_attention_bwd.launches == nb + cfg.n_layers
    assert abs(got_loss - want_loss) < 1e-4
    for (path, _), g, w in zip(flatten_with_paths(state["params"]), got, want):
        scale = max(1.0, float(w.abs().max()))
        np.testing.assert_allclose(g.cpu().numpy() / scale, w.numpy() / scale, atol=1e-4,
                                   err_msg=path)
        if any(n in path for n in ("'wq'", "'wk'", "'wv'", "'q_norm'", "'k_norm'")):
            assert float(g.abs().max()) > 0, path
    on_card, metrics = make_train_step(model, tcfg)(on_card, card_batch)
    assert np.isfinite(float(metrics["loss"])) and int(on_card["opt"]["step"]) == 1
