"""K3, the port's flash attention, against the reference's Pallas kernel.

Inputs are made with numpy from a seed and handed to both packages (bf16
inputs cast from the same f32 arrays on both sides: the same bits). The
reference kernel runs in Pallas interpret mode with 64-row blocks, as
``tests/test_kernels.py`` runs it, over that file's shape grid plus a
causal T < S case, which pins the top-left causal rule (a bottom-right
rule, FA2's own, would fail it). Tolerances are that file's: atol 2e-5
(f32) and 2e-2 (bf16).

The cases marked ``cuda`` hold the CUDA kernel to its plain version on the
card and skip without one; they need no JAX. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attention.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

DTYPES = ["float32", "bfloat16"]
GRID = [                              # B, T, S, H, KV, D, causal (tests/test_kernels.py)
    (2, 128, 128, 4, 2, 64, True),
    (1, 256, 256, 8, 8, 128, True),
    (2, 100, 100, 4, 1, 64, False),   # non-aligned edge blocks
    (1, 64, 192, 4, 4, 64, False),    # cross attention T != S
    (1, 128, 128, 4, 4, 256, True),   # recurrentgemma head_dim
    (1, 64, 192, 4, 2, 64, True),     # causal T < S: the mask is top-left
    (1, 200, 200, 8, 2, 128, True),   # G = 4, T not a multiple of the query tile
]
SLICE = (1, 1280, 1280, 16, 8, 128, True)   # qwen3-1.7b prefill of a served prompt
IMAGE = (1, 2432, 2432, 32, 8, 128, True)   # llava's prefill of 1152 image + 1280 text tokens
PADDED = [   # B, T, S, H, KV, D_qk, D_v, causal: widths the op pads for the kernel
    (1, 1280, 1280, 128, 128, 192, 128, True),  # deepseek-v2's MLA prefill -> 256
    (1, 1000, 1000, 16, 16, 80, 80, False),     # hubert-xlarge's encoder -> 128
    (1, 200, 200, 8, 2, 80, 80, True),          # D=80 causal with GQA
]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(seed, B, T, S, H, KV, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, T, H, D), (B, S, KV, D), (B, S, KV, D))]


def _t(a, dtype, device="cpu"):
    t = torch.from_numpy(a.copy())
    return (t.to(torch.bfloat16) if dtype == "bfloat16" else t).to(device)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,S,H,KV,D,causal", GRID)
def test_flash_attention_matches_pallas(B, T, S, H, KV, D, causal, dtype):
    jnp = pytest.importorskip("jax.numpy", reason="the reference package needs JAX")
    from repro.kernels import ops as jops

    arrays = _inputs(0, B, T, S, H, KV, D)
    ja = [jnp.asarray(a).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
          for a in arrays]
    want = jops.flash_attention(*ja, causal=causal, block_q=64, block_kv=64, interpret=True)
    got = ops.flash_attention(*[_t(a, dtype) for a in arrays], causal=causal)
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    assert got.shape == (B, T, H, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=_tol(dtype))


def test_causal_mask_is_top_left():
    """Query t sees keys 0..t whatever S is: with T < S the last keys are
    never seen, so changing them changes nothing."""
    q, k, v = (_t(a, "float32") for a in _inputs(1, 1, 8, 24, 2, 1, 64))
    out = flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, 8:], v2[:, 8:] = 100.0, -100.0
    torch.testing.assert_close(flash_attention(q, k2, v2, causal=True), out, rtol=0, atol=0)
    assert not torch.allclose(flash_attention(q, k2, v2, causal=False),
                              flash_attention(q, k, v, causal=False))


def test_other_devices_never_run_the_plain_version(monkeypatch):
    """Only a CPU tensor takes the plain version; any other device
    launches the kernel (CUDA) or raises."""
    import repro_torch.kernels.flash_attention as fa

    def refuse(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    q = torch.empty((1, 4, 2, 64), device="meta")
    k = torch.empty((1, 4, 1, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, k, k)


# -- the CUDA kernel against its plain version (skips without a card) -------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,S,H,KV,D,causal", GRID + [SLICE, IMAGE])
def test_flash_attention_kernel_matches_plain(cuda_device, B, T, S, H, KV, D, causal, dtype):
    q, k, v = (_t(a, dtype, cuda_device) for a in _inputs(2, B, T, S, H, KV, D))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,S,H,KV,Dqk,Dv,causal", PADDED)
def test_padded_flash_attention_kernel_matches_plain(monkeypatch, cuda_device, B, T, S, H, KV,
                                                     Dqk, Dv, causal, dtype):
    """The op's padded path on the card: one launch of the unchanged
    kernel at the padded width, never the plain version, within the
    tolerance of the unpadded plain version."""
    import repro_torch.kernels.flash_attention as fa

    rng = np.random.default_rng(3)
    q, k, v = (_t(rng.standard_normal(s).astype(np.float32), dtype, cuda_device)
               for s in ((B, T, H, Dqk), (B, S, KV, Dqk), (B, S, KV, Dv)))
    want = flash_attention_plain(q, k, v, causal=causal)

    def refuse(*a, **kw):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_attention_plain", refuse)
    before = flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.shape == (B, T, H, Dv) and got.dtype == q.dtype
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-1.7b", "recurrentgemma-2b"])
def test_model_prefill_on_the_card_runs_k3_in_every_layer(cuda_device, name):
    """A reduced qwen3 (head_dim 64, G = 2) and the reduced recurrentgemma
    (its local layers' window of 32, head_dim 16 padded to 64, MQA)
    prefilled on the card in f32 with a prompt past the window: one K3
    launch per attention layer (every layer of qwen3, each local layer of
    recurrentgemma), logits and caches as on the CPU (K3 within 2e-5 of
    its plain version; the products in full f32, no TF32)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import make_model

    cfg = get_config(name).reduced()
    if name == "qwen3-1.7b":
        cfg = dataclasses.replace(cfg, n_kv_heads=2, head_dim=64)
    G = len(cfg.block_pattern)
    n_attn = sum(cfg.block_pattern[i % G] in ("attn", "local") for i in range(cfg.n_layers))
    model = make_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 40)))
    assert tokens.shape[1] > cfg.window
    want, want_c = model.prefill(params, {"tokens": tokens}, 48)
    on_card = _to(params, cuda_device)
    before = flash_attention.launches
    got, got_c = model.prefill(on_card, {"tokens": tokens.to(cuda_device)}, 48)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + n_attn
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    for g in want_c["blocks"]:
        for leaf, w in want_c["blocks"][g].items():
            np.testing.assert_allclose(got_c["blocks"][g][leaf].cpu().numpy(), w.numpy(),
                                       atol=1e-4, err_msg=f"{g} {leaf}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["deepseek-v2-236b", "llava-next-mistral-7b", "hubert-xlarge"])
def test_mla_vision_and_encoder_models_on_the_card_run_k3_in_every_layer(cuda_device, name):
    """The reduced deepseek-v2 (MLA: 24/16 padded to 64), llava (with an
    image) and hubert (a non-causal forward over frames) on the card in
    f32: one K3 launch a layer, logits as on the CPU within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import make_model

    cfg = get_config(name).reduced()
    model = make_model(cfg, compute_dtype=torch.float32)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    if cfg.modality == "audio":
        batch = {"frames": torch.from_numpy(rng.standard_normal((2, 40, cfg.d_model))
                                            .astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))}
    if cfg.modality == "vision_text":
        batch["image_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32))
    want = model.forward_logits(params, batch)
    before = flash_attention.launches
    got = model.forward_logits(_to(params, cuda_device), _to(batch, cuda_device))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)
