"""The port's attention entry points against the reference package.

Inputs are made with numpy from a seed and handed to both packages; bf16
inputs are cast from the same f32 arrays on both sides, which gives the
same bits. The reference kernels run in Pallas interpret mode, as
``tests/test_kernels.py`` runs them. Tolerances are those of
``tests/test_kernels.py``: out atol 2e-5 (f32) / 2e-2 (bf16), lse atol
1e-4 / 5e-2.

The cases marked ``cuda`` run each CUDA kernel against its plain version
on the card and skip without one. They need no JAX (the card's machine
has none): only the cases that compare with the reference import it,
through the ``jax_ref`` fixture. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as k1_module
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
from repro_torch.kernels.shared_prefix_attention import (
    launch_plan,
    shared_prefix_attention,
    shared_prefix_attention_plain,
)
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

DTYPES = ["float32", "bfloat16"]
K1_GRID = [                      # B, H, KV, D, page, P, pps (tests/test_kernels.py)
    (4, 8, 4, 64, 16, 32, 6),
    (2, 4, 1, 128, 8, 16, 4),    # MQA
    (3, 6, 6, 64, 32, 12, 3),    # MHA
    (2, 56, 8, 128, 16, 24, 6),  # G = 7 (yi-34b heads)
    (3, 10, 1, 256, 16, 16, 5),  # G = 10 at D = 256 (recurrentgemma-2b): two n-tiles
    (2, 20, 1, 64, 8, 8, 4),     # G = 20: two passes of 16 rows
    (2, 4, 2, 256, 64, 8, 3),    # page = 64 at D = 256: a page sliced over stages
    (2, 8, 4, 64, 12, 16, 5),    # page = 12: boxes of 16 rows, 4 past the page
    (2, 16, 8, 128, 16, 64, 32),  # ctx ends mid-page and mid-split (K1_LENS)
    (1, 4, 2, 64, 16, 300, 512),  # ctx ~ 4096 of 8192: many splits, some empty
    (3, 8, 2, 128, 16, 200, 128),  # a ctx = 0 row beside long rows
    (4, 16, 8, 128, 16, 200, 128),  # ctx 0, inside the first page, mid-page, full
]
# context lengths of the K1_GRID cases that need given ones (else drawn)
K1_LENS = {
    (2, 16, 8, 128, 16, 64, 32): (200, 77),
    (1, 4, 2, 64, 16, 300, 512): (4093,),
    (3, 8, 2, 128, 16, 200, 128): (0, 2048, 1500),
    (4, 16, 8, 128, 16, 200, 128): (0, 5, 1250, 2048),
}
K2_GRID = [                      # P, M, H, KV, D, S
    (3, 4, 8, 4, 64, 64),
    (2, 2, 4, 1, 128, 100),      # MQA + non-aligned prefix blocks
    (1, 8, 4, 4, 64, 256),
    (2, 32, 8, 2, 64, 300),      # R = 128 rows: eight row tiles; S not a multiple of a chunk
    (1, 3, 6, 3, 128, 520),      # R = 6 rows; the valid length ends inside a later chunk
    (1, 40, 8, 2, 64, 300),      # R = 160: two row tiles a warp
    (1, 26, 56, 8, 128, 300),    # R = 182 (G = 7): two row tiles a warp at D = 128
    (1, 36, 16, 2, 128, 200),    # R = 288: two passes, the second of 32 rows
    (1, 8, 8, 2, 256, 100),      # D = 256, R = 32: key slices merged in turn
    (2, 8, 10, 1, 256, 300),     # D = 256, R = 80 (G = 10)
    (1, 20, 8, 1, 256, 130),     # D = 256, R = 160: two passes
]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _lse_tol(dtype):
    return 5e-2 if dtype == "bfloat16" else 1e-4


@pytest.fixture(scope="module")
def jax_ref():
    """(jax.numpy, the reference's kernels.ops, its kernels.ref)."""
    jnp = pytest.importorskip("jax.numpy", reason="the reference package needs JAX")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jnp, jops, jref


def _t(a, dtype=None):
    """numpy -> torch; float arrays in ``dtype``, cast from f32."""
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


def _j(jnp, a, dtype=None):
    """numpy -> JAX, the same values (and bits) as :func:`_t`."""
    j = jnp.asarray(np.array(a))
    return j.astype(jnp.bfloat16) if dtype == "bfloat16" else j


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _k1_inputs(seed, B, H, KV, D, page, P, pps, zero_ctx=False):
    """q, k_pages, v_pages (f32) and block_tables, context_lens (int32);
    the lengths of K1_LENS where the case has them (``zero_ctx`` then does
    not apply), else drawn, the first 0 with ``zero_ctx``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((KV, P, page, D)).astype(np.float32)
    vp = rng.standard_normal((KV, P, page, D)).astype(np.float32)
    bt = rng.integers(0, P, (B, pps)).astype(np.int32)
    cl = rng.integers(1, pps * page + 1, B).astype(np.int32)
    lens = K1_LENS.get((B, H, KV, D, page, P, pps))
    if lens is not None:
        cl = np.array(lens, np.int32)
    elif zero_ctx:
        cl[0] = 0
    return q, kp, vp, bt, cl


def _k2_inputs(seed, P, M, H, KV, D, S, zero_len=False):
    """q, prefix_k, prefix_v (f32) and prefix_lens (int32)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((P, M, H, D)).astype(np.float32)
    pk = rng.standard_normal((P, S, KV, D)).astype(np.float32)
    pv = rng.standard_normal((P, S, KV, D)).astype(np.float32)
    plens = rng.integers(1, S + 1, P).astype(np.int32)
    if zero_len:
        plens[0] = 0
    return q, pk, pv, plens


def _both(jnp, arrays, dtype):
    """Float arrays in ``dtype``, int arrays as they are, for each side."""
    pick = lambda a: dtype if a.dtype == np.float32 else None  # noqa: E731
    return ([_j(jnp, a, pick(a)) for a in arrays], [_t(a, pick(a)) for a in arrays])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,KV,D,page,P,pps", K1_GRID)
def test_paged_attention_matches_pallas(jax_ref, B, H, KV, D, page, P, pps, dtype):
    jnp, jops, _ = jax_ref
    ja, ta = _both(jnp, _k1_inputs(0, B, H, KV, D, page, P, pps), dtype)
    want = jops.paged_attention(*ja, interpret=True)
    got = ops.paged_attention(*ta)
    assert got.dtype == ta[0].dtype and got.shape == (B, H, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype))


def test_paged_attention_zero_context_follows_the_pallas_kernel(jax_ref):
    """ctx = 0: the Pallas kernel returns zeros (its oracle a uniform mean
    of V); the port's plain path follows the kernel."""
    jnp, jops, _ = jax_ref
    ja, ta = _both(jnp, _k1_inputs(1, 3, 4, 2, 64, 8, 16, 4, zero_ctx=True), "float32")
    want = jops.paged_attention(*ja, interpret=True)
    got = ops.paged_attention(*ta)
    np.testing.assert_array_equal(_np(got)[0], 0.0)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    oracle = ref.reference_paged_attention(*ta)
    assert np.abs(_np(oracle)[0]).max() > 0.1   # the oracle's own semantics


def test_paged_attention_oracle_matches_reference_oracle(jax_ref):
    jnp, _, jref = jax_ref
    ja, ta = _both(jnp, _k1_inputs(2, 3, 8, 4, 64, 16, 32, 6, zero_ctx=True), "float32")
    want = jref.reference_paged_attention(*ja)
    got = ref.reference_paged_attention(*ta)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,M,H,KV,D,S", K2_GRID)
def test_shared_prefix_attention_matches_pallas(jax_ref, P, M, H, KV, D, S, dtype):
    jnp, jops, _ = jax_ref
    ja, ta = _both(jnp, _k2_inputs(0, P, M, H, KV, D, S), dtype)
    want_o, want_l = jops.shared_prefix_attention(*ja, block_s=32, interpret=True)
    got_o, got_l = ops.shared_prefix_attention(*ta, block_s=32)
    assert got_o.dtype == ta[0].dtype and got_l.dtype == torch.float32
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=_tol(dtype))
    np.testing.assert_allclose(_np(got_l), _np(want_l), atol=_lse_tol(dtype))


def test_shared_prefix_zero_length_follows_the_pallas_kernel(jax_ref):
    """prefix_len = 0: the Pallas kernel gives out = 0 and lse = -1e30."""
    jnp, jops, _ = jax_ref
    ja, ta = _both(jnp, _k2_inputs(1, 2, 3, 4, 2, 64, 48, zero_len=True), "float32")
    want_o, want_l = jops.shared_prefix_attention(*ja, block_s=16, interpret=True)
    got_o, got_l = ops.shared_prefix_attention(*ta, block_s=16)
    np.testing.assert_array_equal(_np(got_o)[0], 0.0)
    np.testing.assert_allclose(_np(got_o), _np(want_o), atol=2e-5)
    assert np.all(_np(got_l)[0] <= -1e29) and np.all(_np(want_l)[0] <= -1e29)
    np.testing.assert_allclose(_np(got_l)[1:], _np(want_l)[1:], atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_prefix_decode_matches_reference(jax_ref, dtype):
    jnp, jops, _ = jax_ref
    P, M, H, KV, D, S, Ss = 2, 3, 8, 4, 64, 48, 24
    rng = np.random.default_rng(3)
    floats = [rng.standard_normal(shape).astype(np.float32) for shape in (
        (P, M, H, D), (P, S, KV, D), (P, S, KV, D), (P, M, Ss, KV, D), (P, M, Ss, KV, D))]
    plens = np.array([S, 17], np.int32)
    slens = rng.integers(1, Ss + 1, (P, M)).astype(np.int32)
    ja, ta = _both(jnp, floats[:3] + [plens] + floats[3:] + [slens], dtype)
    want = jops.shared_prefix_decode(*ja)
    got = ops.shared_prefix_decode(*ta)
    assert got.dtype == ta[0].dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=_tol(dtype))


def test_lse_merge_equals_joint_attention(jax_ref):
    """Merging prefix + suffix partials == attention over concatenated KV,
    in the port, and the merge equals the reference's."""
    jnp, _, jref = jax_ref
    B, T, H, KV, D, S1, S2 = 2, 1, 4, 2, 32, 24, 16
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in (
        (B, T, H, D), (B, S1, KV, D), (B, S1, KV, D), (B, S2, KV, D), (B, S2, KV, D))]
    (jq, jk1, jv1, jk2, jv2), (q, k1, v1, k2, v2) = _both(jnp, arrays, "float32")
    o1, l1 = ref.reference_attention_with_lse(q, k1, v1)
    o2, l2 = ref.reference_attention_with_lse(q, k2, v2)
    merged = ref.lse_merge(o1, l1, o2, l2)
    joint = ref.reference_attention(q, torch.cat([k1, k2], 1), torch.cat([v1, v2], 1),
                                    causal=False)
    np.testing.assert_allclose(_np(merged), _np(joint), atol=1e-5)
    jo1, jl1 = jref.reference_attention_with_lse(jq, jk1, jv1)
    jo2, jl2 = jref.reference_attention_with_lse(jq, jk2, jv2)
    np.testing.assert_allclose(_np(merged), _np(jref.lse_merge(jo1, jl1, jo2, jl2)), atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_reference_oracle(jax_ref, causal):
    jnp, _, jref = jax_ref
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32))]
    ja, ta = _both(jnp, arrays + [np.array([40, 13], np.int32)], "float32")
    want = jref.reference_attention(*ja[:3], causal=causal, kv_valid_len=ja[3])
    got = ref.reference_attention(*ta[:3], causal=causal, kv_valid_len=ta[3])
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


# -- CUDA kernels against their plain versions (skip without a card) -------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _on(dev, arrays, dtype):
    return [_t(a, dtype if a.dtype == np.float32 else None).to(dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,H,KV,D,page,P,pps", K1_GRID)
def test_paged_attention_kernel_matches_plain(cuda_device, B, H, KV, D, page, P, pps, dtype):
    args = _on(cuda_device, _k1_inputs(6, B, H, KV, D, page, P, pps, zero_ctx=True), dtype)
    before = paged_attention.launches
    got = paged_attention(*args)
    torch.cuda.synchronize()
    assert paged_attention.launches == before + 1
    want = paged_attention_plain(*args)
    got, cl = _np(got.cpu()), args[4].cpu().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[cl <= 0], 0.0)     # a row with no token: zeros
    np.testing.assert_allclose(got, _np(want.cpu()), atol=_tol(dtype))


@pytest.mark.parametrize("B,H,KV", [(2**22, 64, 8), (1, 65536, 1)])
def test_paged_attention_check_refuses_grids_past_cuda_limits(B, H, KV):
    """The wrapper's checks refuse sizes whose grid CUDA cannot launch
    (2^31 - 1 blocks on x, 65535 on y and z); meta tensors hold no data."""
    meta = dict(device="meta", dtype=torch.bfloat16)
    q = torch.empty((B, H, 64), **meta)
    pages = torch.empty((KV, 4, 16, 64), **meta)
    bt = torch.empty((B, 2), device="meta", dtype=torch.int32)
    cl = torch.empty((B,), device="meta", dtype=torch.int32)
    with pytest.raises(ValueError, match="grid"):
        k1_module._check(q, pages, pages, bt, cl)
    k1_module._check(q[:1, :16], pages[:1], pages[:1], bt[:1], cl[:1])   # a size it takes


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
def test_paged_attention_plan_fits_shared_memory(cuda_device, D):
    """Every group size, page size and batch x context, from 1 x 16 to
    128 x 4096, gets a bf16 launch whose shared memory fits a block
    (227 KiB) and whose cluster is at most the portable 8 blocks."""
    for G in (1, 2, 4, 7, 8, 10):
        for page in (8, 16, 32, 64):
            for B, ctx in ((1, 16), (1, 4096), (4, 4096), (64, 1280), (128, 4096)):
                plan = k1_module.launch_plan(B, 8 * G, 8, D, page, ctx, torch.bfloat16)
                assert plan["stages"] >= 3 and 1 <= plan["cluster"] <= 8, (G, page, B, ctx, plan)
                assert plan["smem_bytes"] <= 232448, (G, page, B, ctx, plan)
                assert plan["tokens_per_stage"] % 16 == 0, plan
                # where sequences are split, all their clusters fit on the card at once
                assert plan["cluster"] == 1 or plan["clusters_at_once"] >= B * 8, plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P,M,H,KV,D,S", K2_GRID)
def test_shared_prefix_kernel_matches_plain(cuda_device, P, M, H, KV, D, S, dtype):
    # prefix 0 has length 0 where another prefix keeps a length to check
    args = _on(cuda_device, _k2_inputs(6, P, M, H, KV, D, S, zero_len=P > 1), dtype)
    before = shared_prefix_attention.launches
    got_o, got_l = shared_prefix_attention(*args, block_s=32 if S <= 256 else 128)
    torch.cuda.synchronize()
    assert shared_prefix_attention.launches == before + 1
    want_o, want_l = shared_prefix_attention_plain(*args)
    np.testing.assert_allclose(_np(got_o.cpu()), _np(want_o.cpu()), atol=_tol(dtype))
    np.testing.assert_allclose(_np(got_l.cpu()), _np(want_l.cpu()), atol=_lse_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_shared_prefix_kernel_with_empty_chunks(cuda_device, dtype):
    """A long prefix split across many chunks, with lengths from 0 to S:
    chunks past a prefix's length are empty (all of them where it is 0),
    and the merge must give no NaN, out = 0 and lse = -1e30 at length 0."""
    P, M, H, KV, D, S = 4, 4, 16, 8, 128, 4096
    q, pk, pv, _ = _k2_inputs(7, P, M, H, KV, D, S)
    plens = np.array([0, 1, 1000, S], np.int32)
    args = _on(cuda_device, [q, pk, pv, plens], dtype)
    got_o, got_l = shared_prefix_attention(*args)
    torch.cuda.synchronize()
    want_o, want_l = shared_prefix_attention_plain(*args)
    go, gl = _np(got_o.cpu()), _np(got_l.cpu())
    assert np.isfinite(go).all() and not np.isnan(gl).any()
    np.testing.assert_array_equal(go[0], 0.0)
    np.testing.assert_array_equal(gl[0], np.float32(-1e30))
    np.testing.assert_allclose(go, _np(want_o.cpu()), atol=_tol(dtype))
    np.testing.assert_allclose(gl, _np(want_l.cpu()), atol=_lse_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 256])
def test_shared_prefix_plan_fits_shared_memory(cuda_device, D):
    """Every group size, from one row to several passes, gets a launch of
    the bf16 kernel whose shared memory fits a block (227 KiB)."""
    for G in (1, 2, 4, 7, 8, 10):
        for M in (1, 3, 16, 26, 40, 64, 100):
            for S, block_s in ((100, 32), (1024, 128), (4096, 128)):
                plan = launch_plan(4, M, 8 * G, 8, D, S, block_s)
                assert plan is not None and plan["stages"] >= 1
                assert plan["smem_bytes"] <= 232448, (G, M, S, plan)
