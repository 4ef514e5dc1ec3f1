"""The port's MoE feed-forward against the reference's ``moe_apply``, on
the CPU, in f32.

Reduced granite-moe-1b (E = 8, top-2, no shared expert) and reduced
deepseek-v2 (E = 8, top-2, two shared experts), the reference's
parameters carried across as numpy, inputs from a seed. Outputs and the
aux loss are held to atol 1e-5 (observed below 6e-7: the same products, sums
in another order). The capacity drops, the drop-free decode case, the
lower-index rule for ties and the per-chunk capacity of the launcher's
``moe_chunks`` must be the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import shardctx as jshardctx
from repro_torch.configs import get_config
from repro_torch.models import make_model, moe, shardctx
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

ATOL = 1e-5
CONFIGS = ["granite-moe-1b-a400m", "deepseek-v2-236b"]


def _setup(name, seed=0):
    jcfg, cfg = jget_config(name).reduced(), get_config(name).reduced()
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, cfg, jp, p


def _x(cfg, B, T, seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, cfg.d_model)).astype(np.float32)


def _both(jcfg, cfg, jp, p, x, **kw):
    want, jaux = jmoe.moe_apply(jnp.asarray(x), jp, jcfg, **kw)
    got, aux = moe.moe_apply(torch.from_numpy(x), p, cfg, **kw)
    return (got.numpy(), float(aux)), (np.asarray(want), float(jaux))


def _route(cfg, p, x, **kw):
    return moe.moe_route(torch.from_numpy(x.reshape(-1, x.shape[-1])), p, cfg, **kw)


@pytest.mark.parametrize("name", CONFIGS)
def test_moe_init_tree_matches_reference(name):
    jcfg, cfg, jp, _ = _setup(name)
    port = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    assert jax.tree.map(lambda a: tuple(a.shape), port) == \
        jax.tree.map(lambda a: tuple(a.shape), jp)
    assert port["router"].dtype == torch.float32 == moe.moe_init(
        torch.Generator().manual_seed(0), cfg, torch.bfloat16)["router"].dtype   # router in f32
    assert ("shared" in port) == (cfg.n_shared_experts > 0)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0], ids=["cf1.25", "drops", "drop-free"])
def test_moe_apply_matches_reference(name, cf):
    """Training/prefill capacity. At cf = 0.5 the capacity is half the
    mean load, so assignments are dropped, and the reference drops the
    same ones: the outputs agree. At cf = E nothing can be dropped."""
    jcfg, cfg, jp, p = _setup(name)
    x = _x(cfg, 2, 24)
    (got, aux), (want, jaux) = _both(jcfg, cfg, jp, p, x, capacity_factor=cf)
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(jaux, abs=ATOL)
    keep = _route(cfg, p, x, capacity_factor=cf)["keep"]
    if cf < 1:
        assert int((~keep).sum()) > 0
    if cf == cfg.n_experts:
        assert bool(keep.all())


@pytest.mark.parametrize("name", CONFIGS)
def test_moe_no_drop_decode_matches_reference(name):
    """The decode path: C = N, nothing is dropped."""
    jcfg, cfg, jp, p = _setup(name)
    x = _x(cfg, 3, 1, seed=2)
    (got, aux), (want, jaux) = _both(jcfg, cfg, jp, p, x, no_drop=True)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(jaux, abs=ATOL)
    r = _route(cfg, p, x, no_drop=True)
    assert r["C"] == 3 and bool(r["keep"].all())


@pytest.mark.parametrize("name", CONFIGS)
def test_equal_router_logits_pick_the_lowest_experts(name):
    """A zero router gives every expert the same probability: top-k must
    be experts 0..k-1 for every token, as jax.lax.top_k breaks ties."""
    jcfg, cfg, jp, p = _setup(name)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = _x(cfg, 2, 8, seed=3)
    r = _route(cfg, p, x)
    assert r["top_i"].tolist() == [list(range(cfg.top_k))] * 16
    (got, aux), (want, jaux) = _both(jcfg, cfg, jp, p, x)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(jaux, abs=ATOL)
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    assert moe.top_k_lower_index(probs, 3)[1].tolist() == [[1, 2, 4]]
    assert np.asarray(jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1]).tolist() == [[1, 2, 4]]


def test_moe_chunks_per_chunk_capacity_matches_reference():
    """The launcher's per-shard capacity (``moe_chunks`` in shardctx): a
    different drop pattern, the same in both packages."""
    jcfg, cfg, jp, p = _setup("granite-moe-1b-a400m")
    x = _x(cfg, 2, 24, seed=4)
    with jshardctx.rules({"moe_chunks": 4}), shardctx.rules({"moe_chunks": 4}):
        (got, aux), (want, jaux) = _both(jcfg, cfg, jp, p, x, capacity_factor=0.75)
        chunked = _route(cfg, p, x, capacity_factor=0.75)["keep"]
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert aux == pytest.approx(jaux, abs=ATOL)
    assert not torch.equal(chunked, _route(cfg, p, x, capacity_factor=0.75)["keep"])


def test_transformer_honours_the_moe_apply_override():
    """TransformerLM._moe runs an installed ``moe_apply`` and falls back to
    the gather dispatch when it returns None; decode never consults it."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    m = make_model(cfg, compute_dtype=torch.float32)
    params = m.init(torch.Generator().manual_seed(0))
    toks = {"tokens": torch.randint(0, cfg.vocab_size, (1, 6),
                                    generator=torch.Generator().manual_seed(1))}
    base = m.forward_logits(params, toks)
    calls = []

    def declined(h, p, c, *, capacity_factor):
        calls.append(capacity_factor)
        return None

    with shardctx.rules({"moe_apply": declined}):
        np.testing.assert_array_equal(m.forward_logits(params, toks).numpy(), base.numpy())
        _, caches = m.prefill(params, toks, 8)
        n = len(calls)
        m.decode_step(params, toks["tokens"][:, -1:], caches, torch.tensor([6]))
    assert calls == [cfg.capacity_factor] * n and n == 2 * cfg.n_layers
    with shardctx.rules({"moe_apply": lambda h, p, c, **kw: (torch.zeros_like(h),
                                                             torch.zeros(()))}):
        assert not torch.allclose(m.forward_logits(params, toks), base)


# ----------------------------------------------------------------------
# dispatch and combine as autograd functions against the plain gathers
# ----------------------------------------------------------------------

def _gather_dispatch(xf, r, E):
    """The dispatch as plain autograd sees it: an int32 slot -> token
    table (empty slots token 0), one gather; its backward a scatter-add."""
    N = xf.shape[0]
    C, dest = r["C"], r["dest"]
    slot_tok = torch.zeros((E * C + 1,), dtype=torch.int32)
    for j in range(dest.shape[1]):
        slot_tok[dest[:, j]] = torch.arange(N, dtype=torch.int32)
    return xf[slot_tok[: E * C].reshape(E, C).long()]


def _gather_combine(ye, r, dtype):
    """The combine as plain autograd sees it: dropped choices clamped onto
    the last slot at weight 0, one gather a choice, summed in f32 (f64 for
    f64 inputs)."""
    E, C, d = ye.shape
    acc = torch.promote_types(ye.dtype, torch.float32)
    out = torch.zeros((r["dest"].shape[0], d), dtype=acc)
    for j in range(r["dest"].shape[1]):
        w_j = (r["top_w"][:, j] * r["keep"][:, j]).to(acc)
        slot = torch.clamp(r["dest"][:, j], max=E * C - 1)
        out = out + ye[slot // C, slot % C].to(acc) * w_j[:, None]
    return out.to(dtype)


CASES = {  # name: (capacity factor, no_drop, moe_chunks, held experts from)
    "drops": (0.5, False, 1, None),
    "empty": (8.0, False, 1, None),
    "no_drop": (1.25, True, 1, None),
    "held": (1.25, False, 1, 4),
    "chunks": (0.75, False, 4, None),
}


def _moe_grads(cfg, p, x, ct, case, plain):
    """The MoE layer's output on ``x`` and the gradients of <out, ct> + aux
    with respect to x, the router and the three expert weights: through
    ``moe_apply``, or (``held``) through the held experts' dispatch and
    combine alone; with the port's functions or the plain gathers."""
    cf, no_drop, chunks, first = CASES[case]
    p = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    x = x.clone().requires_grad_(True)
    dispatch, combine = (_gather_dispatch, _gather_combine) if plain else \
        (moe.moe_dispatch, moe.moe_gather)
    with shardctx.rules({"moe_chunks": chunks}):
        xf = x.reshape(-1, x.shape[-1])
        r = moe.moe_route(xf, p, cfg, capacity_factor=cf, no_drop=no_drop)
    E = cfg.n_experts
    w = p
    if first is not None:
        E -= first
        r = moe.held_routing(r, first, E)
        w = {k: v[first:] for k, v in p.items() if k != "router"}
    out = combine(moe.expert_ffn(dispatch(xf, r, E), w), r, x.dtype)
    loss = (out.to(ct.dtype) * ct.reshape(out.shape)).sum() + r["aux"]
    names = ["router", "w_gate", "w_up", "w_down"]
    grads = torch.autograd.grad(loss, [x] + [p[n] for n in names])
    return out, dict(zip(["x"] + names, grads)), r


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16], ids=["f64", "bf16"])
def test_dispatch_and_combine_functions_match_the_plain_gathers(name, case, dtype):
    """The combine's output bit for bit, and the gradients of x, the
    router (through ``top_w``) and the experts: at 1e-12 in f64, at ATOL in
    bf16. ``empty``, ``no_drop`` and ``held`` leave slots empty; ``drops``,
    ``chunks`` and ``held`` drop choices (``held`` routes to experts 4..
    alone, the others' choices on the sentinel)."""
    cfg = get_config(name).reduced()
    p = {k: v.to(dtype) if k != "router" else v.double() if dtype == torch.float64 else v
         for k, v in moe.moe_init(torch.Generator().manual_seed(0), cfg).items()
         if k != "shared"}
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 24, cfg.d_model), generator=gen).to(dtype)
    ct = torch.randn((2, 24, cfg.d_model), generator=gen, dtype=torch.float64)
    out, grads, r = _moe_grads(cfg, p, x, ct, case, plain=False)
    want, want_grads, _ = _moe_grads(cfg, p, x, ct, case, plain=True)
    assert out.dtype == want.dtype == dtype and torch.equal(out, want)
    atol = 1e-12 if dtype == torch.float64 else ATOL
    for key, g in grads.items():
        np.testing.assert_allclose(g.double().numpy(), want_grads[key].double().numpy(),
                                   atol=atol, err_msg=key)
        assert float(g.abs().max()) > 0, key
    E = cfg.n_experts - (4 if case == "held" else 0)
    if case in ("empty", "no_drop", "held"):
        assert int((r["dest"] < E * r["C"]).sum()) < E * r["C"]         # empty slots
    assert bool((~r["keep"]).any()) == (case in ("drops", "chunks", "held"))


def _scan_positions(top_i, E, chunks):
    """Each choice's position in its expert, one scan a choice j in token
    order on top of the counts of choices j' < j, chunk by chunk."""
    N, k = top_i.shape
    ti = top_i.reshape(chunks, N // chunks, k)
    pos = torch.zeros_like(ti)
    counts = torch.zeros((chunks, E), dtype=ti.dtype)
    for j in range(k):
        oh = torch.nn.functional.one_hot(ti[:, :, j], E)
        within = torch.cumsum(oh, dim=1) - oh
        pos[:, :, j] = within.gather(2, ti[:, :, j:j + 1])[:, :, 0] + counts.gather(1, ti[:, :, j])
        counts = counts + oh.sum(dim=1)
    return pos.reshape(N, k)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("case", ["drops", "empty", "no_drop", "chunks"])
def test_route_positions_match_the_per_choice_scan(name, case):
    """``moe_route``'s one scan over all choices places every choice where
    k scans, one a choice, place it: the same ``keep`` and ``dest``."""
    cf, no_drop, chunks, _ = CASES[case]
    jcfg, cfg, jp, p = _setup(name)
    x = _x(cfg, 2, 24, seed=6)
    with shardctx.rules({"moe_chunks": chunks}):
        r = _route(cfg, p, x, capacity_factor=cf, no_drop=no_drop)
    pos = _scan_positions(r["top_i"], cfg.n_experts, chunks)
    Cc = r["C"] // chunks
    chunk_of = torch.arange(pos.shape[0])[:, None] // (pos.shape[0] // chunks)
    assert torch.equal(r["keep"], pos < Cc)
    assert torch.equal(r["dest"], torch.where(pos < Cc, r["top_i"] * r["C"] + chunk_of * Cc + pos,
                                              cfg.n_experts * r["C"]))


def _graph_nodes(t):
    """Every autograd node ``t`` reaches."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo.extend(f for f, _ in fn.next_functions)
    return seen


INDEX_NODES = {"IndexBackward0", "IndexPutBackward0"}


def test_the_moe_backward_has_no_index_scatter():
    """Neither ``moe_apply``'s graph nor a tiny granite's loss graph holds
    an index node of the MoE (whose backward is a sorted scatter-add): the
    dispatch and the combine are the two functions, and the embedding's
    row gather is ``F.embedding``'s (its backward sums a row's repeats in
    f32 on CUDA), so the loss holds no index node at all."""
    jcfg, cfg, jp, p = _setup("granite-moe-1b-a400m")
    x = torch.from_numpy(_x(cfg, 2, 24)).requires_grad_(True)
    p = {k: v.requires_grad_(True) for k, v in p.items()}
    out, aux = moe.moe_apply(x, p, cfg, capacity_factor=0.5)
    names = {type(fn).__name__ for fn in _graph_nodes(out + aux)}
    assert {"_DispatchBackward", "_CombineBackward"} <= names
    assert not names & INDEX_NODES
    m = make_model(cfg, compute_dtype=torch.float32)
    params = m.init(torch.Generator().manual_seed(0))
    for v in jax.tree.leaves(params):
        v.requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    loss, _ = m.loss(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    nodes = _graph_nodes(loss)
    names = [type(fn).__name__ for fn in nodes]
    assert names.count("_CombineBackward") == names.count("_DispatchBackward") == cfg.n_layers
    assert not set(names) & INDEX_NODES
    embed = [fn for fn in nodes if type(fn).__name__ == "EmbeddingBackward0"]
    assert len(embed) == 1
    assert embed[0].next_functions[0][0].variable is params["embed"]


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_a_backward_counts_two_transposed_backwards_a_moe_layer(remat):
    """``moe.transposed_backward`` counts one backward of the dispatch and
    one of the combine a layer, with remat's recomputed forward too."""
    from repro_torch import tracing

    cfg = get_config("granite-moe-1b-a400m").reduced()
    m = make_model(cfg, compute_dtype=torch.float32, remat=remat)
    params = m.init(torch.Generator().manual_seed(0))
    leaves = jax.tree.leaves(params)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(1))
    for v in leaves:
        v.requires_grad_(True)
    before = tracing.counter_totals.get("moe.transposed_backward", 0)
    loss, _ = m.loss(params, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert tracing.counter_totals.get("moe.transposed_backward", 0) == before
    torch.autograd.grad(loss, leaves)
    assert tracing.counter_totals["moe.transposed_backward"] - before == 2 * cfg.n_layers
