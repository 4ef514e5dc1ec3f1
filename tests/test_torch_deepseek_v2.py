"""DeepSeek-V2's training path in the port (``first_k_dense`` leading dense
layers, group-limited greedy routing, no renormalisation, routed scaling,
the sequence-wise balance loss, a layer holding a share of the experts)
against the benchmark's plain reference ``chipbench/reference/deepseek_v2.py``,
on the CPU in f32, at the tiny size of ``chipbench/tests/test_chipbench_deepseek_v2.py``:
1 dense + 2 MoE layers, 2 groups of 4 experts, 1 group a token, k 2, 2 held.

The loss is held at 1e-5 and every gradient leaf at 1e-4 of its norm
(the same products in f32, summed in other orders). The routing is held
to a loop over tokens, index for index, ties included. The published
YaRN rotation and softmax scale are the reference's. The shares of the
expert-parallel layer add up to the whole layer. Granite's MoE, with
every new field at its default, is the code before them bit for bit: a
frozen copy of that routing and combine below.
"""

import dataclasses
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipbench.archs import deepseek_v2 as ds  # noqa: E402
from chipbench.harness import weights  # noqa: E402
from chipbench.reference import deepseek_v2 as ref  # noqa: E402
from chipbench.tests.test_chipbench_deepseek_v2 import full_config, tiny_config  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, make_model, moe, shardctx  # noqa: E402
from repro_torch.models.attention import mla_scale  # noqa: E402
from repro_torch.models.layers import apply_rope, matmul, mlp_apply  # noqa: E402
from repro_torch.training import AdamWConfig, TrainConfig  # noqa: E402
from repro_torch.training.train_step import make_grad_fn  # noqa: E402
from torch_threads import one_intra_op_thread  # noqa: E402,F401  (an autouse fixture)

SEED, B, T = 1_234_567_891, 2, 32
COUNTERS = ("moe.group_limited", "moe.held_only")


def _setup(**file):
    c = tiny_config(full_config())
    c.update(file)
    flat = weights.flat(c, SEED, torch.device("cpu"))
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, c["vocab_size"], (B, T + 1), generator=gen)
    return c, flat, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _port_loss_and_grads(c, flat, batch, remat):
    model = make_model(ds.arch_config(c), param_dtype=torch.float32,
                       compute_dtype=torch.float32, remat=remat)
    params = {n: t.clone().requires_grad_() for n, t in flat.items()}
    loss, _ = model.loss(weights.nest(params), batch)
    return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


def _ref_loss_and_grads(c, flat, batch, remat):
    params = {n: t.clone().requires_grad_() for n, t in flat.items()}
    loss = ref.loss(params, c, batch, remat=remat)
    return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_the_loss_and_every_gradient_match_the_reference(remat):
    c, flat, batch = _setup()
    loss, grads = _port_loss_and_grads(c, flat, batch, remat)
    want, want_grads = _ref_loss_and_grads(c, flat, batch, remat)
    assert abs(float(loss.detach()) - float(want.detach())) <= 1e-5
    assert set(grads) == set(want_grads)
    for n, g in grads.items():
        w = want_grads[n]
        gap = float(torch.linalg.vector_norm(g - w)) / max(float(torch.linalg.vector_norm(w)),
                                                           1e-30)
        assert gap <= 1e-4, (n, gap)
        if not n.endswith("q_a_norm/scale"):
            assert float(w.abs().max()) > 0, n


def test_the_reference_drops_and_limits_as_the_port_does():
    """At the tiny size some choices overflow their expert and the group
    limit moves some tokens' choices: the loss test above holds both."""
    c, flat, batch = _setup()
    x = torch.randn((B * T, c["hidden_size"]), generator=torch.Generator().manual_seed(2))
    router = flat["blocks/g0/ffn/router"][0]
    scores, _, idx = ref.route(x, router, c)
    plain = torch.sort(scores, dim=-1, descending=True, stable=True)[1][:, :2]
    assert not torch.equal(idx, plain)
    assert not bool(ref.kept(idx, dict(c, assumed=dict(c["assumed"], capacity_factor=0.5))).all())


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_the_yarn_rope_and_scale_are_the_references(size):
    """The published ``rope_scaling`` (YaRN, factor 40 over 4096) gives the
    reference's rotation and softmax scale; the plain rope it replaces is
    far from it. Positions up to 4096 at the cell's rope width: the port
    takes its angles in f32, the reference in f64."""
    c = full_config() if size == "full" else tiny_config(full_config())
    cfg = ds.arch_config(c)
    dr = c["qk_rope_head_dim"]
    x = torch.randn((1, 4096, 2, dr), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    pos = torch.arange(4096)
    want = ref.rotary(x, pos, c)
    got = apply_rope(x.float(), pos, cfg.rope_theta, cfg.rope_yarn).double()
    torch.testing.assert_close(got[:, :256], want[:, :256], atol=1e-4, rtol=0)
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
    plain = apply_rope(x.float(), pos, cfg.rope_theta).double()
    assert float((plain[:, :256] - want[:, :256]).abs().max()) > 1e-2
    assert abs(mla_scale(cfg) - ref.softmax_scale(c)) <= 1e-15
    assert abs(mla_scale(cfg) * (c["qk_nope_head_dim"] + dr) ** 0.5 - 1.5896261651) <= 1e-9


def test_the_yarn_decode_is_the_expanded_forward():
    """Under YaRN the absorbed decode (the latent cache, rope keys cached
    rotated) gives the expanded forward's output at each position."""
    cfg = ds.arch_config(tiny_config(full_config()))
    assert cfg.rope_yarn
    p = attention.mla_init(torch.Generator().manual_seed(3), cfg)
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(4))
    full = attention.mla_forward(x, p, cfg)
    _, c = attention.mla_prefill(x[:, :8], p, cfg, 12)
    for t in range(8, 12):
        d, c = attention.mla_decode_step(x[:, t:t + 1], p, cfg, c, torch.full((2,), t))
        torch.testing.assert_close(d[:, 0], full[:, t], atol=1e-5, rtol=0)


def _loop_top_k(probs, k, n_group, topk_group):
    """Group-limited greedy top-k, token by token, in plain Python."""
    N, E = probs.shape
    size = E // n_group
    out = []
    for row in probs.tolist():
        best = [max(row[g * size:(g + 1) * size]) for g in range(n_group)]
        groups = sorted(range(n_group), key=lambda g: (-best[g], g))[:topk_group]
        experts = [e for e in range(E) if e // size in groups]
        out.append(sorted(experts, key=lambda e: (-row[e], e))[:k])
    return torch.tensor(out)


@pytest.mark.parametrize("E,n_group,topk_group,k", [(8, 2, 1, 2), (16, 4, 2, 3), (160, 8, 3, 6)])
def test_group_limited_routing_matches_a_loop_over_tokens(E, n_group, topk_group, k):
    """Exact indices, on scores with ties among experts and among groups
    (scores rounded to a few values), and on the router's own scores."""
    gen = torch.Generator().manual_seed(E)
    tied = torch.randint(0, 4, (64, E), generator=gen).float()
    tied = tied / tied.sum(-1, keepdim=True).clamp(min=1)
    for probs in (tied, torch.softmax(torch.randn((64, E), generator=gen), -1)):
        w, idx = moe.group_limited_top_k(probs, k, n_group, topk_group)
        assert torch.equal(idx, _loop_top_k(probs, k, n_group, topk_group))
        assert torch.equal(w, probs.gather(1, idx))
    cfg = dataclasses.replace(get_config("deepseek-v2-236b").reduced(), n_experts=E, top_k=k,
                              n_group=n_group, topk_group=topk_group)
    d = cfg.d_model
    router = torch.randn((d, E), generator=gen)
    router[:, 1] = router[:, 0]                     # experts 0 and 1 tie on every token
    xf = torch.randn((48, d), generator=gen)
    before = tracing.counter_totals.get("moe.group_limited", 0)
    r = moe.moe_route(xf, {"router": router}, cfg, capacity_factor=2.0)
    assert tracing.counter_totals["moe.group_limited"] == before + 1
    probs = torch.softmax(matmul(xf, router), -1)
    assert torch.equal(r["top_i"], _loop_top_k(probs, k, n_group, topk_group))


def test_the_routed_weights_are_scaled_and_not_renormalised():
    c, flat, _ = _setup()
    cfg = ds.arch_config(c)
    xf = torch.randn((B * T, cfg.d_model), generator=torch.Generator().manual_seed(4))
    router = flat["blocks/g0/ffn/router"][0]
    r = moe.moe_route(xf, {"router": router}, cfg, capacity_factor=cfg.capacity_factor)
    probs = torch.softmax(xf @ router, -1)
    torch.testing.assert_close(r["top_w"], 16.0 * probs.gather(1, r["top_i"]))
    scores, w, idx = ref.route(xf, router, c)
    assert torch.equal(idx, r["top_i"])
    torch.testing.assert_close(w, r["top_w"])


def test_the_sequence_aux_is_the_references():
    c, flat, _ = _setup()
    cfg = ds.arch_config(c)
    xf = torch.randn((B * T, cfg.d_model), generator=torch.Generator().manual_seed(6))
    router = flat["blocks/g0/ffn/router"][1]
    r = moe.moe_route(xf, {"router": router}, cfg, capacity_factor=1.25, seq_len=T)
    scores, _, idx = ref.route(xf, router, c)
    torch.testing.assert_close(r["aux"], ref.seq_balance(scores, idx, T), atol=1e-6, rtol=1e-6)
    # balanced scores and choices read 1 (k of E each, E / k x k T / E x 1 / E x E)
    N, E = 8, 4
    probs = torch.full((N, E), 1.0 / E)
    top_i = torch.arange(N * 2).reshape(N, 2) % E
    assert float(moe.sequence_aux(probs, top_i, N)) == pytest.approx(1.0)


def test_the_shares_add_up_to_the_whole_layer():
    """The guide's share test: the MoE layer over all 8 experts (the
    reference, uncut) against the port's layer held as each of the 4
    shares of 2, the shared expert counted once."""
    c, flat, _ = _setup()
    whole = dict(c, n_routed_experts=8)
    wflat = weights.flat(whole, SEED, torch.device("cpu"))
    p = {n[len("blocks/g0/ffn/"):]: t[0] for n, t in wflat.items()
         if n.startswith("blocks/g0/ffn/")}
    x = torch.randn((B * T, c["hidden_size"]), generator=torch.Generator().manual_seed(8))
    want, _ = ref.moe(x, p, whole, None, T)
    shared = mlp_apply(x, {k[len("shared/"):]: v for k, v in p.items()
                           if k.startswith("shared/")})
    parts, ref_parts = [], []
    before = tracing.counter_totals.get("moe.held_only", 0)
    for s in range(4):
        cfg = dataclasses.replace(ds.arch_config(c), expert_first=2 * s)
        held = {k: (v[2 * s:2 * s + 2] if k.startswith("w_") else v) for k, v in p.items()
                if not k.startswith("shared/")}
        held["shared"] = {k[len("shared/"):]: v for k, v in p.items() if k.startswith("shared/")}
        r = moe.moe_route(x, held, cfg, capacity_factor=cfg.capacity_factor, seq_len=T)
        parts.append(moe.moe_combine(x, held, cfg, r))
        ref_parts.append(ref.routed(x, {k: v for k, v in held.items() if k != "shared"},
                                    whole, None, first=2 * s, held=2)[0])
    assert tracing.counter_totals["moe.held_only"] == before + 4
    torch.testing.assert_close(sum(parts) - 3 * shared, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(sum(ref_parts) + shared, want, atol=1e-5, rtol=1e-5)
    assert all(float(q.abs().max()) > 0 for q in ref_parts)


def test_the_counters_count_the_path():
    """A training loss under remat: each MoE layer routes twice (forward,
    and remat's second forward), each time group-limited and held."""
    c, flat, batch = _setup()
    before = {k: tracing.counter_totals.get(k, 0) for k in COUNTERS}
    _port_loss_and_grads(c, flat, batch, remat=True)
    for k in COUNTERS:
        assert tracing.counter_totals[k] - before[k] == 2 * 2, k
    before = {k: tracing.counter_totals.get(k, 0) for k in COUNTERS}
    # every layer held whole and no group limit: neither counts
    _, f2, b2 = _setup(n_routed_experts=8, topk_group=2)
    _port_loss_and_grads(dict(c, n_routed_experts=8, topk_group=2), f2, b2, remat=False)
    assert all(tracing.counter_totals.get(k, 0) == before[k] for k in COUNTERS)


# -- granite with every new field at its default: the code before them ------

def _frozen_route(xf, p, cfg, *, capacity_factor=1.25, no_drop=False, **_):
    """``moe_route`` before the group limit, the scaling, the sequence aux
    and the held share (one chunk, no data parallel)."""
    N = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(matmul(xf.float(), p["router"]), dim=-1)
    top_w, top_i = moe.top_k_lower_index(probs, k)
    if cfg.moe_renormalize:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    f_e = F.one_hot(top_i[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(f_e * probs.mean(dim=0))
    C = N if no_drop else int(max(1, round(capacity_factor * k * N / E)))
    ti = top_i.transpose(0, 1).reshape(1, k * N)
    oh = F.one_hot(ti, E)
    within = torch.cumsum(oh.transpose(1, 2), dim=2).transpose(1, 2) - oh
    pos = within.gather(2, ti[:, :, None]).reshape(1, k, N).transpose(1, 2).reshape(N, k)
    keep = pos < C
    dest = torch.where(keep, top_i * C + pos, E * C)
    return dict(top_w=top_w, top_i=top_i, aux=aux, C=C, keep=keep, dest=dest)


def _frozen_combine(xf, p, cfg, r):
    out = moe.moe_gather(moe.expert_ffn(moe.moe_dispatch(xf, r, cfg.n_experts), p), r, xf.dtype)
    return out + mlp_apply(xf, p["shared"]) if cfg.n_shared_experts > 0 else out


def test_granite_is_bit_for_bit_the_code_before(monkeypatch):
    cfg = get_config("granite-moe-1b-a400m").reduced()
    assert (cfg.first_k_dense, cfg.n_group, cfg.topk_group, cfg.routed_scaling, cfg.seq_aux,
            cfg.aux_coef, cfg.expert_first, cfg.held_experts) == (0, 1, 1, 1.0, False, 0.01, 0,
                                                                  cfg.n_experts)
    model = make_model(cfg, remat=True)
    params = model.init(torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    toks = torch.randint(0, cfg.vocab_size, (2, 25), generator=gen)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    x = torch.randn((2, 24, cfg.d_model), generator=gen)
    p = {k: v[0] for k, v in params["blocks"]["g0"]["ffn"].items()}
    grad_fn = make_grad_fn(model, TrainConfig(optimizer=AdamWConfig()))

    def readings():
        with shardctx.rules({}):
            r = moe.moe_route(x.reshape(-1, cfg.d_model), p, cfg,
                              capacity_factor=cfg.capacity_factor)
            out, aux = moe.moe_apply(x, p, cfg, capacity_factor=cfg.capacity_factor)
            loss, _, grads = grad_fn(params, batch)
        return r, out, aux, loss, weights.unnest(grads)

    new = readings()
    before = {k: tracing.counter_totals.get(k, 0) for k in COUNTERS}
    monkeypatch.setattr(moe, "moe_route", _frozen_route)
    monkeypatch.setattr(moe, "moe_combine", _frozen_combine)
    old = readings()
    assert all(tracing.counter_totals.get(k, 0) == before[k] for k in COUNTERS)
    assert set(new[0]) == set(old[0])
    for k in new[0]:
        assert (new[0][k] == old[0][k]) if k == "C" else torch.equal(new[0][k], old[0][k]), k
    for a, b in zip(new[1:4], old[1:4]):
        assert torch.equal(a, b)
    assert set(new[4]) == set(old[4])
    for n in new[4]:
        assert torch.equal(new[4][n], old[4][n]), n
