"""The plain reference against the port's CPU path (plain PyTorch, f32) at
tiny sizes: the same loss, gradients, AdamW steps, served logits and
cache decisions."""

import numpy as np
import pytest
import torch

from chipbench.tests.tiny import ROOT, tiny_cell  # noqa: I001  (first: puts src/ on the path)
from chipbench.archs import gqa
from chipbench.harness import compare, serve_cell, traffic, weights
from chipbench.reference import model as ref_model
from chipbench.reference import optimizer as ref_opt
from chipbench.reference import train as ref_train

CPU = torch.device("cpu")
TRAIN = ["qwen3-1.7b.train", "granite-moe-1b-a400m.train"]


def test_leaf_specs_are_the_ports_tree():
    from repro_torch.models import make_model

    for name in TRAIN:
        c = tiny_cell(name).config
        want = weights.unnest(make_model(gqa.arch_config(c)).init(
            torch.Generator().manual_seed(0)))
        got = {n: tuple(s) for n, s, _ in gqa.leaf_specs(c)}
        assert got == {n: tuple(t.shape) for n, t in want.items()}


@pytest.mark.parametrize("name", TRAIN)
def test_loss_and_gradients_match_the_port(name):
    from repro_torch.models import make_model
    from repro_torch.training import TrainConfig
    from repro_torch.training.train_step import make_grad_fn

    cell = tiny_cell(name)
    c = cell.config
    params = weights.flat(c, 11, CPU)
    batch = traffic.TokenFeed(11, c["vocab_size"], 2, 32, 1.1, CPU).batch(0)
    model = make_model(gqa.arch_config(c), compute_dtype=torch.float32)
    loss, _, grads = make_grad_fn(model, TrainConfig(compute_dtype=torch.float32))(
        weights.nest(params), batch)
    grads = weights.unnest(grads)
    p = {n: t.clone().requires_grad_() for n, t in params.items()}
    want = ref_model.loss(p, c, batch)
    want_g = dict(zip(p, torch.autograd.grad(want, list(p.values()))))
    assert float(loss) == pytest.approx(float(want.detach()), abs=1e-5)
    for n, g in want_g.items():
        err = float(torch.linalg.vector_norm(grads[n] - g) / torch.linalg.vector_norm(g))
        assert err < 1e-4, (n, err)


@pytest.mark.parametrize("name", TRAIN)
def test_train_readings_match_the_ports_f32_steps(name):
    """Three steps of the port's train step (f32 compute) read as a run
    reads them, against the reference's three: every gap at rounding."""
    from repro_torch.models import make_model
    from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
    from repro_torch.training.optimizer import adamw_init

    from chipbench.harness import train_cell

    cell = tiny_cell(name)
    c, mix = cell.config, cell.traffic
    o = mix["optimizer"]
    step = make_train_step(make_model(gqa.arch_config(c), compute_dtype=torch.float32),
                           TrainConfig(optimizer=AdamWConfig(**o), compute_dtype=torch.float32))
    params = weights.nest(weights.flat(c, 5, CPU))
    state = {"params": params, "opt": adamw_init(params)}
    feed = traffic.TokenFeed(5, c["vocab_size"], mix["batch"], mix["seq"], mix["zipf_alpha"], CPU)
    prog = {"loss": []}
    for k in range(3):
        state, m = step(state, feed.next())
        prog["loss"].append(float(m["loss"]))
        if k == 0:
            prog["grad_norm"] = train_cell.first_grad_norms(state, m, o)
    prog["change_norm"], prog["change_sample"] = train_cell.change_readings(state, c, 5, CPU)
    ref = train_cell.reference_readings(c, mix, 5, CPU)
    got = compare.train_readings(prog, ref)
    assert all(v < 1e-4 for v, _ in got.values()), got


def test_lr_schedule():
    o = {"lr": 1.0, "warmup_steps": 10, "total_steps": 110, "min_lr_frac": 0.1}
    assert ref_opt.lr_at(o, 5) == pytest.approx(0.5)
    assert ref_opt.lr_at(o, 10) == pytest.approx(1.0)
    assert ref_opt.lr_at(o, 60) == pytest.approx(0.55)
    assert ref_opt.lr_at(o, 500) == pytest.approx(0.1)


def test_served_logits_match_the_ports_prefill_and_decode():
    from repro_torch.models import make_model
    from repro_torch.serving.sampler import greedy_decode

    c = tiny_cell("qwen3-1.7b.serve_shared").config
    params = weights.flat(c, 3, CPU)
    model = make_model(gqa.arch_config(c), compute_dtype=torch.float32)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(0, c["vocab_size"], 40))
    with torch.no_grad():
        logits, caches = model.prefill(weights.nest(params), {"tokens": prompt[None]}, 46)
        out = greedy_decode(model, weights.nest(params), logits, caches, start_pos=40,
                            n_steps=6)[0].long()
    rows = gqa.cache_rows(caches, 39, 6)    # the last prompt token's and the decode steps
    gaps, kv = serve_cell.request_gaps(params, c, prompt.numpy(), out, rows, CPU)
    assert float(gaps.max()) < 1e-4 and kv < 1e-4, (float(gaps.max()), kv)


def test_reference_step_matches_a_hand_adamw():
    o = {"lr": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "grad_clip": 1.0,
         "warmup_steps": 1, "total_steps": 10, "min_lr_frac": 0.1}
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.3, 0.4])}                 # norm 0.5: not clipped
    mu = {"w": torch.zeros(2)}
    nu = {"w": torch.zeros(2)}
    ref_opt.adamw_step(p, g, mu, nu, o, 1)
    upd = torch.tensor([1.0, 1.0]) + 0.1 * torch.tensor([1.0, -2.0])    # m/sqrt(v) = sign
    assert torch.allclose(p["w"], torch.tensor([1.0, -2.0]) - 0.1 * upd, atol=1e-6)


@pytest.mark.parametrize("mix", ["serve_shared", "serve_unshared"])
def test_cache_decisions_match_the_engine(mix):
    from repro_torch.serving import EngineConfig, ServingEngine, TenantSpec

    cell = tiny_cell(f"qwen3-1.7b.{mix}")
    c, mx = cell.config, cell.traffic
    mx.update(pool_blocks=96, n_prompts=16)
    bpb = gqa.bytes_per_block(c, mx["block_tokens"])
    eng = ServingEngine(gqa.arch_config(c),
                        [TenantSpec(f"tenant{t}", float(a * bpb))
                         for t, a in enumerate(serve_cell.allocations(mx))],
                        EngineConfig(block_tokens=mx["block_tokens"],
                                     pool_blocks=mx["pool_blocks"]),
                        device=CPU)
    reqs = traffic.ServeStream(mx, c["vocab_size"], 99).requests(300)
    res = [eng.submit(f"tenant{r.tenant}", r.tokens, 4) for r in reqs]
    assert sum(r.evictions for r in res) > 0
    if mix == "serve_shared":
        assert sum(r.ripple_evictions for r in res) > 0 and sum(r.cached_tokens for r in res) > 0
    assert serve_cell.cache_mismatches(mx, list(zip(reqs, res))) == 0
    # one decision off is seen
    res[150].evictions += 1
    assert serve_cell.cache_mismatches(mx, list(zip(reqs, res))) == 1


def test_reference_readings_on_half_the_rows_differ():
    cell = tiny_cell("qwen3-1.7b.train")
    c, mix = cell.config, cell.traffic
    full = ref_train_readings(c, mix)
    half = ref_train_readings(c, mix, slice(0, 2))
    assert compare.train_readings(half, full)["grad_norm_gap"][0] > 0.05


def ref_train_readings(c, mix, rows=slice(None)):
    from chipbench.harness import train_cell

    return train_cell.reference_readings(c, mix, 8, CPU, rows=rows)


def test_readings_module_is_the_references():
    assert ref_train.readings.__module__ == "chipbench.reference.train"
