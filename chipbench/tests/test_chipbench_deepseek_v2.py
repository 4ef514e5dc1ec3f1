"""The DeepSeek-V2 configuration (``configs/deepseek-v2-236b.json``, the
module ``archs/deepseek_v2.py``) at a tiny size on the CPU, its own tiny
file built here: 1 dense + 2 MoE layers, 2 groups of 4 routed experts, 1
group a token, k 2, 2 held, one shared expert, sequences of 32.

The cell's file keeps every published width; its leaves, parameters and
work are pinned from its shapes. The tiny cell runs through
``train_cell.run``: a sound run is correct, each training fault and the
bf16 control are not. The interface's serving parts (cache rows, the
reference's logits and latent rows) agree with the port's prefill.
"""

import copy
import math
import time

import pytest
import torch

from chipbench.tests.tiny import ROOT  # noqa: I001  (first: puts src/ on the path)
from chipbench import archs, faults
from chipbench.archs import deepseek_v2 as ds
from chipbench.harness import compare, manifest, train_cell, weights, yardstick
from chipbench.harness.profiling import Profile, Session
from chipbench.harness.record import Record

CPU = torch.device("cpu")
CELL = "deepseek-v2-236b.train_4k"
SEED = 2_718_281_828


def tiny_config(c: dict) -> dict:
    """The file ``c`` at a CPU's size: every width cut, the settings kept."""
    c = copy.deepcopy(c)
    c.update(num_hidden_layers=3, hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
             q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
             v_head_dim=16, intermediate_size=128, moe_intermediate_size=32, vocab_size=512,
             n_group=2, topk_group=1, num_experts_per_tok=2, n_routed_experts=2,
             n_shared_experts=1)
    c["published"] = dict(c["published"], n_routed_experts=8)
    return c


def tiny_cell() -> manifest.Cell:
    cell = manifest.cell(manifest.load(ROOT), CELL, ROOT)
    cell.config = tiny_config(cell.config)
    cell.traffic.update(batch=2, seq=32, setup_steps=4, profiled_steps=1)
    return cell


def full_config() -> dict:
    return manifest.cell(manifest.load(ROOT), CELL, ROOT).config


def test_the_file_keeps_every_published_width():
    c = full_config()
    assert archs.of(c) is ds
    widths = dict(hidden_size=5120, num_attention_heads=128, num_key_value_heads=128,
                  q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128, intermediate_size=12288, moe_intermediate_size=1536,
                  n_shared_experts=2, num_experts_per_tok=6, n_group=8, topk_group=3,
                  routed_scaling_factor=16, norm_topk_prob=False, first_k_dense_replace=1,
                  seq_aux=True)
    assert {k: c[k] for k in widths} == widths
    assert c["published"]["n_routed_experts"] == 160 and c["n_routed_experts"] == 20
    assert (c["num_hidden_layers"], c["vocab_size"]) == (5, 12800)
    assert c["published"]["num_hidden_layers"] == 60 and c["published"]["vocab_size"] == 102400
    assert c["rope_scaling"] == {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                                 "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                                 "type": "yarn"}
    assert sorted(c["reduced"]) == sorted(k for k in c["published"])
    cfg = ds.arch_config(c)
    assert (cfg.n_experts, cfg.experts_held, cfg.expert_first, cfg.head_dim) == (160, 20, 0, 192)
    assert (cfg.first_k_dense, cfg.routed_scaling, cfg.aux_coef) == (1, 16.0, 0.003)
    assert cfg.rope_yarn == (40.0, 4096.0, 32.0, 1.0, 0.707, 0.707)
    # a setting the port does not run is refused, not run as something else
    for k, v in (("scoring_func", "sigmoid"), ("rope_scaling", {"type": "linear", "factor": 4}),
                 ("rope_scaling", {"type": "yarn", "factor": 40})):
        with pytest.raises(ValueError, match=k):
            ds.arch_config(dict(c, **{k: v}))


def test_the_shapes_give_the_chips_share():
    """The issue's reckoning: MLA 149.2 M a layer, an MoE layer's router,
    held and shared experts 519.9 M, the dense MLP 188.7 M, 3.145 B."""
    c = full_config()
    specs = {p: s for p, s, _ in ds.leaf_specs(c)}
    n = {p: math.prod(s) for p, s in specs.items()}
    mla = sum(v for p, v in n.items() if p.startswith("dense/attn/"))
    moe = sum(v for p, v in n.items() if p.startswith("blocks/g0/ffn/")) // 4
    assert mla == 149_227_520 and moe == 519_864_320
    assert sum(v for p, v in n.items() if p.startswith("dense/ffn/")) == 188_743_680
    total, met = ds.param_counts(c)
    assert total == sum(n.values()) == 3_145_466_880
    assert specs["blocks/g0/ffn/w_gate"] == (4, 20, 5120, 1536)
    assert specs["blocks/g0/ffn/router"] == (4, 5120, 160)
    assert specs["blocks/g0/ffn/shared/w_down"] == (4, 3072, 5120)
    routed = 4 * 3 * 20 * 5120 * 1536
    assert met == total - n["embed"] - routed + routed * 6 / 160
    assert [p for p in specs if ds.keeps_f32(p)] == ["blocks/g0/ffn/router"]
    pairs = 4096 * 4097 // 2
    flops = ds.train_step_flops(c, 2, 4096)
    assert flops == 6.0 * met * 8192 + 3 * 2 * 320 * 128 * 5 * pairs * 2
    assert 60e12 < 6.0 * met * 8192 < 64e12 and 20e12 < flops - 6.0 * met * 8192 < 21e12
    work = ds.attention_work(c, 2, 4096)
    rows = 2 * 4096 * 128
    assert work["k3"] == (2 * rows * 640 + 4 * rows, 2.0 * 2 * 128 * pairs * 320)
    assert work["k3bwd"] == (2 * rows * 1280 + 4 * rows, 2.0 * 2 * 128 * pairs * 832)
    assert yardstick.bound_ms(*work["k3"])[1] == "operations"
    assert ds.bytes_per_block(c, 16) == 5 * 576 * 2 * 16


def test_the_leaves_are_the_ports_tree():
    c = tiny_config(full_config())
    model = ds.make_model(c, None)
    port = weights.unnest(model.init(torch.Generator().manual_seed(0)))
    drawn = dict(weights.leaves(c, SEED, CPU))
    assert {k: tuple(v.shape) for k, v in port.items()} == {
        k: tuple(v.shape) for k, v in drawn.items()}
    assert all(v.dtype == torch.float32 for v in drawn.values())


def run(hooks=None, seed=SEED, trace=False):
    return train_cell.run(tiny_cell(), seed, 0.3, trace, CPU, time.perf_counter(), hooks)


def test_a_sound_run_is_correct_and_reports_its_metrics():
    from repro_torch import tracing

    before = {k: tracing.counter_totals.get(k, 0) for k in ("moe.group_limited",
                                                             "moe.held_only")}
    rec = run()
    assert rec.correct, rec.checks
    assert set(rec.checks) == {"grad_norm_gap", "change_norm_gap", "change_diff_gap",
                               "nonfinite_losses"}
    m = manifest.load(ROOT)
    got = manifest.read_metrics(m, CELL, "end_to_end", rec, ROOT)
    assert {"setup_s", "train_tokens_per_s"} <= set(got)
    # every routing of every step (and remat's second forward) counted
    steps = rec.counters["window_steps"] + 4
    for k in before:
        assert tracing.counter_totals[k] - before[k] == steps * 2 * 2, k


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
def test_a_training_fault_is_not_correct(fault):
    rec = run({"step": faults.TRAIN[fault]})
    assert not rec.correct, rec.checks


def test_the_bf16_control_is_not_correct():
    cell = tiny_cell()
    c, mix = cell.config, cell.traffic
    ref = train_cell.reference_readings(c, mix, 31, CPU)
    ctrl = train_cell.reference_readings(c, mix, 31, CPU, dtype=torch.bfloat16)
    got = compare.train_readings(ctrl, ref)
    assert any(got[k][0] > cell.limits[k] for k in cell.limits), got


def test_the_new_readers_read_the_ranges_and_nothing_else():
    rec = Record(CELL, "train", counters={"profiled_steps": 2})
    assert manifest.reader("mla_ms.train", ROOT)(rec) is None
    s = Session(CPU)
    s.ranges = {"train_step.mla": 0.5, "train_step.moe_route": 0.02}
    rec.profile = Profile()
    rec.profile.add("step", s)
    assert manifest.reader("mla_ms.train", ROOT)(rec) == pytest.approx(250.0)
    assert manifest.reader("moe_route_ms.train", ROOT)(rec) == pytest.approx(10.0)
    s.ranges = {}
    assert manifest.reader("moe_route_ms.train", ROOT)(rec) is None


def test_the_cache_rows_are_the_references_latent():
    """A prefill's latent rows and last logits in f32 against the
    reference's ``logits_at(kv=True)``."""
    from repro_torch.models import make_model

    c = tiny_config(full_config())
    model = make_model(ds.arch_config(c), param_dtype=torch.float32,
                       compute_dtype=torch.float32)
    flat = weights.flat(c, SEED, CPU)
    tokens = torch.randint(0, c["vocab_size"], (1, 20), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        logits, caches = model.prefill(weights.nest(flat), {"tokens": tokens}, 24)
    want, c_kv, k_rope = ds.reference.logits_at(flat, c, tokens[0], torch.arange(12, 20), kv=True)
    rows = ds.cache_rows(caches, 12, 8)
    assert rows[0].shape == (3, 8, 16) and rows[1].shape == (3, 8, 8)
    torch.testing.assert_close(rows[0], c_kv, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rows[1], k_rope, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(logits[0, -1].float(), want[-1], atol=1e-4, rtol=1e-4)
