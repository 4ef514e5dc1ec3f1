"""The architecture modules (``chipbench/archs/``).

The pins hold the GQA module to the harness's arithmetic before it moved
there (out of ``harness/weights.py``, ``port.py``, ``yardstick.py`` and
``serve_cell.py``): every literal below was printed by that code, for the
two configuration files, so the cells read what they read before.

A configuration that names ``"arch"`` reaches that module: a spy that
wraps the GQA module and counts its calls drives the tiny training and
serving runs to the same checks, bit for bit, as the file without the key.
"""

import copy
import json
import time

import pytest
import torch

from chipbench.tests.tiny import ROOT, tiny_cell, tiny_config  # noqa: I001  (first: puts src/ on the path)
from chipbench import archs
from chipbench.archs import gqa
from chipbench.harness import serve_cell, train_cell, weights, yardstick
from chipbench.tests import spy_arch

CPU = torch.device("cpu")
QWEN_D, GRANITE_D = 0.022097086912079608, 0.03125

PINS = {
    "qwen3-1.7b": {
        "specs": [
            ("embed", (151936, 2048), QWEN_D),
            ("blocks/g0/ln1/scale", (28, 2048), 0.0),
            ("blocks/g0/attn/wq", (28, 2048, 2048), QWEN_D),
            ("blocks/g0/attn/wk", (28, 2048, 1024), QWEN_D),
            ("blocks/g0/attn/wv", (28, 2048, 1024), QWEN_D),
            ("blocks/g0/attn/wo", (28, 2048, 2048), QWEN_D),
            ("blocks/g0/attn/q_norm/scale", (28, 128), 0.0),
            ("blocks/g0/attn/k_norm/scale", (28, 128), 0.0),
            ("blocks/g0/ln2/scale", (28, 2048), 0.0),
            ("blocks/g0/ffn/w_gate", (28, 2048, 6144), QWEN_D),
            ("blocks/g0/ffn/w_up", (28, 2048, 6144), QWEN_D),
            ("blocks/g0/ffn/w_down", (28, 6144, 2048), 0.012757759076995721),
            ("final_norm/scale", (2048,), 0.0)],
        "params": (1720574976, 1720574976),
        "train_flops": 43729368907776.0,
        "prefill_flops": 17148563423232.0,
        "k3_ms": 0.0173879134479272,
        "k3bwd_ms": 0.043469783619818,
        "k3_serve_ms": 0.078458718479272,
        "block_bytes": 1835008,
        # first and last value of the first three leaves drawn from the
        # generator, and of the last, at seed 1234567 on the CPU (tiny sizes)
        "drawn": [("embed", -0.18275277316570282, -0.16185899078845978),
                  ("blocks/g0/attn/wq", -0.2605188190937042, -0.012060041539371014),
                  ("blocks/g0/attn/wk", -0.1673419177532196, 0.04036527872085571),
                  ("blocks/g0/ffn/w_down", -0.10944156348705292, 0.05618971213698387)],
    },
    "granite-moe-1b-a400m": {
        "specs": [
            ("embed", (49155, 1024), GRANITE_D),
            ("blocks/g0/ln1/scale", (24, 1024), 0.0),
            ("blocks/g0/attn/wq", (24, 1024, 1024), GRANITE_D),
            ("blocks/g0/attn/wk", (24, 1024, 512), GRANITE_D),
            ("blocks/g0/attn/wv", (24, 1024, 512), GRANITE_D),
            ("blocks/g0/attn/wo", (24, 1024, 1024), GRANITE_D),
            ("blocks/g0/ln2/scale", (24, 1024), 0.0),
            ("blocks/g0/ffn/router", (24, 1024, 32), GRANITE_D),
            ("blocks/g0/ffn/w_gate", (24, 32, 1024, 512), GRANITE_D),
            ("blocks/g0/ffn/w_up", (24, 32, 1024, 512), GRANITE_D),
            ("blocks/g0/ffn/w_down", (24, 32, 512, 1024), 0.044194173824159216),
            ("final_norm/scale", (1024,), 0.0)],
        "params": (1334628352, 428658688),
        "train_flops": 11153795186688.0,
        "prefill_flops": 4662193291264.0,
        "k3_ms": 0.0086939567239636,
        "k3bwd_ms": 0.021734891809909,
        "k3_serve_ms": 0.039229359239636,
        "block_bytes": 786432,
        "drawn": [("embed", -0.18275277316570282, -0.16185899078845978),
                  ("blocks/g0/attn/wq", -0.2605188190937042, -0.012060041539371014),
                  ("blocks/g0/attn/wk", -0.1673419177532196, 0.04036527872085571),
                  ("blocks/g0/ffn/w_down", 0.03364722430706024, 0.03945150598883629)],
    },
}


def config(name):
    return json.loads((ROOT / "chipbench/configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", sorted(PINS))
def test_the_gqa_module_keeps_the_harness_arithmetic(name):
    c, pin = config(name), PINS[name]
    arch = archs.of(c)
    assert arch is gqa                  # a file without "arch"
    assert arch.leaf_specs(c) == pin["specs"]
    assert arch.param_counts(c) == pin["params"]
    assert arch.train_step_flops(c, 4, 1024) == pin["train_flops"]
    assert arch.prefill_flops(c, 4352) == pin["prefill_flops"]
    train = arch.attention_work(c, 4, 1024, lse=True)
    assert yardstick.bound_ms(*train["k3"])[0] == pin["k3_ms"]
    assert yardstick.bound_ms(*train["k3bwd"])[0] == pin["k3bwd_ms"]
    assert yardstick.bound_ms(*arch.attention_work(c, 1, 4352, lse=False)["k3"])[0] == pin[
        "k3_serve_ms"]
    assert arch.bytes_per_block(c, 16) == pin["block_bytes"]
    assert [p for p, *_ in pin["specs"] if arch.keeps_f32(p)] == (
        ["blocks/g0/ffn/router"] if "granite" in name else [])


@pytest.mark.parametrize("name", sorted(PINS))
def test_the_gqa_module_draws_the_same_leaves(name):
    c = tiny_config(config(name))
    std = {p: s for p, _, s in gqa.leaf_specs(c)}
    drawn = [(p, t.flatten()) for p, t in weights.leaves(c, 1234567, CPU) if std[p] != 0.0]
    got = [(p, float(t[0]), float(t[-1])) for p, t in drawn[:3] + drawn[-1:]]
    assert got == PINS[name]["drawn"]
    # a rank's draw of a leaf that is not sharded is every rank's
    for (p, a), (q, b) in zip(weights.leaves(c, 1234567, CPU),
                              weights.leaves(c, 1234567, CPU, rank=1, world=2)):
        assert p == q and torch.equal(a, b)


def spied(name):
    cell = tiny_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["arch"] = "chipbench.tests.spy_arch"
    return cell


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m.train", "qwen3-1.7b.serve_shared"])
def test_a_configuration_naming_its_arch_reaches_that_module(name):
    """The spy's runs read the same checks as the unnamed file's, bit for
    bit (a window of exactly ``min_window_requests`` requests: 0 s), and
    every part of the interface the driver needs went through the spy."""
    driver = train_cell if name.endswith(".train") else serve_cell
    plain, named = tiny_cell(name), spied(name)
    assert archs.of(named.config) is spy_arch
    spy_arch.CALLS.clear()
    want = driver.run(plain, 2_345_678_901, 0.0, False, CPU, time.perf_counter())
    assert not spy_arch.CALLS
    got = driver.run(named, 2_345_678_901, 0.0, False, CPU, time.perf_counter())
    assert want.correct and got.checks == want.checks and got.work == want.work
    used = {"leaves", "make_model", "attention_work"}
    used |= ({"make_train_step", "train_step_flops", "reference.loss"} if driver is train_cell
             else {"arch_config", "prefill_flops", "bytes_per_block", "cache_rows",
                   "reference.logits_at"})
    assert used <= set(spy_arch.CALLS), spy_arch.CALLS
