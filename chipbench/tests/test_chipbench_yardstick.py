"""The yardstick's arithmetic, and the GQA architecture's, against hand values."""

import pytest

from chipbench.tests.tiny import ROOT  # noqa: I001  (first: puts src/ on the path)
from chipbench.archs import gqa
from chipbench.harness import manifest, yardstick


def config(name):
    m = manifest.load(ROOT)
    return manifest.cell(m, next(w["name"] for w in m["workloads"] if w["config"] == name),
                         ROOT).config


@pytest.mark.parametrize("T,S,causal,window,pairs", [
    (4096, 4096, True, 2048, 6_292_480),
    (4096, 4096, True, 0, 8_390_656),
    (1024, 1024, True, 0, 524_800),
    (4, 6, False, 0, 24),
    (4, 4, True, 2, 7),
])
def test_attended_pairs(T, S, causal, window, pairs):
    assert yardstick.attended_pairs(T, S, causal, window) == pairs


def test_bound_ms_takes_the_longer_of_bytes_and_operations():
    assert yardstick.bound_ms(3.35e9, 0.0) == pytest.approx((1.0, "bytes"))
    assert yardstick.bound_ms(0.0, 989e9) == pytest.approx((1.0, "operations"))
    assert yardstick.bound_ms(0.0, 67e9, "float32")[0] == pytest.approx(1.0)


def test_parameter_counts():
    total, active = gqa.param_counts(config("qwen3-1.7b"))
    assert total == 1_720_574_976 and active == total
    total, active = gqa.param_counts(config("granite-moe-1b-a400m"))
    assert total == pytest.approx(1.335e9, rel=2e-3)
    assert active == pytest.approx(4.27e8, rel=5e-3)


def test_model_flops():
    # qwen3 at B=4 x T=1024: 6 x 1.7206e9 x 4096 + 12 x 128 x 16 x 28 x 524,800 x 4
    assert gqa.train_step_flops(config("qwen3-1.7b"), 4, 1024) == pytest.approx(
        6 * 1_720_574_976 * 4096 + 12 * 128 * 16 * 28 * 524_800 * 4)
    assert gqa.train_step_flops(config("qwen3-1.7b"), 4, 1024) == pytest.approx(4.37e13,
                                                                                       rel=2e-3)
    assert gqa.prefill_flops(config("qwen3-1.7b"), 4352) == pytest.approx(1.71e13, rel=3e-3)
    assert gqa.train_step_flops(config("granite-moe-1b-a400m"), 4, 1024) == pytest.approx(
        1.11e13, rel=2e-2)


def test_kernel_bounds():
    b, f = yardstick.k3_work(4, 1024, 16, 8, 128, lse=True)
    assert f == 4 * 4 * 16 * 524_800 * 128
    assert yardstick.bound_ms(b, f)[0] == pytest.approx(0.0174, rel=5e-3)
    b, f = yardstick.k3bwd_work(4, 1024, 16, 8, 128)
    assert f == 10 * 4 * 16 * 524_800 * 128
    assert yardstick.bound_ms(b, f)[0] == pytest.approx(0.0435, rel=5e-3)
