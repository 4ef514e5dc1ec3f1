"""A run's ``correct`` with the timed path broken underneath, at a tiny
size on the CPU: the harness's look for a card skipped, the rest of a run
driven as on the card (set-up, window, reference, checks against the
cell's own limits). Each fault a cell can have comes out not correct; a
sound run comes out correct. The controls (the reference one precision
below the configuration's, in the program's place) come out not correct
too."""

import time

import pytest
import torch

from chipbench.tests.tiny import ROOT, tiny_cell  # noqa: I001  (first: puts src/ on the path)
from chipbench import faults
from chipbench.harness import compare, manifest, serve_cell, train_cell
from chipbench.harness.weights import unnest
from chipbench.reference import lowp

CPU = torch.device("cpu")
TRAIN = ["qwen3-1.7b.train", "granite-moe-1b-a400m.train"]
SERVE = ["qwen3-1.7b.serve_shared", "qwen3-1.7b.serve_unshared"]


def run(name, hooks=None, seed=2_222_222_222):
    cell = tiny_cell(name)
    driver = train_cell if cell.traffic["kind"] == "train" else serve_cell
    rec = driver.run(cell, seed, 0.3, False, CPU, time.perf_counter(), hooks)
    m = manifest.load(ROOT)
    metrics = manifest.read_metrics(m, name, "end_to_end", rec, ROOT)
    assert "setup_s" in metrics and len(metrics) >= 2     # the card's peak is not on the CPU
    return rec


# -- training faults ---------------------------------------------------------

@pytest.mark.parametrize("name", TRAIN)
def test_a_sound_training_run_is_correct(name):
    rec = run(name)
    assert rec.correct, rec.checks


@pytest.mark.parametrize("fault", sorted(faults.TRAIN))
@pytest.mark.parametrize("name", TRAIN)
def test_a_training_fault_is_not_correct(name, fault):
    rec = run(name, {"step": faults.TRAIN[fault]})
    assert not rec.correct, rec.checks


def reversed_update(step):
    """The step's change of every parameter taken the other way."""
    def fault(state, batch):
        before = {k: v.clone() for k, v in unnest(state["params"]).items()}
        state, metrics = step(state, batch)
        with torch.no_grad():
            for k, v in unnest(state["params"]).items():
                v.copy_(2 * before[k] - v)
        return state, metrics
    return fault


@pytest.mark.parametrize("name", [n for n in TRAIN if "change_diff_gap" in tiny_cell(n).limits])
def test_a_reversed_update_fails_the_change_direction(name):
    """Norms alone do not see an update in the wrong direction: the cells
    that hold ``change_diff_gap`` read it near 2."""
    rec = run(name, {"step": reversed_update})
    assert rec.checks["change_diff_gap"]["value"] > 1.5 and not rec.correct, rec.checks


@pytest.mark.parametrize("name", TRAIN)
def test_the_training_control_is_not_correct(name):
    """The reference with bf16 masters, moments and compute, read as the
    program is read, fails one of the cell's numbers."""
    cell = tiny_cell(name)
    c, mix = cell.config, cell.traffic
    ref = train_cell.reference_readings(c, mix, 31, CPU)
    ctrl = train_cell.reference_readings(c, mix, 31, CPU, dtype=torch.bfloat16)
    got = compare.train_readings(ctrl, ref)
    assert any(got[k][0] > cell.limits[k] for k in cell.limits), got


# -- serving faults ----------------------------------------------------------

@pytest.mark.parametrize("name", SERVE)
def test_a_sound_serving_run_is_correct(name):
    rec = run(name)
    assert rec.correct, rec.checks


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
@pytest.mark.parametrize("name", SERVE)
def test_a_serving_fault_is_not_correct(name, fault):
    rec = run(name, {"model": faults.SERVE[fault]})
    assert not rec.correct, rec.checks


@pytest.mark.parametrize("name", SERVE)
def test_an_unchanged_cache_fails_the_cached_rows(name):
    """A decode step that leaves its cache unchanged leaves its row unwritten:
    ``kv_row_gap`` reads 1 (at the cell's size one missing row in four
    thousand barely moves a logit, so this number has to catch it)."""
    rec = run(name, {"model": faults.CacheUnchanged})
    assert rec.checks["kv_row_gap"]["value"] == pytest.approx(1.0), rec.checks


def test_a_wrong_cache_decision_is_not_correct(monkeypatch):
    from repro_torch.cacheblocks import prefix_cache

    lookup = prefix_cache.SharedPrefixCache.lookup

    def forgetful(self, tenant, token_ids):     # every other request finds nothing
        out = lookup(self, tenant, token_ids)
        forgetful.n += 1
        if forgetful.n % 2 == 0:
            out.cached_blocks, out.cached_tokens = 0, 0
        return out

    forgetful.n = 0
    monkeypatch.setattr(prefix_cache.SharedPrefixCache, "lookup", forgetful)
    rec = run("qwen3-1.7b.serve_shared")
    assert rec.checks["cache_mismatches"]["value"] > 0 and not rec.correct


def test_the_serving_control_is_not_correct():
    """The reference with every product in fp8 puts first tokens whose gap
    under the f32 reference passes the cell's limit."""
    cell = tiny_cell("qwen3-1.7b.serve_shared")
    c = cell.config
    params = serve_cell.reference_params(c, 41, CPU)
    g = torch.Generator().manual_seed(41)
    worst = 0.0
    for _ in range(16):
        prompt = torch.randint(0, c["vocab_size"], (80,), generator=g)
        served = torch.randint(0, c["vocab_size"], (8,), generator=g)
        gaps, _ = serve_cell.request_gaps(params, c, prompt.numpy(), served, None, CPU,
                                          quant=lowp.fp8)
        worst = max(worst, float(gaps.max()))
    assert worst > cell.limits["logit_gap"]
