"""The prefix cache's span readers on a tiny traced serving run on the CPU:
each finds a positive number, the records they read are the window's (in
order, each with the sets of that request's write-back), and each window
request's lookup and write-back fit inside the benchmark's own
``cache_host`` span, which encloses them."""

import time

import pytest
import torch

from chipbench.tests.tiny import ROOT, tiny_cell  # noqa: I001  (first: puts src/ on the path)
from chipbench.harness import manifest, serve_cell, spans
from repro_torch.serving import ServingEngine

CPU = torch.device("cpu")
SERVE = ["qwen3-1.7b.serve_shared", "qwen3-1.7b.serve_unshared"]
READERS = ("cache_lookup_ms.serve", "cache_writeback_ms.serve", "cache_keys_ms.serve")


@pytest.fixture(scope="module", params=SERVE)
def traced(request):
    """(cell, record, every (request tokens, result) the engine served)."""
    cell = tiny_cell(request.param)
    served = []
    submit = ServingEngine.submit

    def keeping(self, tenant, tokens, max_new_tokens=16):
        res = submit(self, tenant, tokens, max_new_tokens)
        served.append((tokens, res))
        return res

    mp = pytest.MonkeyPatch()
    mp.setattr(ServingEngine, "submit", keeping)
    try:
        rec = serve_cell.run(cell, 3_000_000_019, 0.3, True, CPU, time.perf_counter())
    finally:
        mp.undo()
    return cell, rec, served


def test_the_readers_find_positive_numbers(traced):
    cell, rec, _ = traced
    assert rec.correct, rec.checks
    got = manifest.read_metrics(manifest.load(ROOT), cell.name, "per_layer", rec, ROOT)
    for name in READERS:
        assert got[name]["value"] > 0 and got[name]["unit"] == "ms", name


def test_the_records_are_the_windows(traced):
    cell, rec, served = traced
    mix = cell.traffic
    first = mix["filled_requests"] + mix["warmup_requests"]
    n = rec.counters["requests"]
    window = served[first:first + n]
    assert len(window) == n and len(served) == first + n + mix["profiled_requests"]
    recs = spans.window_records(rec)
    assert len(recs) == n
    bt = mix["block_tokens"]
    for r, (tokens, res) in zip(recs, window):
        assert r.counts["cache.sets"] == len(tokens) // bt - res.cached_tokens // bt
        assert r.counts["cache.blocks_hashed"] == 2 * (len(tokens) // bt)
    if not mix["unique_prompts"]:   # hits of several lengths tell the records apart
        assert n >= mix["min_window_requests"]
        assert len({r.counts["cache.sets"] for r in recs}) > 1


def test_lookup_and_write_back_fit_in_the_cache_host_span(traced):
    _, rec, _ = traced
    recs = spans.window_records(rec)
    assert len(recs) == len(rec.spans["cache_host"])
    for r, host in zip(recs, rec.spans["cache_host"]):
        assert 0 < r.seconds("cache.lookup") + r.seconds("cache.insert") <= host


def test_an_untraced_run_or_a_short_record_finds_nothing(traced):
    _, rec, _ = traced
    from dataclasses import replace

    assert spans.mean_ms(replace(rec, profile=None), "cache.lookup") is None
    assert spans.mean_ms(replace(rec, counters={**rec.counters, "requests": 10**6}),
                         "cache.lookup") is None
    assert spans.mean_ms(rec, "cache.no_such_span") is None
