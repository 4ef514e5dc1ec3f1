"""The port's spans and counters (``repro_torch.tracing``) on the CPU: one
request record a ``submit`` with the prefix cache's spans in it, counters
equal to what the cache did, the bounded record deque, the spans as
profiler ranges only while a profiler collects (also the train step's
two), and the engine's decisions and stats still the reference engine's.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import profile

from repro.cacheblocks import layout_for as jlayout_for
from repro.configs import get_config as jget_config
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import TenantSpec as JTenantSpec
from repro_torch import tracing
from repro_torch.cacheblocks import layout_for, prefix_cache
from repro_torch.configs import get_config
from repro_torch.serving import EngineConfig, ServingEngine, TenantSpec
from torch_threads import one_intra_op_thread  # noqa: F401  (an autouse fixture)

BT, POOL, PREFIX, USER, N_REQ = 4, 64, 16, 8, 40


def _engine(jax_engine=False):
    get, lay, Eng, Cfg, Spec, kw = (
        (jget_config, jlayout_for, JServingEngine, JEngineConfig, JTenantSpec, {})
        if jax_engine else
        (get_config, layout_for, ServingEngine, EngineConfig, TenantSpec, {"device": "cpu"}))
    cfg = dataclasses.replace(get("qwen3-1.7b").reduced(), n_kv_heads=2)
    pool_bytes = POOL * lay(cfg, block_tokens=BT).bytes_per_block
    tenants = [Spec("tenantA", 0.35 * pool_bytes), Spec("tenantB", 0.35 * pool_bytes),
               Spec("tenantC", 0.20 * pool_bytes)]
    return Eng(cfg, tenants, Cfg(block_tokens=BT, pool_blocks=POOL), **kw)


def _stream(vocab, n=N_REQ, seed=0):
    """(tenant, tokens) a request: shared prompts with private suffixes,
    and private prompts (hits, sharing attaches and evictions)."""
    rng = np.random.default_rng(seed)
    shared = [rng.integers(0, vocab, PREFIX) for _ in range(4)]
    out = []
    for _ in range(n):
        head = (shared[rng.integers(len(shared))] if rng.random() < 0.6
                else rng.integers(0, vocab, PREFIX))
        out.append((f"tenant{'ABC'[rng.integers(3)]}",
                    np.concatenate([head, rng.integers(0, vocab, USER)])))
    return out


def test_each_submit_makes_one_record_with_the_cache_spans():
    eng = _engine()
    stream = _stream(eng.cfg.vocab_size)
    before = tracing.span_totals.get("cache.lookup", [0, 0.0])[0]
    for tenant, tokens in stream:
        eng.submit(tenant, tokens, max_new_tokens=0)
    recs = tracing.records(len(stream))
    assert len(recs) == len(stream)
    for r in recs:
        assert {n: len(v) for n, v in r.spans.items()} == {
            "cache.lookup": 1, "cache.insert": 1, "cache.keys": 2}
        assert all(s >= 0 for v in r.spans.values() for s in v)
        # the key hashing is nested inside the lookup and the write-back
        assert r.seconds("cache.keys") <= r.seconds("cache.lookup") + r.seconds("cache.insert")
    assert tracing.span_totals["cache.lookup"][0] == before + len(stream)


def test_the_counters_are_what_the_cache_did(monkeypatch):
    eng = _engine()
    seen = {"hashes": 0, "gets": 0, "sets": 0}
    chain_hash, get, set_ = prefix_cache._chain_hash, eng.cache.manager.get, eng.cache.manager.set
    lookup, insert = prefix_cache.SharedPrefixCache.lookup, prefix_cache.SharedPrefixCache.insert

    def counting(name, f):
        def g(*a, **kw):
            seen[name] += 1
            return f(*a, **kw)
        return g

    monkeypatch.setattr(prefix_cache, "_chain_hash", counting("hashes", chain_hash))
    monkeypatch.setattr(eng.cache.manager, "get", counting("gets", get))
    monkeypatch.setattr(eng.cache.manager, "set", counting("sets", set_))
    outcomes = []
    monkeypatch.setattr(prefix_cache.SharedPrefixCache, "lookup",
                        lambda self, *a: outcomes.append(lookup(self, *a)) or outcomes[-1])
    monkeypatch.setattr(prefix_cache.SharedPrefixCache, "insert",
                        lambda self, *a, **kw: outcomes.append(insert(self, *a, **kw))
                        or outcomes[-1])
    totals = dict(tracing.counter_totals)
    sums = dict.fromkeys(("cache.blocks_hashed", "cache.gets", "cache.sets", "cache.hit_cache",
                          "cache.new_pages"), 0)
    hits = evicting = 0
    for tenant, tokens in _stream(eng.cfg.vocab_size, seed=5):
        seen.update(hashes=0, gets=0, sets=0)
        outcomes.clear()
        res = eng.submit(tenant, tokens, max_new_tokens=0)
        rec = tracing.records(1)[0]
        look, (pages, st) = outcomes
        want = {"cache.blocks_hashed": seen["hashes"], "cache.gets": seen["gets"],
                "cache.sets": seen["sets"], "cache.hit_cache": look.hit_cache,
                "cache.new_pages": st.new_pages}
        assert rec.counts == want
        assert seen["hashes"] == 2 * (len(tokens) // BT)
        assert seen["sets"] == len(pages) == len(tokens) // BT - look.cached_blocks
        assert res.prefill_tokens == seen["sets"] * BT
        for k, v in want.items():
            sums[k] += v
        hits += look.hit_cache > 0
        evicting += res.evictions > 0
    assert hits and evicting                 # the stream attaches to shared objects and evicts
    for k, v in sums.items():
        assert tracing.counter_totals[k] - totals.get(k, 0) == v


def test_the_deque_drops_its_oldest_record():
    for i in range(tracing.KEEP + 3):
        with tracing.request():
            tracing.count("test.index", i)
    recs = tracing.records()
    assert len(recs) == tracing.KEEP
    assert recs[0].counts == {"test.index": 3}
    assert recs[-1].counts == {"test.index": tracing.KEEP + 2}
    assert [r.counts["test.index"] for r in tracing.records(2)] == [tracing.KEEP + 1,
                                                                     tracing.KEEP + 2]


def test_a_span_outside_a_request_adds_to_the_totals_only():
    with tracing.request() as outer:
        pass
    n = tracing.span_totals.get("test.alone", [0, 0.0])[0]
    with tracing.span("test.alone"):
        tracing.count("test.alone")
    assert tracing.span_totals["test.alone"][0] == n + 1
    assert tracing.records(1)[0] is outer and not outer.spans and not outer.counts


def _busy(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_a_span_is_a_profiler_range_of_its_length():
    with profile() as prof:
        # a process's first range pays about a millisecond of the
        # profiler's own set-up inside it
        with tracing.span("test.first"):
            pass
        with tracing.request() as rec:
            with tracing.span("test.range"):
                _busy(0.02)
    got = rec.spans["test.range"][0]
    events = [e for e in prof.events() if e.name == "test.range"]
    assert len(events) == 1 and "test.first" in {e.name for e in prof.events()}
    length = events[0].time_range.elapsed_us() * 1e-6
    assert got >= 0.02
    assert abs(length - got) <= max(0.1 * got, 50e-6), (length, got)


def test_no_range_is_entered_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} was entered with no profiler open")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled
    eng = _engine()
    for tenant, tokens in _stream(eng.cfg.vocab_size, n=4):
        eng.submit(tenant, tokens, max_new_tokens=0)
    with tracing.span("test.quiet"):
        pass
    assert tracing.records(1)[0].spans["cache.lookup"]


def test_the_train_step_ranges_appear_under_the_profiler():
    from repro_torch.data import SyntheticLMData
    from repro_torch.models import make_model
    from repro_torch.training import AdamWConfig, TrainConfig, make_train_step
    from repro_torch.training.train_step import init_train_state

    cfg = get_config("stablelm-1.6b").reduced()
    model = make_model(cfg)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=100))
    step = make_train_step(model, tcfg)
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg)
    data = SyntheticLMData(cfg.vocab_size, 16, 2, seed=3)
    batch = {k: torch.from_numpy(v) for k, v in data.next_batch().items()}
    n = {k: tracing.span_totals.get(k, [0, 0.0])[0]
         for k in ("train_step.forward", "train_step.optimizer")}
    with profile() as prof:
        state, m = step(state, batch)
    names = [e.name for e in prof.events()]
    assert names.count("train_step.forward") == 1 and names.count("train_step.optimizer") == 1
    assert {k: tracing.span_totals[k][0] - n[k] for k in n} == {
        "train_step.forward": 1, "train_step.optimizer": 1}
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("seed", [0, 7])
def test_the_engine_still_decides_as_the_reference(seed):
    jeng, teng = _engine(jax_engine=True), _engine()
    stream = _stream(teng.cfg.vocab_size, seed=seed)
    for tenant, tokens in stream:
        a, b = jeng.submit(tenant, tokens, 0), teng.submit(tenant, tokens, 0)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert jeng.stats() == teng.stats()
    assert teng.stats()["evictions"] > 0
    assert len(tracing.records(len(stream))) == len(stream)
