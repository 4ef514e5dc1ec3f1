"""The general generator of the traffic mixes: deterministic for each
seed, fixed lengths, shared prompts equal across tenants."""

import numpy as np
import pytest
import torch

from chipbench.tests.tiny import ROOT  # noqa: I001  (first: puts src/ on the path)
from chipbench.harness import manifest, traffic


def mix(name):
    m = manifest.load(ROOT)
    cell = next(w["name"] for w in m["workloads"] if w["traffic"] == name)
    return manifest.cell(m, cell, ROOT).traffic


@pytest.mark.parametrize("name", ["serve_shared", "serve_unshared"])
def test_serve_stream_is_deterministic_with_fixed_lengths(name):
    mx = mix(name)
    a = traffic.ServeStream(mx, 151936, 2_700_000_001).requests(64)
    b = traffic.ServeStream(mx, 151936, 2_700_000_001).requests(64)
    c = traffic.ServeStream(mx, 151936, 2_700_000_002).requests(64)
    n = mx["prompt_tokens"] + mx["suffix_tokens"]
    assert all(len(r.tokens) == n for r in a + c)
    assert all(x.tenant == y.tenant and np.array_equal(x.tokens, y.tokens) for x, y in zip(a, b))
    assert any(not np.array_equal(x.tokens, y.tokens) for x, y in zip(a, c))
    assert all(0 <= r.tokens.min() and r.tokens.max() < 151936 for r in a)
    assert len({r.tenant for r in a}) == len(mx["tenants"])


def test_shared_prompts_are_equal_across_tenants_and_suffixes_are_own():
    mx = mix("serve_shared")
    s = traffic.ServeStream(mx, 151936, 2_700_000_003)
    reqs = s.requests(256)
    P = mx["prompt_tokens"]
    n_shared = int(round(mx["shared_frac"] * mx["n_prompts"]))
    by_chain = {}
    for r in reqs:
        by_chain.setdefault(r.chain, []).append(r)
    shared = [rs for ch, rs in by_chain.items()
              if ch < n_shared and len({r.tenant for r in rs}) > 1]
    assert shared, "some shared prompt reached two tenants"
    for rs in shared:
        assert all(np.array_equal(rs[0].tokens[:P], r.tokens[:P]) for r in rs)
    suffixes = {r.tokens[P:].tobytes() for r in reqs}
    assert len(suffixes) == len(reqs)


def test_unique_prompts_never_repeat():
    s = traffic.ServeStream(mix("serve_unshared"), 151936, 2_700_000_004)
    P = s.mix["prompt_tokens"]
    assert len({r.tokens[:P].tobytes() for r in s.requests(128)}) == 128


def test_token_feed_is_deterministic_and_every_batch_new():
    a = traffic.TokenFeed(2_900_000_000, 1000, 2, 16, 1.1, torch.device("cpu"))
    b = traffic.TokenFeed(2_900_000_000, 1000, 2, 16, 1.1, torch.device("cpu"))
    x = [a.next() for _ in range(3)]
    y = [b.next() for _ in range(3)]
    for u, v in zip(x, y):
        assert torch.equal(u["tokens"], v["tokens"]) and torch.equal(u["labels"], v["labels"])
        assert torch.equal(u["tokens"][:, 1:], u["labels"][:, :-1])
    assert not torch.equal(x[0]["tokens"], x[1]["tokens"])
    assert int(x[0]["tokens"].max()) < 1000


def test_sampling_is_the_programs():
    """The frozen copy samples what repro_torch/serving/trace.py samples
    (tenants and catalogue entries; the copy draws no suffix choice after
    them, which changes no earlier draw)."""
    from repro_torch.serving.trace import ServingLayout, sample_request_stream

    mx = mix("serve_shared")
    lay = ServingLayout(len(mx["tenants"]), mx["n_prompts"], mx["shared_frac"], 256, 16, 1)
    t, r, _ = sample_request_stream(lay, mx["alphas"], mx["mix"], 500, 77)
    t2, r2 = traffic.sample_request_stream(mx["n_prompts"], mx["alphas"], mx["mix"], 500, 77)
    assert np.array_equal(t, t2) and np.array_equal(r, r2)


def test_the_training_draw_runs_in_deterministic_mode(monkeypatch):
    """On a card the draw's scan over a large vocabulary repeats only in
    PyTorch's deterministic mode; the mode is the caller's again after it."""
    seen = []
    multinomial = torch.multinomial

    def spy(*a, **k):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return multinomial(*a, **k)

    monkeypatch.setattr(torch, "multinomial", spy)
    assert not torch.are_deterministic_algorithms_enabled()
    feed = traffic.TokenFeed(3_000_000_007, 151936, 2, 16, 1.1, torch.device("cpu"))
    a, b = feed.batch(3), feed.batch(3)
    assert seen == [True, True] and not torch.are_deterministic_algorithms_enabled()
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["tokens"][:, 1:],
                                                                 a["labels"][:, :-1])
