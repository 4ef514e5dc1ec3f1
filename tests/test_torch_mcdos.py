"""The port's MCD-OS server (paper Section VI) and RRE (Section IV-D), host
copies, against the reference package on the same NumPy traces.

Every request's ``GetResult`` and eviction list, every ``RippleStats``,
the hit recorders and every routed server must be equal. The
reference's own assertions (``tests/test_system.py``'s MCD-OS and route
cases, ``tests/test_shared_lru.py``'s ripple and RRE cases) are then
checked on the port.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import MCDOSServer as JMCDOSServer
from repro.core import MCDServer as JMCDServer
from repro.core import RRECache as JRRECache
from repro.core import RREConfig as JRREConfig
from repro.core import SharedLRUCache as JShared
from repro.core import compare_ripple as jcompare_ripple
from repro.core import consistent_route as jconsistent_route
from repro.core import run_trace as jrun_trace
from repro_torch.core import (
    GetResult,
    MCDOSServer,
    MCDServer,
    RRECache,
    RREConfig,
    SharedLRUCache,
    compare_ripple,
    consistent_route,
    rate_matrix,
    run_trace,
    sample_trace,
)


def _st(st):
    """A RequestStats as plain values (the two packages' enums differ)."""
    return st.result.value, [(e.proxy, e.key, e.trigger_proxy, e.ripple, e.physical)
                             for e in st.evictions]


def _ripple(r):
    return dict(r.evictions_per_set), r.n_sets, r.n_primary, r.n_ripple


def _trace(J=4, N=2000, n=10_000, seed=3):
    return sample_trace(rate_matrix(N, [0.5 + 0.5 * i for i in range(J)]), n, seed=seed)


@pytest.mark.parametrize("kw", [dict(), dict(slru=True), dict(ghost_retention=False),
                                dict(ripple_allocations=[36, 36, 36, 36])],
                         ids=["flat", "slru", "no-ghosts", "ripple-allocations"])
def test_mcdos_and_mcd_equal_reference(kw):
    """test_system.py's Fig. 2 / Table V structure, request by request:
    MCD-OS sets can ripple (>1 eviction), plain MCD never does."""
    N, tr = 2000, _trace()
    servers = [(MCDOSServer([30] * 4, N, **kw), JMCDOSServer([30] * 4, N, **kw)),
               (MCDServer(120, 4), JMCDServer(120, 4))]
    for i, k in zip(tr.proxies.tolist(), tr.objects.tolist()):
        for srv, jsrv in servers:
            a, b = srv.get(i, k), jsrv.get(i, k)
            assert _st(a) == _st(b)
            if a.result is GetResult.MISS:
                assert _st(srv.set(i, k, 1)) == _st(jsrv.set(i, k, 1))
    for srv, jsrv in servers:
        assert _ripple(srv.stats.ripple) == _ripple(jsrv.stats.ripple)
        np.testing.assert_array_equal(srv.stats.hits.req, jsrv.stats.hits.req)
        np.testing.assert_array_equal(srv.stats.hits.hit, jsrv.stats.hits.hit)
    mcdos, mcd = servers[0][0], servers[1][0]
    h_os, h_mc = mcdos.stats.ripple.histogram(), mcd.stats.ripple.histogram()
    assert max(h_mc) <= 1                             # plain LRU: one eviction at most
    if kw.get("ripple_allocations") is None:
        assert max(h_os) > 1                          # ripples exist
        assert 0 < mcdos.stats.ripple.frac_multi_eviction < 0.9
    assert set(mcdos.stats.latency.samples_us) == {"get", "set"}


@pytest.mark.parametrize("warmup", [0, 2_500])
def test_run_trace_equals_reference(warmup):
    """MCD client semantics (every get miss is followed by a set), the
    warmup requests excluded from the statistics."""
    N, tr = 500, _trace(J=3, N=500, n=8_000, seed=11)
    lengths = np.random.default_rng(4).integers(1, 4, size=N)
    for make, jmake in ((lambda: MCDOSServer([20, 25, 30], 120, n_objects_hint=N),
                         lambda: JMCDOSServer([20, 25, 30], 120, n_objects_hint=N)),
                        (lambda: MCDServer(75, 3, n_objects_hint=N),
                         lambda: JMCDServer(75, 3, n_objects_hint=N))):
        got = run_trace(make(), tr.proxies, tr.objects, lengths, warmup=warmup)
        want = jrun_trace(jmake(), tr.proxies, tr.objects, lengths, warmup=warmup)
        assert got.hits.req.sum() == len(tr.proxies) - warmup
        np.testing.assert_array_equal(got.hits.req, want.hits.req)
        np.testing.assert_array_equal(got.hits.hit, want.hits.hit)
        assert _ripple(got.ripple) == _ripple(want.ripple) and got.ripple.n_sets > 0


def test_consistent_route_equals_reference_and_is_stable():
    """test_system.py's route case, and the routed server of every key
    equal to the reference's, for string and integer keys, under growth."""
    keys = [f"obj{i}" for i in range(200)] + list(range(300))
    for n in (1, 2, 3, 7, 8, 9):
        routed = [consistent_route(k, n) for k in keys]
        assert routed == [jconsistent_route(k, n) for k in keys]
        assert routed == [consistent_route(k, n) for k in keys]     # stable
        assert len(set(routed)) == n                                # every server used
    eight, nine = ([consistent_route(k, n) for k in keys] for n in (8, 9))
    moved = sum(a != b for a, b in zip(eight, nine))
    assert all(b == 8 for a, b in zip(eight, nine) if a != b)       # only to the new server
    assert moved < len(keys) / 4
    assert consistent_route("x", 4, vnodes=16) == jconsistent_route("x", 4, vnodes=16)
    for route in (consistent_route, jconsistent_route):
        with pytest.raises(ValueError):
            route("x", 0)


def test_process_command_error_paths():
    """test_system.py's wire protocol case on both packages: malformed
    requests raise ValueError and leave the server usable."""
    for Srv in (MCDOSServer, JMCDOSServer):
        srv = Srv([16, 16, 16], 100)
        with pytest.raises(ValueError):
            srv.process_command(0, "delete", 1)      # unknown command
        with pytest.raises(ValueError):
            srv.process_command(0, "set", 1)         # set without a length
        for bad_proxy in (-1, 3, 17):
            with pytest.raises(ValueError):
                srv.process_command(bad_proxy, "get", 1)
            with pytest.raises(ValueError):
                srv.process_command(bad_proxy, "set", 1, 1)
        for bad_len in (0, -4):
            with pytest.raises(ValueError):
                srv.process_command(0, "set", 1, bad_len)
        assert srv.process_command(0, "get", 1).result.value == "miss"
        srv.process_command(0, "set", 1, 1)
        assert srv.process_command(0, "get", 1).result.value == "hit_list"


def _fig1(c):
    """test_shared_lru.py's Fig. 1 scenario; returns the rippling set."""
    c.set(0, "obj2", 3)
    c.get_autofetch(1, "obj2", 3)
    c.get_autofetch(2, "obj2", 3)     # shares: 1.0 each
    c.set(1, "obj3", 2)               # L1 = 1 + 2 = 3 (full)
    c.get_autofetch(2, "obj3", 2)     # share 1 each; L1 = 2, L2 = 2
    c.set(2, "obj5", 1)               # L2 = 3 (full)
    c.set(0, "obj4", 2)               # L0 = 1 + 2 = 3 (full)
    return [c.vlen(j) for j in range(3)], c.set(0, "obj1", 2)


def test_ripple_eviction_cascade_equals_reference():
    vl, st = _fig1(SharedLRUCache([3, 3, 3], physical_capacity=32))
    jvl, jst = _fig1(JShared([3, 3, 3], physical_capacity=32))
    assert vl == jvl == pytest.approx([3.0, 2.0, 3.0])
    assert _st(st) == _st(jst)
    assert st.n_evictions >= 3 and st.n_ripple >= 1   # the L2 eviction is a ripple


def test_rre_thresholds_equal_reference():
    """test_shared_lru.py's RRE case: with b_hat the non-trigger list
    absorbs the inflation, and the batch trim brings it back."""
    got = {}
    for name, Shared in (("port", SharedLRUCache), ("ref", JShared)):
        base = Shared([2, 2], physical_capacity=16)
        rre = Shared([2, 2], physical_capacity=16, ripple_allocations=[3, 3])
        sts = []
        for c in (base, rre):
            c.set(0, "s", 2)
            c.get_autofetch(1, "s", 2)   # shared: 1 each
            c.set(1, "t", 1)             # L1 = 2 (full)
            sts.append(_st(c.set(0, "u", 2)))
        vl = (base.vlen(1), rre.vlen(1))
        trimmed = [(e.proxy, e.key) for e in rre.enforce()]
        got[name] = (sts, vl, trimmed, rre.vlen(1))
        rre.check_invariants()
    assert got["port"] == got["ref"]
    (_, (base_v, rre_v), trimmed, after) = got["port"]
    assert base_v <= 2 and rre_v == pytest.approx(3.0) and trimmed and after <= 2


@pytest.mark.parametrize("slack,batch", [(0.25, 0), (0.5, 40), (0.0, 10)])
def test_rre_cache_and_compare_ripple_equal_reference(slack, batch):
    """RRECache request by request, then compare_ripple (the Section IV-D
    evaluation) on the same trace: base and RRE ripple statistics, the
    batch evictions and the memory given back."""
    N, tr = 400, _trace(J=3, N=400, n=6_000, seed=7)
    lengths = np.random.default_rng(2).integers(1, 4, size=N)
    alloc = [20, 30, 25]
    cfg, jcfg = RREConfig(slack, batch), JRREConfig(slack, batch)
    c, jc = RRECache(alloc, config=cfg), JRRECache(alloc, config=jcfg)
    assert c.memory_giveback == jc.memory_giveback and c.J == jc.J == 3
    for i, k in zip(tr.proxies.tolist(), tr.objects.tolist()):
        a, b = c.get(i, k), jc.get(i, k)
        assert _st(a) == _st(b)
        if a.result is GetResult.MISS:
            assert _st(c.set(i, k, int(lengths[k]))) == _st(jc.set(i, k, int(lengths[k])))
    assert [(e.proxy, e.key) for e in c.batch_events] == \
        [(e.proxy, e.key) for e in jc.batch_events]
    assert (len(c.batch_events) > 0) == (batch > 0 and slack > 0)   # no slack: nothing to trim
    got = compare_ripple(tr.proxies, tr.objects, lengths, alloc, cfg)
    want = jcompare_ripple(tr.proxies, tr.objects, lengths, alloc, jcfg)
    for name in ("base", "rre"):
        assert _ripple(got[name]) == _ripple(want[name]) and got[name].n_sets > 0
    for name in ("rre_batch_evictions", "memory_giveback"):
        assert got[name] == want[name]
    if slack > 0:
        assert got["rre"].n_ripple <= got["base"].n_ripple     # the slack absorbs ripples


def test_rre_cache_refuses_a_capacity_below_the_slack():
    for Cache, Cfg in ((RRECache, RREConfig), (JRRECache, JRREConfig)):
        assert Cfg(0.25).ripple_allocations([4, 10]) == [5, 13]
        with pytest.raises(ValueError, match="RRE slack"):
            Cache([4, 10], physical_capacity=17, config=Cfg(0.25))
        c = Cache([4, 10], config=Cfg(0.25))
        assert c.cache.B == 18 and c.memory_giveback == 4
    assert dataclasses.asdict(RREConfig()) == dataclasses.asdict(JRREConfig())
