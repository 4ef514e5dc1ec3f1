"""The serving cells: the port's ``ServingEngine`` in live mode on bf16
weights, one closed-loop client sending the mix's requests back to back.

Each request is timed on the host clock from the call to
``engine.submit`` to the synchronised end of the model's prefill (its
first token's logits): that is its time to first token, the cache's
lookup and write-back included. :class:`TimedModel` (a copy of
``chip_smoke.TimedModel``) is the model the engine is handed: it times
each prefill between two synchronisations and computes nothing of its
own, and keeps each request's last cached key and value rows (the rows
its prefill wrote for the last prompt token and its decode steps for the
served ones), read from the caches the last step hands back. Set-up fills
the shared cache with the stream's first ``filled_requests``, sent through
``engine.submit`` in the engine's accounting mode (the cache's lookup and
write-back, no model), and serves the next ``warmup_requests``; the window serves requests until
``--seconds`` have passed; a traced run then serves ``profiled_requests``
more, each prefill and the first ``profiled_decode_steps`` decode steps
of each under the profiler (its reading of a decode step's six thousand
launches takes seconds).

Correct: every request's cache decisions (cached tokens, evictions,
ripple evictions) equal the plain reference cache's on the same stream
(limit 0), and on a sample of the window's requests drawn from the seed
no served token's logit lies further below the reference's best than the
cell's limit (``logit_gap``), and no kept key or value row of any layer
lies further from the reference's row than the cell's limit, relative to
the reference's (``kv_row_gap``: a decode step that leaves its cache
unchanged, or writes a wrong row, shows here, where one missing row in
four thousand barely moves a logit). The reference runs in f32 with TF32
off on the prompt and the served tokens, once the program's state is
freed. The mix's ``min_window_requests`` (default 1) is the least number
of requests a window serves, whatever ``--seconds``.

A cell on more than one chip runs this on every rank: set-up and the
window start and end at a barrier, and every rank ends the window on the
same request.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from chipbench import archs

from . import traffic, weights, yardstick
from .profiling import Profile, Session
from .record import Record, check, free, log, passed


class TimedModel:
    """The model as the engine sees it: each prefill timed on the host clock
    between two synchronisations (``t_enter``: the call, before the first;
    ``t_prefill``: after the second), each decode step passed on; with
    ``profile`` set, each prefill and each request's first
    ``profiled_steps`` decode steps inside a profiler session. After a
    request's last step (``decode_steps`` of them), ``rows`` holds its
    caches' rows from the last prompt token's on (``cache_rows``: the
    architecture's, decode_steps + 1 of each layer), copied on the card."""

    def __init__(self, model, device, profiled_steps: int, decode_steps: int,
                 cache_rows: Callable) -> None:
        self.model, self.device, self.profiled_steps = model, device, profiled_steps
        self.cache_rows = cache_rows
        self.decode_steps = decode_steps
        self.rows: Optional[tuple] = None
        self._prompt = 0
        self.t_enter = self.t_prefill = 0.0
        self.profile: Optional[Profile] = None
        self._session: Optional[Session] = None
        self._steps = 0

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def prefill(self, params, batch, cache_len):
        self.t_enter = time.perf_counter()
        self._steps, self.rows, self._prompt = 0, None, batch["tokens"].shape[1]
        if self.profile is not None:
            with Session(self.device) as s:
                out = self.model.prefill(params, batch, cache_len)
            self.profile.add("prefill", s)
        else:
            self._sync()
            out = self.model.prefill(params, batch, cache_len)
            self._sync()
        self.t_prefill = time.perf_counter()
        if self.decode_steps == 0:
            self._keep_rows(out[1])
        return out

    def _keep_rows(self, caches) -> None:
        self.rows = self.cache_rows(caches, self._prompt - 1, self.decode_steps + 1)

    def decode_step(self, params, tokens, caches, position):
        if self.profile is not None and self._steps == 0:
            self._session = Session(self.device).__enter__()
        out = self.model.decode_step(params, tokens, caches, position)
        self._steps += 1
        if self._session is not None and self._steps == self.profiled_steps:
            self._session.__exit__(None, None, None)
            self.profile.add("decode", self._session)
            self._session = None
        if self._steps == self.decode_steps:
            self._keep_rows(out[1])
        return out


def allocations(mix: dict) -> List[int]:
    """Each tenant's allocation in whole blocks: its share of the pool."""
    return [int(f * mix["pool_blocks"]) for f in mix["tenants"]]


class Server:
    """The engine in live mode on the seed's bf16 weights, its model the
    :class:`TimedModel`, and the mix's request stream. Set-up fills the
    shared cache with the stream's first ``filled_requests`` through
    ``engine.submit`` in accounting mode (the parameters held back: the
    cache's lookup and write-back, no model; a server that has run for a
    while), then serves ``warmup_requests``."""

    def __init__(self, cell, seed: int, device, hooks: Optional[Dict[str, Callable]] = None
                 ) -> None:
        from repro_torch.serving import EngineConfig, ServingEngine, TenantSpec

        hooks = hooks or {}
        c, mix, arch = cell.config, cell.traffic, archs.of(cell.config)
        self.mix, self.new = mix, mix["new_tokens"]
        model = arch.make_model(c, cell.ranks, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16)
        if "model" in hooks:
            model = hooks["model"](model)
        params = weights.nest(weights.flat(c, seed, device, torch.bfloat16,
                                           rank=cell.ranks.rank, world=cell.ranks.world))
        self.timed = TimedModel(model, device, min(mix["profiled_decode_steps"], self.new - 1),
                                self.new - 1, arch.cache_rows)
        bpb = arch.bytes_per_block(c, mix["block_tokens"])
        self.engine = ServingEngine(
            arch.arch_config(c),
            [TenantSpec(f"tenant{t}", float(a * bpb)) for t, a in enumerate(allocations(mix))],
            EngineConfig(block_tokens=mix["block_tokens"], pool_blocks=mix["pool_blocks"]),
            model=self.timed, params=params, device=device)
        self.stream = traffic.ServeStream(mix, c["vocab_size"], seed)
        self.filled: List[tuple] = []       # (request, its result, None) of the fill
        self.served: List[dict] = []
        self.engine.params = None           # accounting mode
        for i in range(mix["filled_requests"]):
            r = self.stream.request(i)
            self.filled.append((r, self.engine.submit(f"tenant{r.tenant}", r.tokens,
                                                      max_new_tokens=self.new), None))
        self.engine.params = params
        for _ in range(mix["warmup_requests"]):
            self.serve()

    def serve(self) -> dict:
        r = self.stream.request(len(self.filled) + len(self.served))
        t0 = time.perf_counter()
        res = self.engine.submit(f"tenant{r.tenant}", r.tokens, max_new_tokens=self.new)
        out = dict(req=r, res=res, rows=self.timed.rows, ttft=self.timed.t_prefill - t0,
                   cache_host=self.timed.t_enter - t0)
        self.served.append(out)
        return out

    def outputs(self) -> List[tuple]:
        """(request, result, kept rows or None) of every request the cache
        saw, in order."""
        return self.filled + [(s["req"], s["res"], s["rows"]) for s in self.served]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        hooks: Optional[Dict[str, Callable]] = None) -> Record:
    c, mix, ranks = cell.config, cell.traffic, cell.ranks
    rec = Record(cell.name, "serve")
    srv = Server(cell, seed, device, hooks)
    ranks.barrier()
    rec.setup_s = time.perf_counter() - t_start
    log(f"set-up {rec.setup_s:.2f} s", t_start)
    n_warm, n_min = len(srv.served), mix.get("min_window_requests", 1)
    w0 = time.perf_counter()
    while True:
        srv.serve()
        if ranks.any(time.perf_counter() - w0 >= seconds and len(srv.served) - n_warm >= n_min):
            break
    ranks.barrier()
    rec.window_s = time.perf_counter() - w0
    window = srv.served[n_warm:]
    log(f"window {rec.window_s:.2f} s, {len(window)} requests; traced {trace}", t_start)
    rec.spans.update(ttft=[s["ttft"] for s in window], cache_host=[s["cache_host"] for s in window],
                     prefill=[s["ttft"] - s["cache_host"] for s in window])
    rec.counters.update(requests=len(window),
                        cached_tokens=sum(s["res"].cached_tokens for s in window),
                        prompt_tokens=sum(len(s["req"].tokens) for s in window))
    if trace:
        rec.profile = srv.timed.profile = Profile()
        for _ in range(mix["profiled_requests"]):
            srv.serve()
        srv.timed.profile = None
        log("profiled", t_start)
    if device.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    T = mix["prompt_tokens"] + mix["suffix_tokens"]
    arch = archs.of(c)
    k3 = arch.attention_work(c, 1, T, lse=False)["k3"]
    rec.work.update(prefill_flops=arch.prefill_flops(c, T), k3_bound_ms=yardstick.bound_ms(*k3)[0])

    outputs, first = srv.outputs(), len(srv.filled) + n_warm
    del srv
    free(device)
    judge(rec, cell, seed, device, outputs, first, len(window))
    log("reference done", t_start)
    return rec


def judge(rec: Record, cell, seed: int, device, outputs, first: int, n_window: int) -> None:
    """The checks of a serving run: the cache's decisions on every request,
    and the served tokens of a sample of the window's requests."""
    c, mix = cell.config, cell.traffic
    new = mix["new_tokens"]
    served = [res for _, res, _ in outputs if res.output is not None]
    rec.attempted = len(served)
    bad = [res for res in served if res.output.shape != (1, new)
           or res.output.min() < 0 or res.output.max() >= c["vocab_size"]]
    rec.failed = len(bad)
    check(rec, "cache_mismatches", cache_mismatches(mix, outputs), cell.limits["cache_mismatches"],
          f"over {len(outputs)} requests")
    sample = sample_requests(seed, first, n_window, mix["sampled_requests"])
    gap, kv = (math.inf, math.inf) if bad else reference_gaps(
        c, seed, device, [outputs[i] for i in sample], cell.ranks.rank, cell.ranks.world)
    check(rec, "logit_gap", gap, cell.limits["logit_gap"],
          f"over {len(sample) * new} served tokens of {len(sample)} requests")
    check(rec, "kv_row_gap", kv, cell.limits["kv_row_gap"],
          f"over {len(sample) * new} cached rows a layer of {len(sample)} requests")
    rec.correct = passed(rec)


def cache_mismatches(mix: dict, outputs) -> int:
    """Requests whose cached tokens, evictions or ripple evictions differ
    from the plain reference cache's on the same stream."""
    from chipbench.reference.prefix_cache import SharedPrefixCacheRef

    alloc = allocations(mix)
    ref = SharedPrefixCacheRef(alloc, max(mix["pool_blocks"], sum(alloc)), mix["block_tokens"])
    bad = 0
    for req, res, *_ in outputs:
        d = ref.request(req.tenant, req.tokens)
        bad += (d.cached_tokens, d.evictions, d.ripple_evictions) != (
            res.cached_tokens, res.evictions, res.ripple_evictions)
    return bad


def sample_requests(seed: int, first: int, n: int, k: int) -> List[int]:
    """k of the window's n requests (indices from ``first``), drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x53414D]))
    return sorted(first + int(i) for i in rng.choice(n, size=min(k, n), replace=False))


def reference_params(c: dict, seed: int, device, rank: int = 0, world: int = 1
                     ) -> Dict[str, torch.Tensor]:
    """The served (bf16) parameters, in f32 (rank ``rank``'s share)."""
    return {n: t.float() for n, t in weights.leaves(c, seed, device, torch.bfloat16, rank, world)}


def reference_gaps(c: dict, seed: int, device, sampled, rank: int = 0, world: int = 1) -> tuple:
    """(logit_gap, kv_row_gap) over the sampled requests: the widest gap
    between the reference's best logit and its logit of a served token,
    and the widest relative gap of a kept key or value row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = reference_params(c, seed, device, rank, world)
    worst = [0.0, 0.0]
    for req, res, rows in sampled:
        served = torch.as_tensor(res.output[0], dtype=torch.int64, device=device)
        gaps, kv = request_gaps(params, c, req.tokens, served, rows, device)
        worst = [max(worst[0], float(gaps.max())), max(worst[1], kv)]
    return tuple(worst)


def row_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest ||prog - ref|| / ||ref|| over the rows of every layer,
    each row's norm taken over all but its first two dims (layer, row)."""
    d = torch.linalg.vector_norm((prog.float() - ref).flatten(2), dim=-1)
    return float((d / torch.linalg.vector_norm(ref.flatten(2), dim=-1).clamp_min(1e-30)).max())


def request_gaps(params, c: dict, prompt, served, rows, device, quant=None):
    """(gaps, kv) of one request: the reference's best logit less its logit
    of each served token, at each served position, and the widest
    :func:`row_gap` of ``rows`` (the kept cache rows, ``cache_rows``'; None:
    infinite) from the reference's. With ``quant``, the control's: the gaps
    of the tokens the reference computed through ``quant`` puts first, and
    its own rows."""
    ref_model = archs.of(c).reference
    P = len(prompt)
    seq = torch.cat([torch.as_tensor(prompt, dtype=torch.int64, device=device), served[:-1]])
    pos = torch.arange(P - 1, P - 1 + len(served), device=device)
    ref, *ref_rows = ref_model.logits_at(params, c, seq, pos, kv=True)
    pick = served
    if quant is not None:
        logits, *rows = ref_model.logits_at(params, c, seq, pos, quant=quant, kv=True)
        pick = torch.argmax(logits, dim=-1)
    kv = math.inf if rows is None else max(row_gap(p, r) for p, r in zip(rows, ref_rows))
    return ref.max(dim=-1).values - ref.gather(1, pick[:, None])[:, 0], kv
