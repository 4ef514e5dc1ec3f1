"""The Monte-Carlo engine on the CUDA lane engine: whole-trace drivers for
the flat shared-LRU system, one lane per replica.

The counterpart of the reference's ``core/fastsim_jax.py``: the same
dense int32 state (intrusive linked lists in flat vectors, holder
indicators, exact lcm-scaled virtual lengths, ghost list, inline
residence-time occupancy), the same runner protocol (``feed`` /
``finish`` / ``elapsed``) and the same outputs, bit for bit. The step
runs in :func:`repro_torch.kernels.lane_engine.lane_engine`: a CUDA
kernel with one block per lane for CUDA devices (its state in shared
memory where a lane fits, else in device memory: the runner's
``route``), the same step body built for the host for ``device="cpu"``.

* :class:`BatchedCudaRunner` — R lanes in one launch per chunk, with
  optional per-lane ``(b, b_hat)`` sweep points
  (``BatchedXLARunner``'s place); lane r is bit-identical to a single
  run on trace r.
* :class:`CudaChunkRunner` — the batched runner with R = 1, fed and
  finished as one cache (``XLAChunkRunner``'s place), what
  ``fastsim.simulate_trace`` drives on the lane engine.
* :func:`simulate_ensemble` — R replicas through the batched runner.

The runners keep the reference's host side: a chunk is split at
``warmup`` and the occupancy window is reset between launches
(``tot_time`` zeroed, ``t_start = warmup``); a chunk longer than
:data:`MAX_LAUNCH_REQUESTS` is fed in pieces, so that no single launch
runs for long (each launch copies a lane into shared memory and back on
the shared route); ``finish`` closes open residence intervals in int64.
``elapsed`` counts launches only: the kernel is built and its module
loaded (no launch) when the runner is made, each piece is copied to the
device before the clock starts, and the clock stops at a synchronize.

All arithmetic is int32 (exact): the runners refuse work outside
``fastsim._xla_applicable``'s envelope, sweep lanes included.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import lane_engine as le

from .fastsim import HIST_BUCKETS, _xla_applicable

HIST_MAX = HIST_BUCKETS
assert le.HIST == HIST_BUCKETS
# Requests per lane in one launch: longer chunks are fed in pieces.
MAX_LAUNCH_REQUESTS = 1 << 20
_T_START = le.SCALARS.index("t_start")


class BatchedCudaRunner:
    """R-lane ensemble driver: one launch per chunk advances R independent
    engines, lane r through its own trace, with the state on the device
    between feeds. ``feed`` takes stacked ``(R, m)`` proxy/object chunks.
    With ``b_sweep`` / ``bhat_sweep`` ((R, J), raw allocation units) each
    lane gets its own eviction thresholds. Lane r is bit-identical to
    :class:`CudaChunkRunner` fed trace r with that lane's thresholds.
    ``finish`` returns one output dict per lane. On a CUDA device every
    launch takes one route (``route``: ``"shared"`` or ``"device"``,
    :func:`repro_torch.kernels.lane_engine.route_for`; passing one forces
    it, and ``"shared"`` raises for a lane that does not fit); on the CPU
    ``route`` is None."""

    def __init__(
        self,
        params,
        n_objects: int,
        lengths,
        warmup: int,
        ripple_from: int,
        scale: int,
        replications: int,
        *,
        b_sweep=None,
        bhat_sweep=None,
        device: DeviceLike = None,
        route: Optional[str] = None,
    ) -> None:
        if replications < 1:
            raise ValueError("replications must be >= 1")
        self.device = resolve_device(device)
        J = len(params.allocations)
        self.J, self.N, self.R = J, int(n_objects), int(replications)
        b = np.asarray([int(x) for x in params.allocations], dtype=np.int64)
        b_hat = (
            np.asarray([int(x) for x in params.ripple_allocations], dtype=np.int64)
            if params.ripple_allocations is not None
            else b.copy()
        )
        B = (
            params.physical_capacity
            if params.physical_capacity is not None
            else int(b.sum())
        )
        self.sweep = b_sweep is not None or bhat_sweep is not None
        b_rows, bh_rows = np.tile(b, (self.R, 1)), np.tile(b_hat, (self.R, 1))
        if self.sweep:
            # per-lane (b, b_hat) sweep points, in raw allocation units
            b_rows = b_rows if b_sweep is None else np.asarray(b_sweep, dtype=np.int64)
            bh_rows = bh_rows if bhat_sweep is None else np.asarray(bhat_sweep, dtype=np.int64)
            if b_rows.shape != (self.R, J) or bh_rows.shape != (self.R, J):
                raise ValueError("sweep arrays must have shape (R, J)")
            if np.any(bh_rows < b_rows):
                raise ValueError("sweep points must satisfy b_hat >= b")
        if not _xla_applicable(0, self.N, np.asarray(lengths), params, bh_rows):
            raise ValueError("the lane engine's int32-exactness envelope is exceeded")
        share = [0] + [scale // p for p in range(1, J + 1)] + [0]
        self.ghost_retention = bool(params.ghost_retention)
        self.warmup = int(warmup)
        self.ripple_from = int(ripple_from)
        self.B = int(B)
        dev = self.device
        self.lengths = torch.as_tensor(np.asarray(lengths), device=dev).to(torch.int32)
        self.share = torch.tensor(share, dtype=torch.int32, device=dev)
        self.b_scaled = b_rows * scale
        self.bhat_scaled = bh_rows * scale
        self.st = le.init_state(J, self.N, self.R, self.b_scaled, self.bhat_scaled, dev)
        self._table = le.field_table(self.st)
        le.load(dev)    # build the kernel and load its module outside the clock
        self.route = le.route_for(self.st, dev, route) if dev.type == "cuda" else None
        self.idx = 0
        self.elapsed = 0.0
        self.launch_s: List[float] = []   # wall seconds of each timed launch

    # -- launches -------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _launch(self, P: torch.Tensor, O: torch.Tensor) -> None:
        le.lane_engine(
            self.st, P, O, idx0=self.idx, lengths=self.lengths,
            share=self.share, B=self.B, warmup=self.warmup, ripple_from=self.ripple_from,
            ghost=self.ghost_retention, table=self._table, route=self.route,
        )

    def _run(self, P: np.ndarray, O: np.ndarray) -> None:
        """One piece of at most MAX_LAUNCH_REQUESTS per lane per launch,
        each copied to the device before its clock starts."""
        m = P.shape[1]
        for a in range(0, m, MAX_LAUNCH_REQUESTS):
            e = min(m, a + MAX_LAUNCH_REQUESTS)
            Pd = torch.from_numpy(np.ascontiguousarray(P[:, a:e])).to(self.device)
            Od = torch.from_numpy(np.ascontiguousarray(O[:, a:e])).to(self.device)
            self._sync()
            t0 = time.perf_counter()
            self._launch(Pd, Od)
            self._sync()
            dt = time.perf_counter() - t0
            self.elapsed += dt
            self.launch_s.append(dt)
            self.idx += e - a

    def _reset_window(self) -> None:
        """Occupancy-window reset at the warmup boundary, between
        launches (the runners split chunks here)."""
        self.st["tot_time"].zero_()
        self.st["sc"][:, _T_START] = self.warmup

    def _feed_arrays(self, P: np.ndarray, O: np.ndarray) -> None:
        """(R, m) int32 requests, ids already checked."""
        if self.idx + P.shape[1] >= 2**31:
            raise ValueError("the lane engine counts requests in int32 (n < 2^31)")
        m = P.shape[1]
        w = self.warmup
        if self.idx <= w < self.idx + m:
            cut = w - self.idx
            if cut > 0:
                self._run(P[:, :cut], O[:, :cut])
            self._reset_window()
            if cut < m:
                self._run(P[:, cut:], O[:, cut:])
        else:
            self._run(P, O)

    def _ids(self, proxies, objects, shape) -> tuple:
        """The trust boundary of the kernel's index arithmetic: proxies in
        [0, J), objects in [0, N)."""
        P = np.asarray(proxies).reshape(shape)
        O = np.asarray(objects).reshape(shape)
        if P.size:
            if P.min() < 0 or P.max() >= self.J:
                raise ValueError(f"proxy ids must lie in [0, {self.J})")
            if O.min() < 0 or O.max() >= self.N:
                raise ValueError(f"object ids must lie in [0, {self.N})")
        return P.astype(np.int32), O.astype(np.int32)

    # -- outputs ----------------------------------------------------------
    def state(self) -> Dict[str, np.ndarray]:
        """The carried state as numpy, with the scalars under their names
        (the keys of the reference's ``_init_state``)."""
        out = {k: v.cpu().numpy() for k, v in self.st.items() if k not in ("sc", "b_lim", "bhat_lim")}
        sc = self.st["sc"].cpu().numpy()
        for j, name in enumerate(le.SCALARS):
            out[name] = sc[:, j]
        return out

    def _finish_lane(self, r: int, n_total: int) -> Dict:
        """Lane r's outputs: open residence intervals closed at n_total,
        in int64 (on the state's device, then copied). Its temporaries are
        two int64 arrays and a bool mask of J*N, updated in place (what
        :func:`repro_torch.kernels.lane_engine.lane_state_bytes` counts)."""
        sc = self.st["sc"][r].cpu().numpy()
        t_start = int(sc[_T_START])
        res = self.st["res_since"][r].to(torch.int64)
        tot = self.st["tot_time"][r].to(torch.int64)
        open_m = res >= 0
        # tot + (n_total - max(res, t_start)) where the interval is open
        tot.add_(res.clamp_(min=t_start).neg_().add_(n_total).mul_(open_m))
        scal = {name: int(sc[j]) for j, name in enumerate(le.SCALARS)}
        return {
            "tot_time": tot.cpu().numpy(),
            "horizon": max(n_total - t_start, 1),
            "vlen": self.st["vlen"][r].cpu().numpy(),
            "n_hit_list": scal["n_hit_list"],
            "n_hit_cache": scal["n_hit_cache"],
            "n_miss": scal["n_miss"],
            "hits_p": self.st["hits_p"][r].cpu().numpy(),
            "reqs_p": self.st["reqs_p"][r].cpu().numpy(),
            "hist": self.st["hist"][r].cpu().numpy(),
            "n_sets": scal["n_sets"],
            "n_prim": scal["n_prim"],
            "n_rip": scal["n_rip"],
        }


    def feed(self, proxies, objects) -> None:
        P = np.asarray(proxies)
        if P.ndim != 2 or P.shape[0] != self.R:
            raise ValueError(
                f"ensemble feed expects stacked (R={self.R}, m) chunks, "
                f"got shape {tuple(P.shape)}"
            )
        self._feed_arrays(*self._ids(P, objects, P.shape))

    def finish(self, n_total: int) -> List[Dict[str, np.ndarray]]:
        return [self._finish_lane(r, n_total) for r in range(self.R)]


class CudaChunkRunner(BatchedCudaRunner):
    """The lane engine for one cache: :class:`BatchedCudaRunner` with R = 1,
    with the ``feed`` / ``finish`` / ``elapsed`` interface of the C and
    Python chunk drivers of :mod:`repro_torch.core.fastsim` /
    :mod:`repro_torch.core.fastsim_c`."""

    def __init__(self, params, n_objects, lengths, warmup, ripple_from, scale, *,
                 device: DeviceLike = None) -> None:
        super().__init__(params, n_objects, lengths, warmup, ripple_from, scale, 1,
                         device=device)

    def feed(self, proxies, objects) -> None:
        super().feed(np.asarray(proxies).reshape(1, -1), np.asarray(objects).reshape(1, -1))

    def finish(self, n_total: int) -> Dict[str, np.ndarray]:
        return super().finish(n_total)[0]


def simulate_ensemble(
    params,
    traces: Sequence,
    n_objects: int,
    n_requests: Optional[int] = None,
    *,
    lengths=None,
    warmup: Optional[int] = None,
    ripple_from: Optional[int] = None,
    sparse: bool = False,
    device: DeviceLike = None,
) -> List:
    """Drive R independent replicas through the batched lane engine on
    ``device`` (``None``: the CUDA card).

    ``traces`` is a sequence of R equal-length
    :class:`~repro_torch.core.irm.IRMTrace` objects (one per replica), or
    a sequence of R chunk *iterables* (e.g. ``Workload.iter_chunks`` per
    replica seed) consumed in lockstep — pass ``n_requests`` explicitly in
    the streamed case. Returns one
    :class:`~repro_torch.core.fastsim.SimResult` per replica; replica 0 is
    bit-identical to ``simulate_trace(..., engine="cuda")`` on the same
    trace. Each result's ``elapsed_s`` is the wall clock of the whole
    batch, so aggregate throughput is
    ``sum(r.requests_per_sec for r in results)``.
    """
    from .fastsim import _assemble, _validate_params, default_warmup
    from .shared_lru import _lcm_1_to

    _validate_params(params)
    if params.variant != "lru":
        raise ValueError("simulate_ensemble drives the flat shared-LRU variant only")
    if params.batch_interval:
        raise ValueError("the lane engine does not support batch_interval")
    R = len(traces)
    if R < 1:
        raise ValueError("need at least one replica trace")
    N = int(n_objects)
    streamed = not hasattr(traces[0], "proxies")
    if n_requests is None:
        if streamed:
            raise ValueError("streamed ensembles need an explicit n_requests")
        n_requests = len(traces[0])
    n = int(n_requests)
    if not streamed and any(len(t) != n for t in traces):
        raise ValueError("all replica traces must have the same length")
    if lengths is None:
        lengths_a = np.ones(N, dtype=np.int64)
    else:
        lengths_a = np.ascontiguousarray(np.asarray(lengths), dtype=np.int64)
    if warmup is None:
        warmup = default_warmup(n, params.allocations)
    warmup = min(warmup, n)
    if ripple_from is None:
        ripple_from = warmup
    if not _xla_applicable(n, N, lengths_a, params):
        raise ValueError("workload exceeds the lane engine's int32-exactness envelope")
    J = len(params.allocations)
    scale = _lcm_1_to(J)
    runner = BatchedCudaRunner(
        params, N, lengths_a, warmup, ripple_from, scale, R, device=device
    )
    if streamed:
        consumed = 0
        for group in zip(*traces):
            m = len(group[0].proxies)
            if any(len(c.proxies) != m for c in group):
                raise ValueError("replica chunk streams must yield equal-length chunks")
            runner.feed(
                np.stack([np.asarray(c.proxies) for c in group]),
                np.stack([np.asarray(c.objects) for c in group]),
            )
            consumed += m
        if consumed != n:
            raise ValueError(
                f"chunk streams supplied {consumed} requests but n_requests={n}"
            )
    else:
        runner.feed(
            np.stack([np.asarray(t.proxies) for t in traces]),
            np.stack([np.asarray(t.objects) for t in traces]),
        )
    outs = runner.finish(n)
    return [
        _assemble(out, runner.elapsed, n, warmup, J, N, scale, "cuda", sparse)
        for out in outs
    ]
