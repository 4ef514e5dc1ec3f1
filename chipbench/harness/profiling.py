"""The profiler's reading: device time by kernel, busy seconds, the
``train_step.*`` ranges, and where the card sat idle.

``STEP_KERNELS`` and the reading of ``key_averages`` are frozen copies of
``chip_smoke.py``'s ``STEP_KERNELS`` and ``_busy``: kernels grouped by
name (cuBLAS's products, K3, K3-bwd), the ranges' device time read from
their CPU rows. A :class:`Session` profiles one stretch that starts and
ends with a synchronisation, and keeps its events in memory only.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

STEP_KERNELS = (("matmuls (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass")),
                ("K3", ("flash_tma_kernel", "flash_fma_kernel")),
                ("K3-bwd", ("bwd_dkdv", "bwd_dq", "bwd_delta")))
# one K3-bwd call launches three kernels; its dq kernel is counted once a call
K3BWD_CALL_KERNEL = "bwd_dq"
RANGE_PREFIX = "train_step."


def group_of(name: str) -> str:
    return next((g for g, pats in STEP_KERNELS if any(p in name for p in pats)), "other")


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


class Session:
    """``with Session(device) as s: ...`` profiles the block (synchronised
    at both ends); afterwards ``s.wall_s``, ``s.kernels`` {name: [s, n]},
    ``s.ranges`` {range: device s}, ``s.busy_s`` and ``s.gaps`` (the idle
    stretches of the device timeline, each with the host op running then)."""

    def __init__(self, device) -> None:
        self.device = device
        self.kernels: Dict[str, list] = {}
        self.ranges: Dict[str, float] = {}
        self.busy_s = 0.0
        self.wall_s = 0.0
        self.gaps: List[Tuple[str, float]] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def __exit__(self, *exc) -> None:
        self._sync()
        self.wall_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read(self._prof)
        self._prof = None

    def _read(self, prof) -> None:
        from torch.autograd import DeviceType

        for e in prof.key_averages():
            if e.device_type == DeviceType.CPU:
                if e.key.startswith(RANGE_PREFIX):
                    self.ranges[e.key] = e.device_time_total / 1e6
                continue
            if e.self_device_time_total > 0 and not e.key.startswith(RANGE_PREFIX):
                self.kernels[e.key] = [e.self_device_time_total / 1e6, e.count]
        self.busy_s = sum(s for s, _ in self.kernels.values())
        self.gaps = idle_gaps(prof)


def idle_gaps(prof, keep: int = 64) -> List[Tuple[str, float]]:
    """The ``keep`` longest stretches in which no device operation ran
    (between the first and the last), each named by the innermost host op
    running at its middle ("no host op" where none was)."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, e.name))
        elif e.device_type == DeviceType.CUDA:
            dev.append((tr.start, tr.end))
    if len(dev) < 2:
        return []
    dev.sort()
    gaps = []
    reach = dev[0][1]
    for s, e in dev[1:]:
        if s > reach:
            gaps.append((reach, s))
        reach = max(reach, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = gaps[:keep]
    if not host:
        return [("no host op", (b - a) / 1e6) for a, b in gaps]
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = "no host op"
        if inside.size:
            name = host[int(inside[np.argmin((he - hs)[inside])])][2]
        out.append((name, (b - a) / 1e6))
    return out


class Profile:
    """The sessions of one traced run, summed."""

    def __init__(self) -> None:
        self.sessions: Dict[str, List[Session]] = defaultdict(list)

    def add(self, part: str, s: Session) -> None:
        self.sessions[part].append(s)

    def parts(self, part: Optional[str] = None) -> List[Session]:
        if part is None:
            return [s for ss in self.sessions.values() for s in ss]
        return self.sessions.get(part, [])

    def busy_s(self, part: Optional[str] = None) -> float:
        return sum(s.busy_s for s in self.parts(part))

    def wall_s(self, part: Optional[str] = None) -> float:
        return sum(s.wall_s for s in self.parts(part))

    def kernels(self, part: Optional[str] = None) -> Dict[str, list]:
        out: Dict[str, list] = {}
        for s in self.parts(part):
            for k, (sec, n) in s.kernels.items():
                acc = out.setdefault(k, [0.0, 0])
                acc[0] += sec
                acc[1] += n
        return out

    def group(self, group: str, part: Optional[str] = None) -> Tuple[float, int, Dict[str, list]]:
        """(device s, launches, {kernel: [s, n]}) of one STEP_KERNELS group."""
        ks = {k: v for k, v in self.kernels(part).items() if group_of(k) == group}
        return sum(v[0] for v in ks.values()), sum(v[1] for v in ks.values()), ks

    def launches(self, part: Optional[str] = None) -> int:
        """Kernels launched (copies and fills left out)."""
        return sum(n for k, (_, n) in self.kernels(part).items() if not is_copy(k))

    def range_s(self, name: str, part: Optional[str] = None) -> float:
        return sum(s.ranges.get(name, 0.0) for s in self.parts(part))

    def breakdown(self) -> dict:
        ops = sorted(((k, v[0]) for k, v in self.kernels().items()), key=lambda r: -r[1])
        by_host: Dict[str, float] = defaultdict(float)
        for s in self.parts():
            for name, sec in s.gaps:
                by_host[name] += sec
        gaps = sorted(by_host.items(), key=lambda r: -r[1])
        return {"device_ops": [[k, float(v)] for k, v in ops[:10]],
                "idle_gaps": [[k, float(v)] for k, v in gaps[:10]]}
