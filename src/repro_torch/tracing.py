"""Host spans and counters of the port, and one record per served request.

``with span(name):`` times a stretch of host work between two
``time.perf_counter_ns`` reads; ``count(name, n)`` adds to a counter.
Both add to the per-name totals (``span_totals``: {name: [count,
seconds]}; ``counter_totals``: {name: total}) and, while a
``with request():`` block is open, to that request's
:class:`RequestRecord`. The last ``KEEP`` records are kept, oldest first
(:func:`records`). Tracing is always on; with no profiler open a span
costs its two clock reads and a few dictionary updates.

While a torch profiler is collecting, a span is also a
``record_function`` range of its name, so it sits on the profiler's
timeline; with none open, no range is entered. Under the profiler a range
that encloses kernel launches carries device time of its own, so the
serving path's spans enclose host work only.

The port's spans and counters:

* ``cache.lookup``: ``SharedPrefixCache.lookup``, the prompt's block keys
  and the chain of MCD gets (with their sharing attaches);
* ``cache.insert``: ``SharedPrefixCache.insert``, the write-back: a set a
  block, with its evictions, ripple evictions and pool pages;
* ``cache.keys``: the chained hashes of a prompt's block keys, inside each
  of the two above (two a request);
* ``train_step.forward``, ``train_step.optimizer``: the train step's loss
  and its update (device work: ranges for the profiler's device time);
* counters ``cache.blocks_hashed``, ``cache.gets``, ``cache.sets``,
  ``cache.hit_cache`` (gets that attached to an object another tenant
  holds) and ``cache.new_pages`` (pool pages a write-back allocated);
* counter ``moe.transposed_backward``: one a backward of the MoE's
  dispatch or combine (``models/moe.py``), two a layer a backward;
* ``train_step.mla``: MLA's full-sequence forward (``models/attention.py``
  ``mla_forward``: the projections, norms, RoPE and the K3 launch), and
  ``train_step.moe_route``: the MoE's routing (``models/moe.py``
  ``moe_route``: router, softmax, top k, aux loss, capacity slots). Both
  are device work, named under ``train_step.`` as the step's own ranges
  are, since a reading of a profiled step keeps the device time of ranges
  of that prefix; under remat each runs again in the backward. They run
  outside a train step too (a forward's logits; serving's routing);
* counters ``moe.group_limited``, one a routing that took its top k from
  a limited set of expert groups, and ``moe.held_only``, one an MoE layer
  that computed the part of the experts it holds, one chip's share, with
  no model-parallel group (both in ``models/moe.py``).

``ServingEngine.submit`` opens one request record around each request.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch.autograd.profiler as _profiler

KEEP = 4096                     # request records kept


class RequestRecord:
    """One request's spans ({name: [seconds, ...]}, in the order they
    ended) and counters ({name: total})."""

    __slots__ = ("spans", "counts")

    def __init__(self) -> None:
        self.spans: Dict[str, List[float]] = {}
        self.counts: Dict[str, int] = {}

    def seconds(self, name: str) -> float:
        """The request's spans of ``name``, summed."""
        return sum(self.spans.get(name, ()))


_records: Deque[RequestRecord] = deque(maxlen=KEEP)
_open: Optional[RequestRecord] = None
span_totals: Dict[str, list] = {}
counter_totals: Dict[str, int] = {}


class span:
    """``with span(name): ...`` times the block on the host clock."""

    __slots__ = ("name", "_t0", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        dt = (time.perf_counter_ns() - self._t0) * 1e-9
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        tot = span_totals.get(self.name)
        if tot is None:
            span_totals[self.name] = [1, dt]
        else:
            tot[0] += 1
            tot[1] += dt
        if _open is not None:
            _open.spans.setdefault(self.name, []).append(dt)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name``."""
    counter_totals[name] = counter_totals.get(name, 0) + n
    if _open is not None:
        _open.counts[name] = _open.counts.get(name, 0) + n


class request:
    """``with request() as r: ...`` opens one :class:`RequestRecord` for the
    block and keeps it when the block ends."""

    __slots__ = ("record",)

    def __enter__(self) -> RequestRecord:
        global _open
        _open = self.record = RequestRecord()
        return self.record

    def __exit__(self, *exc) -> None:
        global _open
        _open = None
        _records.append(self.record)


def records(n: Optional[int] = None) -> List[RequestRecord]:
    """The last ``n`` kept request records (all of them by default), oldest
    first."""
    out = list(_records)
    return out if n is None else out[len(out) - min(n, len(out)):]
