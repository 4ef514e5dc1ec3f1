"""Segmented-LRU (S-LRU) variant of the shared-object cache (paper §VII).

Memcached's S-LRU splits each LRU into HOT / WARM / COLD sub-lists:

* new items enter HOT (LRU);
* items aged out of HOT move to WARM only if accessed at least twice
  (popular), otherwise to COLD;
* WARM is FIFO; items aged out of WARM drop to COLD (re-queued once if
  they were touched while in WARM);
* evictions are taken from the COLD tail.

The paper reports cache-hit probabilities within ~2-3 % of flat LRU under
object sharing; ``benchmarks/bench_slru.py`` reproduces that comparison.

All sharing/apportionment/ripple logic is inherited unchanged from
:class:`repro_torch.core.shared_lru.SharedLRUCache`; only the list-structure
hooks are overridden.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

from .shared_lru import SharedLRUCache

HOT, WARM, COLD = 0, 1, 2
_SEG_NAMES = ("HOT", "WARM", "COLD")


class _Segments:
    """Per-proxy S-LRU state: three ordered dicts + access metadata."""

    __slots__ = ("segs", "seg_of", "hits", "active", "hot_frac", "warm_frac")

    def __init__(self, hot_frac: float, warm_frac: float) -> None:
        self.segs = (OrderedDict(), OrderedDict(), OrderedDict())
        self.seg_of: Dict[object, int] = {}
        self.hits: Dict[object, int] = {}
        self.active: Dict[object, bool] = {}
        self.hot_frac = hot_frac
        self.warm_frac = warm_frac

    def __contains__(self, key: object) -> bool:
        return key in self.seg_of

    def __len__(self) -> int:
        return len(self.seg_of)

    def keys(self) -> List[object]:
        """Tail-to-head order across COLD, WARM, HOT (eviction order)."""
        out: List[object] = []
        for s in (COLD, WARM, HOT):
            out.extend(self.segs[s].keys())
        return out

    def __iter__(self):
        return iter(self.keys())


class SegmentedSharedLRUCache(SharedLRUCache):
    """Object-sharing cache where each proxy runs an S-LRU list.

    ``hot_frac``/``warm_frac`` are the fractions of each proxy's *item
    count* allowed in HOT/WARM before aging (memcached defaults: 32 % /
    32 %); segment budgets are expressed in items, matching memcached's
    per-slabclass behaviour with one slabclass (the paper's setup).
    """

    def __init__(
        self,
        allocations: Sequence[int],
        physical_capacity: Optional[int] = None,
        *,
        hot_frac: float = 0.32,
        warm_frac: float = 0.32,
        **kw,
    ) -> None:
        if not (0.0 < hot_frac < 1.0 and 0.0 < warm_frac < 1.0):
            raise ValueError("segment fractions must be in (0, 1)")
        if hot_frac + warm_frac >= 1.0:
            raise ValueError("hot_frac + warm_frac must be < 1")
        self._hot_frac = hot_frac
        self._warm_frac = warm_frac
        super().__init__(allocations, physical_capacity, **kw)
        # Replace the flat OrderedDicts with segmented structures.
        self.lists = [  # type: ignore[assignment]
            _Segments(hot_frac, warm_frac) for _ in range(self.J)
        ]

    # -- segment balancing -------------------------------------------------
    def _age(self, i: int) -> None:
        """Move items HOT->WARM/COLD and WARM->COLD per memcached rules."""
        st: _Segments = self.lists[i]  # type: ignore[assignment]
        total = len(st)
        if total == 0:
            return
        hot_cap = max(1, int(st.hot_frac * total))
        warm_cap = max(1, int(st.warm_frac * total))
        while len(st.segs[HOT]) > hot_cap:
            key = next(iter(st.segs[HOT]))
            del st.segs[HOT][key]
            dest = WARM if st.hits.get(key, 0) >= 2 else COLD
            st.segs[dest][key] = None
            st.seg_of[key] = dest
        while len(st.segs[WARM]) > warm_cap:
            key = next(iter(st.segs[WARM]))
            del st.segs[WARM][key]
            if st.active.pop(key, False):
                st.segs[WARM][key] = None  # one FIFO re-queue if touched
            else:
                st.segs[COLD][key] = None
                st.seg_of[key] = COLD

    # -- hooks --------------------------------------------------------------
    def _list_insert_head(self, i: int, key: object) -> None:
        st: _Segments = self.lists[i]  # type: ignore[assignment]
        st.segs[HOT][key] = None
        st.seg_of[key] = HOT
        st.hits[key] = 1
        self._age(i)

    def _list_remove(self, i: int, key: object) -> None:
        st: _Segments = self.lists[i]  # type: ignore[assignment]
        seg = st.seg_of.pop(key)
        del st.segs[seg][key]
        st.hits.pop(key, None)
        st.active.pop(key, None)

    def _list_promote(self, i: int, key: object) -> None:
        st: _Segments = self.lists[i]  # type: ignore[assignment]
        st.hits[key] = st.hits.get(key, 0) + 1
        seg = st.seg_of[key]
        if seg == HOT:
            st.segs[HOT].move_to_end(key)
        elif seg == WARM:
            st.active[key] = True  # FIFO: mark touched, no reorder
        else:  # COLD hit -> promote to WARM head (memcached behaviour)
            del st.segs[COLD][key]
            st.segs[WARM][key] = None
            st.seg_of[key] = WARM
            self._age(i)

    def _list_victim(self, i: int) -> object:
        st: _Segments = self.lists[i]  # type: ignore[assignment]
        for seg in (COLD, WARM, HOT):
            if st.segs[seg]:
                return next(iter(st.segs[seg]))
        raise RuntimeError(f"victim requested from empty list {i}")

    # -- introspection overrides --------------------------------------------
    def list_keys(self, i: int) -> List[object]:
        return self.lists[i].keys()  # type: ignore[union-attr]

    def segment_of(self, i: int, key: object) -> str:
        st: _Segments = self.lists[i]  # type: ignore[assignment]
        return _SEG_NAMES[st.seg_of[key]]
