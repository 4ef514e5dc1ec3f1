"""Tenant-facing shared prefix cache = the paper's system, deployed.

Objects are **block-aligned prefix extensions**: for a request's token
ids, object ``i`` is the i-th block of its prefix, keyed by the rolling
hash of all tokens up to and including that block (vLLM-style chained
prefix keys — equal prefixes collide into the SAME object regardless of
tenant, which is exactly what makes them shareable). Each object's
length is ``bytes_per_block`` from the arch's :mod:`kv_layout`.

Residency and fairness are delegated 1:1 to the paper's
:class:`~repro_torch.core.shared_lru.SharedLRUCache`:

* ``lookup`` = a chain of MCD ``get``s (stops at the first miss —
  a prefix is only usable up to its first non-resident block);
* ``insert`` = ``set`` per new block (allocates pool pages);
* physical eviction (holder consensus, ghosts exhausted) frees pages
  back to the :class:`BlockPool` via the eviction hook;
* ripple evictions, ghost retention, RRE slack, admission — all inherited
  behaviors, measured by the serving benchmarks.

``lookup``, ``insert`` and their key hashing are the spans
``cache.lookup``, ``cache.insert`` and ``cache.keys`` of
:mod:`repro_torch.tracing`, which lists their counters.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.shared_lru import EvictionEvent, GetResult, SharedLRUCache
from repro_torch.tracing import count, span

from .block_pool import BlockPool
from .kv_layout import KVLayout


def _chain_hash(prev: bytes, token_block: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(np.asarray(token_block, dtype=np.int64).tobytes())
    return h.digest()


@dataclass
class InsertStats:
    """Aggregate outcome of :meth:`SharedPrefixCache.insert`.

    ``result``/``evictions`` describe the *last* block's ``set`` (the
    deepest prefix extension); the totals aggregate every ``set`` in the
    insert, so callers no longer have to sum per-block stats themselves.
    """

    result: GetResult
    evictions: List[EvictionEvent] = field(default_factory=list)
    total_evictions: int = 0
    total_ripple: int = 0
    new_pages: int = 0             # pool pages allocated by this insert


@dataclass
class PrefixLookup:
    cached_blocks: int            # usable prefix length, in blocks
    cached_tokens: int
    block_ids: List[int]          # physical page ids for the cached prefix
    keys: List[bytes]             # object keys per block of the full prefix
    hit_list: int = 0             # LRU-list hits (charged to tenant)
    hit_cache: int = 0            # LRU miss / physical hit (sharing event)
    evictions: int = 0
    ripple_evictions: int = 0


class SharedPrefixCache:
    def __init__(
        self,
        pool: BlockPool,
        layout: KVLayout,
        tenant_allocations: Dict[str, int],   # bytes per tenant (b_i)
        *,
        physical_capacity_bytes: Optional[int] = None,
        ghost_retention: bool = True,
        ripple_allocations: Optional[Dict[str, int]] = None,
    ) -> None:
        self.pool = pool
        self.layout = layout
        self.tenants = list(tenant_allocations)
        self.tenant_idx = {t: i for i, t in enumerate(self.tenants)}
        blocks_of = lambda b: max(int(b // max(layout.bytes_per_block, 1)), 1)
        alloc_blocks = [blocks_of(tenant_allocations[t]) for t in self.tenants]
        if physical_capacity_bytes is None:
            cap_blocks = pool.n_blocks
        else:
            cap_blocks = blocks_of(physical_capacity_bytes)
        cap_blocks = min(cap_blocks, pool.n_blocks)
        ripple = None
        if ripple_allocations is not None:
            ripple = [blocks_of(ripple_allocations[t]) for t in self.tenants]
        self.manager = SharedLRUCache(
            alloc_blocks,
            physical_capacity=max(cap_blocks, sum(alloc_blocks)),
            ghost_retention=ghost_retention,
            ripple_allocations=ripple,
        )
        if self.manager.B > pool.n_blocks:
            # The manager's eviction loop only guarantees resident blocks
            # <= its capacity B; if B exceeds the pool, insert() would hit
            # pool exhaustion on a perfectly legal cache state. Refuse the
            # oversubscription up front instead of skipping pages later.
            raise ValueError(
                f"cache capacity {self.manager.B} blocks exceeds the "
                f"physical pool ({pool.n_blocks} blocks); shrink tenant "
                "allocations or grow the pool"
            )
        self.manager.physical_evict_hook = self._on_physical_evict
        # object key -> physical page id
        self.pages: Dict[bytes, int] = {}

    # ------------------------------------------------------------------
    def _on_physical_evict(self, key: object) -> None:
        page = self.pages.pop(key, None)
        if page is not None:
            self.pool.free([page])

    def _keys_for(self, token_ids: Sequence[int]) -> List[bytes]:
        with span("cache.keys"):
            bt = self.layout.block_tokens
            keys = []
            prev = b"root"
            for i in range(len(token_ids) // bt):
                prev = _chain_hash(prev, token_ids[i * bt : (i + 1) * bt])
                keys.append(prev)
        count("cache.blocks_hashed", len(keys))
        return keys

    # ------------------------------------------------------------------
    def lookup(self, tenant: str, token_ids: Sequence[int]) -> PrefixLookup:
        """Chained get: usable cached prefix + sharing/eviction stats."""
        with span("cache.lookup"):
            ti = self.tenant_idx[tenant]
            keys = self._keys_for(token_ids)
            out = PrefixLookup(0, 0, [], keys)
            for key in keys:
                st = self.manager.get(ti, key)
                if st.result is GetResult.MISS:
                    break
                if st.result is GetResult.HIT_LIST:
                    out.hit_list += 1
                else:
                    out.hit_cache += 1
                    out.evictions += st.n_evictions
                    out.ripple_evictions += st.n_ripple
                out.cached_blocks += 1
                out.block_ids.append(self.pages[key])
            out.cached_tokens = out.cached_blocks * self.layout.block_tokens
        # the chain stops at its first miss, which is a get too
        count("cache.gets", out.cached_blocks + (out.cached_blocks < len(keys)))
        count("cache.hit_cache", out.hit_cache)
        return out

    def insert(
        self, tenant: str, token_ids: Sequence[int], start_block: int = 0
    ) -> Tuple[List[int], InsertStats]:
        """Write-back after prefill: ``set`` each block object from
        ``start_block`` on; allocates physical pages for new objects.
        Returns (page ids for the inserted range, aggregate stats)."""
        with span("cache.insert"):
            ti = self.tenant_idx[tenant]
            keys = self._keys_for(token_ids)
            pages: List[int] = []
            stats = InsertStats(GetResult.MISS)
            for key in keys[start_block:]:
                # the manager accounts in block units: every object = 1 block.
                # set() FIRST: its ghost evictions free pool pages (via the
                # physical-evict hook) before we allocate the new one — the
                # __init__ capacity check guarantees resident blocks fit the
                # pool, so a fresh block always gets a page.
                last = self.manager.set(ti, key, 1)
                stats.result = last.result
                stats.evictions = last.evictions
                stats.total_evictions += last.n_evictions
                stats.total_ripple += last.n_ripple
                if key not in self.pages:
                    self.pages[key] = self.pool.alloc(1)[0]
                    stats.new_pages += 1
                pages.append(self.pages[key])
        count("cache.sets", len(pages))
        count("cache.new_pages", stats.new_pages)
        return pages, stats

    def block_table(self, tenant: str, token_ids: Sequence[int]) -> np.ndarray:
        """Physical page ids for a fully-resident prefix (decode path)."""
        keys = self._keys_for(token_ids)
        return np.array([self.pages[k] for k in keys if k in self.pages],
                        dtype=np.int32)

    # -- stats -----------------------------------------------------------
    def vlen_bytes(self, tenant: str) -> float:
        return self.manager.vlen(self.tenant_idx[tenant]) * self.layout.bytes_per_block

    def sharing_ratio(self) -> float:
        """Mean |P(n)| over resident objects — how shared the cache is."""
        hs = self.manager.holders
        if not hs:
            return 0.0
        return float(np.mean([len(s) for s in hs.values()]))
