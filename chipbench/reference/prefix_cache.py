"""The paper's shared cache (Section III) in front of a prefix store, as a
plain reference of the serving engine's cache decisions.

Each tenant (proxy) keeps an LRU list of block objects; an object held by
the set P(n) of tenants charges each of them 1/|P(n)| block. A block
object is one full block of a prompt, keyed by the whole token prefix up
to its end, so equal prefixes are one object whatever the tenant.

A request is a lookup, then a write-back:

* lookup: a get of each block object in order, stopping at the first
  that is not physically cached. A hit in the tenant's own list promotes
  it; a hit elsewhere (another holder's object, or a ghost) puts it at
  the head of the tenant's list and runs the eviction loop. Each hit
  adds one block of cached tokens.
* write-back: a set of every block object from the first one not cached:
  a new object is stored (after freeing ghosts, oldest first, while the
  cache is full) and put at the head of the list; a held one is promoted
  or attached. Each set runs the eviction loop, then frees ghosts while
  the cache is over capacity.
* eviction loop: while some list is longer than its allocation, take the
  list with the largest excess (the lowest index on a tie) and drop its
  least recently used object; an object no tenant holds any more stays
  as a ghost (the cache keeps it while it has room). Every drop is an
  eviction, a ripple eviction when the list is not the requesting
  tenant's.

Lengths are exact fractions. The allocations come from the mix: tenant
t's share of the pool's bytes, in whole blocks.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Sequence

import numpy as np


@dataclass
class Decision:
    cached_tokens: int
    evictions: int
    ripple_evictions: int


class SharedPrefixCacheRef:
    def __init__(self, allocations: Sequence[int], capacity: int, block_tokens: int) -> None:
        self.b = [Fraction(int(a)) for a in allocations]
        self.B = int(capacity)
        self.bt = block_tokens
        self.lists: List[OrderedDict] = [OrderedDict() for _ in allocations]   # MRU at the end
        self.holders: Dict[bytes, set] = {}
        self.ghosts: OrderedDict = OrderedDict()                               # oldest first
        self.stored: set = set()
        self.vlen = [Fraction(0)] * len(allocations)                          # sum of shares

    # -- the paper's rules ------------------------------------------------
    def _reshare(self, key: bytes, sign: int) -> None:
        """Adds (sign 1) or takes away (sign -1) every holder's share of ``key``."""
        hs = self.holders.get(key, ())
        for j in hs:
            self.vlen[j] += sign * Fraction(1, len(hs))

    def _attach(self, i: int, key: bytes) -> None:
        self.ghosts.pop(key, None)
        self._reshare(key, -1)
        self.holders.setdefault(key, set()).add(i)
        self._reshare(key, 1)
        self.lists[i][key] = None

    def _detach(self, i: int, key: bytes) -> None:
        del self.lists[i][key]
        self._reshare(key, -1)
        self.holders[key].discard(i)
        self._reshare(key, 1)
        if not self.holders[key]:
            del self.holders[key]
            self.ghosts[key] = None

    def _loop(self, trigger: int) -> tuple:
        ev = rip = 0
        while True:
            over = [self.vlen[i] - self.b[i] for i in range(len(self.b))]
            worst = max(range(len(over)), key=lambda i: (over[i], -i))
            if over[worst] <= 0:
                return ev, rip
            self._detach(worst, next(iter(self.lists[worst])))
            ev += 1
            rip += worst != trigger

    def _free_ghosts(self, need: int) -> None:
        while len(self.stored) + need > self.B and self.ghosts:
            key, _ = self.ghosts.popitem(last=False)
            self.stored.discard(key)

    # -- a request ------------------------------------------------------
    def keys(self, tokens: np.ndarray) -> List[bytes]:
        out, h = [], hashlib.sha256()
        for j in range(len(tokens) // self.bt):
            h.update(np.asarray(tokens[j * self.bt:(j + 1) * self.bt], dtype="<i8").tobytes())
            out.append(h.copy().digest())
        return out

    def request(self, tenant: int, tokens: np.ndarray) -> Decision:
        keys = self.keys(tokens)
        ev = rip = hits = 0
        for key in keys:
            if key in self.lists[tenant]:
                self.lists[tenant].move_to_end(key)
            elif key in self.stored:
                self._attach(tenant, key)
                e, r = self._loop(tenant)
                ev, rip = ev + e, rip + r
            else:
                break
            hits += 1
        for key in keys[hits:]:
            if key not in self.stored:
                self._free_ghosts(1)
                self.stored.add(key)
                self._attach(tenant, key)
            elif key in self.lists[tenant]:
                self.lists[tenant].move_to_end(key)
            else:
                self._attach(tenant, key)
            e, r = self._loop(tenant)
            ev, rip = ev + e, rip + r
            self._free_ghosts(0)
        return Decision(hits * self.bt, ev, rip)
