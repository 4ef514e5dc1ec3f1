"""Ambient sharding-constraint registry for model-internal tensors (a
copy of ``repro.models.shardctx``: pure Python).

Model code is mesh-agnostic; the launcher installs named constraint
functions (e.g. the MoE dispatch buffers must be (E->model, C->data) or
they replicate 80 GB per device at deepseek-v2 scale). Smoke tests leave
the registry empty and every constraint is the identity.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Optional

_RULES: Dict[str, Callable] = {}


def set_rules(rules: Optional[Dict[str, Callable]]) -> None:
    global _RULES
    _RULES = dict(rules or {})


@contextmanager
def rules(r: Optional[Dict[str, Callable]]):
    global _RULES
    old = _RULES
    _RULES = dict(r or {})
    try:
        yield
    finally:
        _RULES = old


def constrain(name: str, x):
    fn = _RULES.get(name)
    return fn(x) if fn is not None else x


def param(name: str, default):
    """Non-callable tuning values installed by the launcher (e.g. the MoE
    position-assignment chunk count = shard count)."""
    v = _RULES.get(name, default)
    return v if not callable(v) else default


def get(name: str, default=None):
    """Raw registry access (e.g. the shard_map EP MoE override)."""
    return _RULES.get(name, default)
