"""Trees of tensors (nested dicts and lists, as the models' parameters and
the train state are) flattened in ``jax.tree_util``'s order: a dict's
keys sorted, a list in order. Leaf numbers and paths therefore match the
reference's, which the checkpoint layout relies on."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    return [(f"[{i}]", v) for i, v in enumerate(tree)]


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in order; a path as ``jax.tree_util.keystr`` writes
    it, e.g. ``['params']['blocks']['g0']['attn']['wq']`` or ``['tail'][0]``."""
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += flatten_with_paths(child, prefix + key)
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure with ``values`` (in order) as leaves.
    No reference cycle holds ``values`` afterwards (a recursive closure
    would, until the garbage collector ran: a step's gradients too)."""
    return _build(like, iter(values))


def _build(t, it):
    if isinstance(t, dict):
        built = {k: _build(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}          # the caller's key order
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``."""
    flat = [leaves(t) for t in (tree,) + rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
