"""The benchmark's inputs of a model: its parameters, drawn from the seed
on the device in a few large calls, in the port's parameter tree. Which
leaves a configuration has, their shapes and their scales are its
architecture module's (:mod:`chipbench.archs`); the plain reference reads
the same tree by the same paths, so both sides get the same numbers.

One f32 draw a leaf, in the order of the architecture's ``leaf_specs``,
from one generator: the same seed gives the same values on the same
device, and :func:`leaves` can draw them again one at a time.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Iterator, Tuple

import torch


def draw(specs: Iterable[Tuple[str, tuple, float]], keeps_f32: Callable[[str], bool], seed: int,
         device, dtype=torch.float32) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) of each (path, shape, std) of ``specs`` in order, each
    drawn normal(0, std) in f32 from one generator seeded by ``seed`` on
    ``device`` (std 0: ones, no draw) and cast to ``dtype`` unless
    ``keeps_f32(path)``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    for path, shape, std in specs:
        if std == 0.0:
            t = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device).mul_(std)
        yield path, (t if keeps_f32(path) else t.to(dtype))


def leaves(c: dict, seed: int, device, dtype=torch.float32, rank: int = 0, world: int = 1
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) of configuration ``c`` in order, rank ``rank``'s share
    of ``world``: its architecture's ``leaves``."""
    from chipbench import archs

    return archs.of(c).leaves(c, seed, device, dtype, rank, world)


def flat(c: dict, seed: int, device, dtype=torch.float32, rank: int = 0, world: int = 1
         ) -> Dict[str, torch.Tensor]:
    """Every leaf by path."""
    return dict(leaves(c, seed, device, dtype, rank, world))


def nest(flat_params: Dict[str, torch.Tensor]) -> dict:
    """The port's nested tree of a {path: leaf} map."""
    tree: dict = {}
    for path, t in flat_params.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def unnest(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The {path: leaf} map of a nested tree (the inverse of :func:`nest`)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        out.update(unnest(v, f"{prefix}/{k}" if prefix else k))
    return out
