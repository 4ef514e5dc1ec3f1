"""The numbers a run compares with the reference, each against its limit
(``limits/<cell>.json``)."""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

SAMPLE = 1 << 20        # elements of a leaf's change that both sides keep


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   leaves: Iterable[str] = ()) -> Tuple[float, str]:
    """The largest |prog - ref| over the leaves (all of ``ref``'s by
    default), each measured against the reference's norm of that leaf or
    of the median leaf, whichever is larger. A leaf the program lacks, or
    reads as not finite, counts as infinitely far."""
    names = list(leaves) or list(ref)
    med = float(np.median([ref[n] for n in ref]))
    worst, where = 0.0, ""
    for n in names:
        p = prog.get(n, math.nan)
        gap = abs(p - ref[n]) / max(ref[n], med, 1e-30)
        if not math.isfinite(gap):
            gap = math.inf
        if gap > worst or not where:
            worst, where = gap, n
    return worst, where


def sample_index(seed: int, leaf: int, numel: int, device) -> Optional[torch.Tensor]:
    """Which elements of leaf number ``leaf``'s change both sides keep:
    all of a leaf of at most SAMPLE elements (None), else SAMPLE drawn
    from the seed (with repeats), the same on both sides of one device."""
    if numel <= SAMPLE:
        return None
    g = torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + leaf) % (1 << 63))
    return torch.randint(0, numel, (SAMPLE,), generator=g, device=device)


def kept_change(seed: int, device) -> Callable[[int, torch.Tensor], torch.Tensor]:
    """(leaf number, its change) -> the kept elements, f64 on the host."""
    def keep(leaf: int, delta: torch.Tensor) -> torch.Tensor:
        flat = delta.flatten()
        idx = sample_index(seed, leaf, flat.numel(), delta.device)
        return (flat if idx is None else flat[idx]).double().cpu()
    return keep


def leaf_diffs(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves: Iterable[str]) -> Dict[str, float]:
    """||prog - ref|| / ||ref|| of each leaf's kept change: a change in
    another direction than the reference's (a sign or a gradient gone
    wrong), which the norms alone do not see. A leaf the program lacks,
    or reads as not finite, counts as infinitely far."""
    out = {}
    for n in leaves:
        r, p = ref[n], prog.get(n)
        gap = math.inf if p is None or p.shape != r.shape else float(
            torch.linalg.vector_norm(p - r) / max(float(torch.linalg.vector_norm(r)), 1e-30))
        out[n] = gap if math.isfinite(gap) else math.inf
    return out


def moved_leaves(ref_grad: Dict[str, float], rel: float = 1e-3) -> list:
    """The leaves whose first gradient in the reference is at least ``rel``
    of the median leaf's: the others move under Adam by round-off alone."""
    med = float(np.median(list(ref_grad.values())))
    return [n for n, g in ref_grad.items() if g >= rel * med]


def train_readings(prog: dict, ref: dict) -> Dict[str, tuple]:
    """{name: (value, where)} of the training cells' compared numbers."""
    loss = max(abs(a - b) if math.isfinite(a) else math.inf
               for a, b in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = math.inf
    first = abs(prog["loss"][0] - ref["loss"][0])
    moved = moved_leaves(ref["grad_norm"])
    diffs = leaf_diffs(prog["change_sample"], ref["change_sample"], moved)
    worst = max(diffs, key=diffs.get)
    return {
        "loss_gap": (loss, "steps 1-%d" % len(ref["loss"])),
        "first_loss_gap": (first if math.isfinite(first) else math.inf, "step 1"),
        "change_diff_gap": (diffs[worst], worst),
        "grad_norm_gap": worst_leaf_gap(prog["grad_norm"], ref["grad_norm"]),
        "change_norm_gap": worst_leaf_gap(prog["change_norm"], ref["change_norm"], moved),
    }
