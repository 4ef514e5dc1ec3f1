"""The reference's first training steps: the readings that the training
cells compare with the program's."""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch

from . import optimizer


Leaves = Iterable[Tuple[str, torch.Tensor]]


def readings(params: Dict[str, torch.Tensor], initial: Callable[[], Leaves],
             c: dict, o: dict, batches: List[dict], *, loss: Callable,
             batch_rows: slice = slice(None),
             keep: Optional[Callable[[int, torch.Tensor], torch.Tensor]] = None) -> dict:
    """Steps ``len(batches)`` of AdamW on ``loss(params, c, batch)`` (the
    architecture's reference loss) from ``params`` (updated in place;
    their dtype is the precision the steps run in). Returns each step's
    loss, the first gradient's norm by leaf (unclipped, as the optimizer
    is handed it) and the norm of each leaf's change after the last step
    against ``initial()`` (the starting values, drawn again leaf by
    leaf), and with ``keep`` what it keeps of each leaf's change
    (``keep(leaf number, change)``). ``batch_rows`` takes part of each
    batch: a fault."""
    leaves = list(params)
    for t in params.values():
        t.requires_grad_(True)
    mu = {n: torch.zeros_like(t) for n, t in params.items()}
    nu = {n: torch.zeros_like(t) for n, t in params.items()}
    losses, grad_norms = [], {}
    for s, batch in enumerate(batches, start=1):
        b = {k: v[batch_rows] for k, v in batch.items()}
        with torch.enable_grad():
            value = loss(params, c, b)
            grads = torch.autograd.grad(value, [params[n] for n in leaves])
        g = dict(zip(leaves, grads))
        losses.append(float(value.detach()))
        if s == 1:
            grad_norms = {n: float(torch.linalg.vector_norm(v.double())) for n, v in g.items()}
        optimizer.adamw_step(params, g, mu, nu, o, s)
        del g, grads, value
    change, kept = {}, {}
    with torch.no_grad():
        for i, (n, p0) in enumerate(initial()):
            d = params[n].double() - p0.double()
            change[n] = float(torch.linalg.vector_norm(d))
            if keep is not None:
                kept[n] = keep(i, d)
    return {"loss": losses, "grad_norm": grad_norms, "change_norm": change,
            "change_sample": kept}
