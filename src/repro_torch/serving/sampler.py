"""Token sampling and the greedy decode loop of the live serving path."""

from __future__ import annotations

from typing import Optional

import torch


def sample_token(
    logits: torch.Tensor,               # (B, V)
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
) -> torch.Tensor:
    """Greedy (argmax, first maximum on ties) at ``temperature <= 0``;
    otherwise a draw from softmax(logits / temperature), restricted to the
    ``top_k`` largest logits when ``top_k > 0``. The draw uses
    ``generator``: it does not give ``jax.random.categorical``'s bits, only
    its distribution. Returns (B,) int32."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling with temperature needs a torch.Generator")
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < cutoff, torch.full_like(logits, -1e30), logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def greedy_decode(model, params, first_logits, caches, *, start_pos: int,
                  n_steps: int) -> torch.Tensor:
    """Greedy decode loop, looped on the host; one ``model.decode_step`` per
    token after the first, which comes from ``first_logits``.

    Returns (B, n_steps) int32 generated token ids.
    """
    B = first_logits.shape[0]
    tok = torch.argmax(first_logits[:, -1, :], dim=-1).to(torch.int32)
    out = [tok]
    pos = torch.full((B,), start_pos, dtype=torch.int32, device=first_logits.device)
    for _ in range(n_steps - 1):
        logits, caches = model.decode_step(params, tok[:, None].long(), caches, pos)
        tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)
