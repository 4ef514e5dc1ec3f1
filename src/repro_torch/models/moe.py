"""Mixture-of-Experts FFN (granite-moe-1b-a400m; deepseek-v2-236b's shared
experts), in PyTorch: the reference's ``repro.models.moe`` step for step.

Dispatch is gather based, as in the reference: capacity positions from
running per-expert counts, an int32 slot -> token table with a sentinel
slot, one gather into (E, C, d) expert buffers, the expert SwiGLU batched
over E, and one gather per routing choice back, accumulated in f32. The
reference computes all of it in XLA outside any Pallas kernel, so its
plain torch is the port.

Two points where torch differs from JAX and the port follows JAX:
``jax.lax.top_k`` breaks ties toward the lower index, which ``torch.topk``
does not promise, so the top k are the first k of a stable descending
sort; and products promote as JAX does (:func:`~.layers.matmul`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import shardctx
from .layers import Params, dense_init, matmul, mlp_apply, mlp_init


def moe_init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
             lead: tuple = ()) -> Params:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p: Params = {
        "router": dense_init(gen, d, E, torch.float32, device, lead),   # router in f32
        "w_gate": dense_init(gen, d, f, dtype, device, lead + (E,)),
        "w_up": dense_init(gen, d, f, dtype, device, lead + (E,)),
        "w_down": dense_init(gen, f, d, dtype, device, lead + (E,)),
    }
    if cfg.n_shared_experts > 0:
        p["shared"] = mlp_init(gen, d, cfg.moe_d_ff * cfg.n_shared_experts, dtype, device,
                               lead)
    return p


def top_k_lower_index(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values, ties
    broken toward the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(xf: torch.Tensor, p: Params, cfg, *, capacity_factor: float = 1.25,
              no_drop: bool = False) -> Dict[str, torch.Tensor]:
    """The routing of ``N`` tokens ``xf`` (N, d): the router's top-k weights
    ``top_w`` and experts ``top_i`` (N, k), the aux loss, the capacity
    ``C``, ``keep`` (N, k: the choice fits its expert's capacity) and
    ``dest`` (N, k: the slot ``e * C + position``, or ``E * C`` when
    dropped)."""
    N = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    dev = xf.device
    logits = matmul(xf.float(), p["router"])                         # (N, E) f32
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = top_k_lower_index(probs, k)                       # (N, k)
    if cfg.moe_renormalize:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    # Under a data-parallel train step these N tokens are this rank's rows
    # of ranks x N: the means and the capacity are the global batch's
    dp = shardctx.get("data_parallel")
    ranks = 1 if dp is None else dp.size

    # Load-balance aux loss (Switch-style): E * sum_e f_e * m_e
    f_e = F.one_hot(top_i[:, 0], E).float().mean(dim=0)              # top-1 fraction
    m_e = probs.mean(dim=0)
    if dp is not None:
        f_e, m_e = dp.sum_(f_e * (1.0 / ranks)), dp.all_sum(m_e * (1.0 / ranks))
    aux = E * torch.sum(f_e * m_e)

    # --- capacity + positions, per chunk of tokens (the reference's
    # per-shard capacity; one chunk unless the launcher installs more) --
    chunks, Ng = int(shardctx.param("moe_chunks", 1)), N * ranks
    if Ng % chunks != 0 or chunks < 1:
        chunks = 1
    if chunks % ranks:
        raise ValueError(f"moe_chunks {chunks} over {Ng} tokens does not give each of the "
                         f"{ranks} data-parallel ranks its own chunks")
    if no_drop:
        C = Ng
    else:
        C = int(max(1, round(capacity_factor * k * Ng / E)))
    C = max(chunks * max(C // chunks, 1), chunks)                    # divisible per chunk
    Cc = C // chunks
    chunks //= ranks                                                 # this rank's chunks
    C, Nc = Cc * chunks, N // chunks

    ti = top_i.reshape(chunks, Nc, k)
    pos = torch.zeros((chunks, Nc, k), dtype=torch.int64, device=dev)
    counts = torch.zeros((chunks, E), dtype=torch.int64, device=dev)
    for j in range(k):                                               # choice j, token order
        oh = shardctx.constrain("moe_cne", F.one_hot(ti[:, :, j], E))  # (ch, Nc, E)
        # the count before this token; scanned along the last axis, which
        # the card scans far faster than an outer one
        within = torch.cumsum(oh.transpose(1, 2), dim=2).transpose(1, 2) - oh
        pos[:, :, j] = (within.gather(2, ti[:, :, j:j + 1])[:, :, 0]
                        + counts.gather(1, ti[:, :, j]))
        counts = counts + oh.sum(dim=1)
    pos = pos.reshape(N, k)
    keep = pos < Cc                                                  # (N, k)
    chunk_of = torch.arange(N, device=dev)[:, None] // Nc
    slot_in_e = chunk_of * Cc + pos
    dest = torch.where(keep, top_i * C + slot_in_e, E * C)           # overflow slot E*C
    return dict(top_w=top_w, top_i=top_i, aux=aux, C=C, keep=keep, dest=dest)


def moe_apply(
    x: torch.Tensor,            # (B, T, d)
    p: Params,
    cfg,
    *,
    capacity_factor: float = 1.25,
    no_drop: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (B, T, d), aux load-balance loss, an f32 scalar).

    ``no_drop=True`` sets capacity C = N (each expert receives at most
    one assignment per token, so C = N drops nothing): the decode path.
    """
    B, T, d = x.shape
    xf = shardctx.constrain("moe_nd", x.reshape(B * T, d))
    r = moe_route(xf, p, cfg, capacity_factor=capacity_factor, no_drop=no_drop)
    return moe_combine(xf, p, cfg, r).reshape(B, T, d), r["aux"]


def moe_combine(xf: torch.Tensor, p: Params, cfg, r: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The expert outputs of the tokens ``xf`` (N, d) under the routing
    ``r`` of :func:`moe_route`, weighted and summed, plus the shared
    experts: (N, d)."""
    xe = moe_dispatch(xf, r, cfg.n_experts)
    out = moe_gather(expert_ffn(xe, p), r, xf.dtype)
    if cfg.n_shared_experts > 0:
        out = out + mlp_apply(xf, p["shared"])
    return out


def moe_dispatch(xf: torch.Tensor, r: Dict[str, torch.Tensor], E: int) -> torch.Tensor:
    """The (E, C, d) expert buffers of the tokens ``xf`` (N, d): the
    routing inverted into slot -> token (int32), then one gather. Kept
    slots are unique; dropped choices all land on the sentinel slot,
    which is cut off. Empty slots read token 0 and are never gathered
    back."""
    N = xf.shape[0]
    C, dest = r["C"], r["dest"]
    token_ids = torch.arange(N, dtype=torch.int32, device=xf.device)
    slot_tok = torch.zeros((E * C + 1,), dtype=torch.int32, device=xf.device)
    for j in range(dest.shape[1]):
        slot_tok[dest[:, j]] = token_ids
    slot_tok = shardctx.constrain("moe_ec", slot_tok[: E * C].reshape(E, C))
    return shardctx.constrain("moe_ecd", xf[slot_tok.long()])


def expert_ffn(xe: torch.Tensor, p: Params) -> torch.Tensor:
    """The experts' SwiGLU batched over the leading expert axis: (E, C, d)
    in, (E, C, d) out."""
    h = F.silu(matmul(xe, p["w_gate"])) * matmul(xe, p["w_up"])
    h = shardctx.constrain("moe_ecf", h)
    return shardctx.constrain("moe_ecd", matmul(h, p["w_down"]))


def moe_gather(ye: torch.Tensor, r: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """The combine: one gather from the expert outputs ``ye`` (E, C, d) per
    routing choice, weighted and accumulated in f32, in ``dtype``: (N, d)."""
    E, C, d = ye.shape
    keep, dest, top_w = r["keep"], r["dest"], r["top_w"]
    out = torch.zeros((dest.shape[0], d), dtype=torch.float32, device=ye.device)
    for j in range(dest.shape[1]):
        w_j = (top_w[:, j] * keep[:, j]).float()                     # 0 if dropped
        slot = torch.clamp(dest[:, j], max=E * C - 1)
        g = shardctx.constrain("moe_nd", ye[slot // C, slot % C])
        out = out + g.float() * w_j[:, None]
    return out.to(dtype)
