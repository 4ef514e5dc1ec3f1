"""Mixture-of-Experts FFN (granite-moe-1b-a400m; deepseek-v2-236b's shared
experts), in PyTorch: the reference's ``repro.models.moe`` step for step.
DeepSeek-V2's routing, which the reference lacks, is the port's own:
group-limited greedy top-k, weights left unnormalised and scaled, the
sequence-wise balance loss, and a layer that holds one chip's share of
the experts (``ArchConfig``'s ``n_group``, ``topk_group``,
``routed_scaling``, ``seq_aux``, ``expert_first`` and ``experts_held``;
each default is the reference's layer).

Dispatch is gather based, as in the reference: capacity positions from
running per-expert counts, the routing inverted into a slot -> choice
table with a sentinel slot, one gather into (E, C, d) expert buffers,
the expert SwiGLU batched over E, and one gather per routing choice
back, accumulated in f32. The
reference computes all of it in XLA outside any Pallas kernel, so its
plain torch is the port. Dispatch and combine are two autograd functions,
each one's backward a gather like the other's forward (the sentinel slot
a zero row): autograd's backward of a gather, a sorted scatter-add, would
add every empty slot into token 0 and every dropped choice into one slot,
one row after another.

The layer may be partitioned over the ``model`` ranks (the ``shardctx``
rule ``"model_parallel"`` with the family ``"moe"``): every rank routes
the same tokens alike, so the kept slots are the single-device layer's;
a rank holding E/m of the experts (split on their expert dim) dispatches,
runs and gathers back only the choices that landed on them, a rank
holding f/m columns of every expert runs all of them on its columns, and
the shared experts run on this rank's columns as a partitioned dense MLP;
one all-reduce sums the ranks' parts. The tokens that reach the experts
and the combine weights enter the partitioned part, so that the router's
gradient sums every rank's choices once (its aux loss's part is the same
on every rank, and is not summed).

Two points where torch differs from JAX and the port follows JAX:
``jax.lax.top_k`` breaks ties toward the lower index, which ``torch.topk``
does not promise, so the top k are the first k of a stable descending
sort; and products promote as JAX does (:func:`~.layers.matmul`).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from . import shardctx
from .layers import Params, dense_init, matmul, mlp_apply, mlp_init, model_parallel


def moe_init(gen: torch.Generator, cfg, dtype=torch.float32, device=None,
             lead: tuple = ()) -> Params:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    held = lead + (cfg.held_experts,)
    p: Params = {
        "router": dense_init(gen, d, E, torch.float32, device, lead),   # router in f32
        "w_gate": dense_init(gen, d, f, dtype, device, held),
        "w_up": dense_init(gen, d, f, dtype, device, held),
        "w_down": dense_init(gen, f, d, dtype, device, held),
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


def group_limited_top_k(probs: torch.Tensor, k: int, n_group: int, topk_group: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V2's group-limited greedy top-k over the last axis: the
    experts in ``n_group`` equal groups in index order, a group scored by
    its best expert; the ``topk_group`` best groups are kept and the k
    best of their experts taken. Ties go to the lower index, among groups
    and among experts (:func:`top_k_lower_index`)."""
    N, E = probs.shape
    size = E // n_group
    _, groups = top_k_lower_index(probs.reshape(N, n_group, size).amax(-1), topk_group)
    kept = torch.zeros((N, n_group), dtype=torch.bool, device=probs.device)
    kept.scatter_(1, groups, True)
    # a score is at least 0, so an expert of a dropped group is never taken
    return top_k_lower_index(probs.masked_fill(~kept.repeat_interleave(size, 1), -1.0), k)


def sequence_aux(probs: torch.Tensor, top_i: torch.Tensor, seq_len: int) -> torch.Tensor:
    """DeepSeek-V2's sequence-wise balance loss: sum_i f_i P_i of each
    sequence of ``seq_len`` tokens, averaged over the sequences, with f_i
    = E / (k T) x the sequence's choices of expert i among its k T and P_i
    the sequence's mean score of expert i."""
    N, E = probs.shape
    k, S = top_i.shape[1], N // seq_len
    ids = top_i.reshape(S, seq_len * k)
    counts = torch.zeros((S, E), dtype=probs.dtype, device=probs.device)
    counts.scatter_add_(1, ids, torch.ones(ids.shape, dtype=probs.dtype, device=probs.device))
    f = counts * (E / (k * seq_len))
    return (f * probs.reshape(S, seq_len, E).mean(dim=1)).sum(-1).mean()


def moe_route(xf: torch.Tensor, p: Params, cfg, *, capacity_factor: float = 1.25,
              no_drop: bool = False, seq_len: int = 0) -> Dict[str, torch.Tensor]:
    """The routing of ``N`` tokens ``xf`` (N, d), sequences of ``seq_len``
    tokens (0: one sequence): the router's top-k weights ``top_w`` and
    experts ``top_i`` (N, k), the aux loss, the capacity ``C``, ``keep``
    (N, k: the choice fits its expert's capacity) and ``dest`` (N, k: the
    slot ``e * C + position``, or ``E * C`` when dropped).

    The top k are taken from ``cfg.topk_group`` of ``cfg.n_group`` groups
    where that is fewer than all (:func:`group_limited_top_k`, counter
    ``moe.group_limited``), renormalised if ``cfg.moe_renormalize`` and
    scaled by ``cfg.routed_scaling``; the aux loss is the sequence-wise
    one with ``cfg.seq_aux`` (:func:`sequence_aux`; under data parallel
    this rank's sequences, whose gradients the step averages), else
    Switch's over the global batch."""
    with tracing.span("train_step.moe_route"):
        return _route(xf, p, cfg, capacity_factor, no_drop, seq_len)


def _route(xf, p, cfg, capacity_factor, no_drop, seq_len):
    N = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    dev = xf.device
    logits = matmul(xf.float(), p["router"])                         # (N, E) f32
    probs = torch.softmax(logits, dim=-1)
    if cfg.topk_group < cfg.n_group:
        tracing.count("moe.group_limited")
        top_w, top_i = group_limited_top_k(probs, k, cfg.n_group, cfg.topk_group)
    else:
        top_w, top_i = top_k_lower_index(probs, k)                   # (N, k)
    if cfg.moe_renormalize:
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    if cfg.routed_scaling != 1.0:
        top_w = top_w * cfg.routed_scaling

    # Under a data-parallel train step these N tokens are this rank's rows
    # of ranks x N: the means and the capacity are the global batch's
    dp = shardctx.get("data_parallel")
    ranks = 1 if dp is None else dp.size

    if cfg.seq_aux:
        aux = sequence_aux(probs, top_i, seq_len or N)
    else:
        # Load-balance aux loss (Switch-style): E * sum_e f_e * m_e
        f_e = F.one_hot(top_i[:, 0], E).float().mean(dim=0)          # top-1 fraction
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

    # choice j of a token comes after every choice j' < j of its chunk and
    # choice j of every earlier token: one scan over the chunk's choices
    # in (j, token) order gives the reference's k scans at once
    ti = top_i.reshape(chunks, Nc, k).transpose(1, 2).reshape(chunks, k * Nc)
    oh = shardctx.constrain("moe_cne", F.one_hot(ti, E))            # (ch, k Nc, E)
    # the count before each choice; scanned along the last axis, which the
    # card scans far faster than an outer one
    within = torch.cumsum(oh.transpose(1, 2), dim=2).transpose(1, 2) - oh
    pos = within.gather(2, ti[:, :, None]).reshape(chunks, k, Nc).transpose(1, 2).reshape(N, k)
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
    r = moe_route(xf, p, cfg, capacity_factor=capacity_factor, no_drop=no_drop, seq_len=T)
    return moe_combine(xf, p, cfg, r).reshape(B, T, d), r["aux"]


def moe_combine(xf: torch.Tensor, p: Params, cfg, r: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The expert outputs of the tokens ``xf`` (N, d) under the routing
    ``r`` of :func:`moe_route`, weighted and summed, plus the shared
    experts: (N, d). Partitioned (:func:`~.layers.model_parallel`), the
    experts ``p`` holds: E/m of them or f/m columns of each; the ranks'
    parts summed. A layer whose ``w_gate`` holds fewer than
    ``cfg.n_experts`` experts (this rank's E/m, from expert ``index`` E/m;
    or, on one chip, ``cfg.experts_held`` from ``cfg.expert_first``, one
    chip's share of an expert-parallel layer: counter ``moe.held_only``)
    computes their part alone, the other experts' choices left out."""
    mp = model_parallel("moe")
    if mp is not None:
        xf = mp.enter(xf)
        r = {**r, "top_w": mp.enter(r["top_w"])}
    held = p["w_gate"].shape[-3]
    if held != cfg.n_experts:
        if mp is None:
            tracing.count("moe.held_only")
        r = held_routing(r, cfg.expert_first + (mp.index * held if mp is not None else 0), held)
    out = moe_gather(expert_ffn(moe_dispatch(xf, r, held), p), r, xf.dtype)
    if cfg.n_shared_experts > 0:
        out = out + mlp_apply(xf, p["shared"])
    return out if mp is None else mp.leave(out)


def held_routing(r: Dict[str, torch.Tensor], first: int, held: int) -> Dict[str, torch.Tensor]:
    """The routing ``r`` as the ``held`` experts from expert ``first`` see
    it: each choice's slot among them (``first * C`` less) and kept where
    it was kept and landed on one of them, else on the sentinel slot
    ``held * C``. :func:`moe_dispatch` and :func:`moe_gather` over ``held``
    experts then dispatch and combine those choices alone."""
    C, top_i = r["C"], r["top_i"]
    keep = r["keep"] & (top_i >= first) & (top_i < first + held)
    return {**r, "keep": keep, "dest": torch.where(keep, r["dest"] - first * C, held * C)}


def moe_slots(dest: torch.Tensor, E: int, C: int) -> torch.Tensor:
    """The routing ``dest`` (N, k) inverted: for each of the E * C slots
    the choice ``n * k + j`` that fills it, or ``N * k`` when it is empty
    (int64). Kept slots are unique; dropped choices all land on the
    sentinel slot ``E * C``, which is cut off."""
    N, k = dest.shape
    slot_nj = torch.full((E * C + 1,), N * k, dtype=torch.int64, device=dest.device)
    slot_nj[dest.reshape(-1)] = torch.arange(N * k, device=dest.device)
    return slot_nj[: E * C]


def moe_dispatch(xf: torch.Tensor, r: Dict[str, torch.Tensor], E: int) -> torch.Tensor:
    """The (E, C, d) expert buffers of the tokens ``xf`` (N, d): the
    routing inverted into slot -> token, then one gather. Empty slots read
    token 0 and are never gathered back; the backward
    (:class:`_Dispatch`) gathers by choice and never reads them."""
    N = xf.shape[0]
    C, dest = r["C"], r["dest"]
    slot_tok = torch.remainder(moe_slots(dest, E, C) // dest.shape[1], N)   # empty: N -> 0
    slot_tok = shardctx.constrain("moe_ec", slot_tok.reshape(E, C))
    return shardctx.constrain("moe_ecd", _Dispatch.apply(xf, slot_tok, dest))


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the combine and the dispatch's backward accumulate in:
    f32, or f64 for f64 inputs."""
    return torch.promote_types(dtype, torch.float32)


def _padded(rows: torch.Tensor) -> torch.Tensor:
    """``rows`` (S, d) with one zero row appended at index S."""
    return torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])


class _Dispatch(torch.autograd.Function):
    """``xf[slot_tok]``: (N, d) tokens into (E, C, d) slots. Its backward
    is the combine's gather without weights: token n's gradient sums its
    k choices' slot rows (``dest``; the sentinel ``E * C`` reads a zero
    row), in f32, so no slot is added into a token it did not hold."""

    @staticmethod
    def forward(ctx, xf, slot_tok, dest):
        E, C = slot_tok.shape
        ctx.save_for_backward(dest)
        ctx.dtype = xf.dtype
        return xf.index_select(0, slot_tok.reshape(-1)).reshape(E, C, xf.shape[-1])

    @staticmethod
    def backward(ctx, dxe):
        (dest,) = ctx.saved_tensors
        tracing.count("moe.transposed_backward")
        rows = _padded(dxe.reshape(-1, dxe.shape[-1]))
        dxf = rows.index_select(0, dest[:, 0]).to(_acc_dtype(ctx.dtype))
        for j in range(1, dest.shape[1]):
            dxf += rows.index_select(0, dest[:, j])
        return dxf.to(ctx.dtype), None, None


def expert_ffn(xe: torch.Tensor, p: Params) -> torch.Tensor:
    """The experts' SwiGLU batched over the leading expert axis: (E, C, d)
    in, (E, C, d) out."""
    h = F.silu(matmul(xe, p["w_gate"])) * matmul(xe, p["w_up"])
    h = shardctx.constrain("moe_ecf", h)
    return shardctx.constrain("moe_ecd", matmul(h, p["w_down"]))


def moe_gather(ye: torch.Tensor, r: Dict[str, torch.Tensor], dtype) -> torch.Tensor:
    """The combine: one gather from the expert outputs ``ye`` (E, C, d) per
    routing choice, weighted and accumulated in f32, in ``dtype``: (N, d).
    A dropped choice (``dest`` on the sentinel ``E * C``) reads a zero row
    and weighs 0. The backward (:class:`_Combine`) is a gather too."""
    E, C, _ = ye.shape
    dest = r["dest"]
    w = (r["top_w"] * r["keep"]).to(_acc_dtype(ye.dtype))           # 0 if dropped
    return _Combine.apply(ye, w, dest, moe_slots(dest, E, C), dtype)


class _Combine(torch.autograd.Function):
    """``out[n] = sum_j w[n, j] * ye[dest[n, j]]`` in f32, j in order, in
    ``dtype``. Its backward is the dispatch's gather, weighted: slot s of
    choice (n, j) (``slot_nj``) gets ``w[n, j] * dout[n]``, an empty slot
    0, each slot written once; ``w`` gets each choice's row dot
    ``<dout[n], ye[dest[n, j]]>`` in f32."""

    @staticmethod
    def forward(ctx, ye, w, dest, slot_nj, dtype):
        rows = _padded(ye.reshape(-1, ye.shape[-1]))                 # sentinel: a zero row
        acc = _acc_dtype(ye.dtype)
        out = torch.zeros((dest.shape[0], rows.shape[-1]), dtype=acc, device=ye.device)
        for j in range(dest.shape[1]):
            g = shardctx.constrain("moe_nd", rows.index_select(0, dest[:, j]))
            out = out + g * w[:, j, None]                              # in f32
        ctx.save_for_backward(rows, w, dest, slot_nj)
        ctx.shape = ye.shape
        return out.to(dtype)

    @staticmethod
    def backward(ctx, dout):
        rows, w, dest, slot_nj = ctx.saved_tensors
        tracing.count("moe.transposed_backward")
        N, k = dest.shape
        acc = w.dtype
        dye = dw = None
        if ctx.needs_input_grad[0]:
            # an empty slot (N k) reads token N, a zero row, at weight 0
            w_slot = torch.cat([w.reshape(-1), w.new_zeros(1)]).index_select(0, slot_nj)
            g = _padded(dout).index_select(0, slot_nj // k)
            dye = torch.mul(g, w_slot[:, None], out=torch.empty_like(rows[:-1])).reshape(ctx.shape)
        if ctx.needs_input_grad[1]:
            dout = dout.to(acc)
            dw = torch.stack([(dout * rows.index_select(0, dest[:, j])).sum(-1)
                              for j in range(k)], dim=1)
        return dye, dw, None, None, None
