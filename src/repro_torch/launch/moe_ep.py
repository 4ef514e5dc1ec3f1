"""Expert-parallel MoE with explicit all-to-alls, on ``torch.distributed``
(the reference's ``repro.launch.moe_ep``, a ``shard_map`` of einsums and
collectives; no Pallas kernel).

Each rank routes its own block of tokens, packs them into per-expert
buffers, and sends each expert's buffer to the rank of the ``model`` axis
that owns the expert; the results come back the same way. Per rank and
layer that moves 2 cf k N_local d values, where gathering every token to
every rank would move N_global d. Capacity is per rank (C_loc =
cf k N_loc / E), so which tokens drop differs from the single-device
``models.moe.moe_apply`` by design. Large expert weights (E d f at least
64 Mi values) are split over the data axes along f and all-gathered
inside, as the reference does.

The override takes global x and global weights on every rank, as the
reference's mapped function does, and returns the global (out, aux) on
every rank, as its ``out_specs`` do. It is differentiable, as the
reference's ``shard_map`` is: with the same loss on every rank, a
backward through it gives every rank the whole gradient of x and of the
weights (each collective's backward is its transpose).

Installed into the model through ``models.shardctx`` under the key
``"moe_apply"``: the transformer uses it for training and prefill;
decode keeps the exact drop-free path (``no_drop``), where the override
declines.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.layers import mlp_apply
from repro_torch.models.moe import expert_ffn, moe_dispatch, moe_gather, moe_route

from .mesh import gather_cat, place

F_SPLIT_VALUES = 64 * 1024 * 1024   # E d f from which f is split over the data axes


class _Take(torch.autograd.Function):
    """The block ``index`` of a tensor that every rank holds whole; the
    backward adds every rank's gradient of its block into the whole
    tensor's (an all-reduce over all ranks)."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.shape, ctx.index = x.shape, index
        return x[index]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.index] = g
        dist.all_reduce(full)
        return full, None


class _Assemble(torch.autograd.Function):
    """Every rank's (B/dsz, T/msz, d) block of out put together into the
    global (B, T, d) on every rank; the backward takes this rank's block
    of the (same on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, pl, index):
        ctx.index = index
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat([torch.cat([parts[r] for r in row], dim=1) for row in pl.ranks], dim=0)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.index].contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` in equal chunks along dim 0: chunk i goes to
    the group's rank i, and chunk i of the result came from it. Its
    transpose is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _GatherParts(torch.autograd.Function):
    """The data group's slices of a weight put together along ``dim``; the
    backward sums the group's gradients and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, ranks, dim, index):
        ctx.group, ctx.index = group, index
        return gather_cat(x, group, ranks, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.index].contiguous(), None, None, None, None


class _Mean(torch.autograd.Function):
    """The mean of a scalar over all ranks."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = dist.get_world_size()
        out = x.clone()
        dist.all_reduce(out)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n


def make_moe_apply_ep(mesh, cfg):
    """The expert-parallel ``moe_apply(x, p, cfg, ...)`` for ``mesh``, or
    None when the mesh has no ``model`` axis or its size does not divide
    the experts (the caller keeps the single-device path)."""
    pl = place(mesh)
    if pl is None or cfg.n_experts % pl.msz != 0:
        return None
    msz, dsz = pl.msz, pl.dsz
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E // msz
    f, d = cfg.moe_d_ff, cfg.d_model
    f_split = E * d * f >= F_SPLIT_VALUES and pl.has_data and f % dsz == 0
    experts = slice(pl.mi * E_loc, (pl.mi + 1) * E_loc)
    f_part = slice(pl.di * (f // dsz), (pl.di + 1) * (f // dsz)) if f_split else slice(None)
    data_ranks = [row[pl.mi] for row in pl.ranks]

    def weight(w, f_dim):
        """This rank's experts of ``w`` (E, ., .), whole along f (its f
        slice all-gathered over the data group when f is split)."""
        index = (experts,) + ((slice(None), f_part) if f_dim == 2 else (f_part,))
        w = _Take.apply(w, index)
        if f_split:
            w = _GatherParts.apply(w, pl.data_group, data_ranks, f_dim,
                                   (slice(None),) * f_dim + (f_part,))
        return w

    def local(xl, router, w):
        """xl: this rank's (B/dsz, T/msz, d) tokens; w: its experts'
        weights. Returns its tokens' output and its aux loss."""
        B_l, T_l, _ = xl.shape
        N_loc = B_l * T_l
        xf = xl.reshape(N_loc, d)
        C_loc = max(1, int(round(cfg.capacity_factor * k * N_loc / E)))
        r = moe_route(xf, {"router": router}, cfg, capacity_factor=cfg.capacity_factor)
        if r["C"] != C_loc:
            raise ValueError(f"expert parallelism needs one routing chunk (C={r['C']}, "
                             f"C_loc={C_loc}); remove the 'moe_chunks' rule")
        xe = moe_dispatch(xf, r, E)                                 # (E, C, d), all experts
        # to the experts' owners: chunk m (experts of rank m) goes to rank
        # m; xr[s] holds source s's tokens for this rank's experts
        xr = _AllToAll.apply(xe.reshape(msz * E_loc * C_loc, d), pl.model_group)
        xr = xr.reshape(msz, E_loc, C_loc, d).transpose(0, 1).reshape(E_loc, msz * C_loc, d)
        ye = expert_ffn(xr, w)                                      # (E_loc, msz C, d)
        # back to the sources: yl[m] holds this rank's tokens' results
        # from expert rank m, so yl is (E, C, d) in expert order
        yb = ye.reshape(E_loc, msz, C_loc, d).transpose(0, 1).reshape(msz * E_loc * C_loc, d)
        yl = _AllToAll.apply(yb, pl.model_group).reshape(E, C_loc, d)
        return moe_gather(yl, r, xl.dtype).reshape(B_l, T_l, d), r["aux"]

    def moe_apply_ep(x, p, cfg_unused=None, *, capacity_factor=None, no_drop=False):
        """(out, aux) of the MoE layer ``p`` on the global x (B, T, d), or
        None where this path does not apply (decode's ``no_drop``, or B,
        T not divisible by the data and model axes). The per-rank
        capacity takes ``cfg.capacity_factor``, whatever the caller
        passes, as the reference's does."""
        if no_drop:
            return None                               # decode: the exact single-device path
        B, T, _ = x.shape
        if (pl.has_data and B % dsz != 0) or T % msz != 0:
            return None
        B_l, T_l = B // dsz, T // msz
        block = (slice(pl.di * B_l, (pl.di + 1) * B_l), slice(pl.mi * T_l, (pl.mi + 1) * T_l))
        xl = _Take.apply(x, block)
        router = _Take.apply(p["router"], (slice(None),))
        w = {"w_gate": weight(p["w_gate"], 2), "w_up": weight(p["w_up"], 2),
             "w_down": weight(p["w_down"], 1)}
        out_l, aux_l = local(xl, router, w)
        out = _Assemble.apply(out_l, pl, block)
        aux = _Mean.apply(aux_l)
        if cfg.n_shared_experts > 0:
            out = out + mlp_apply(x, p["shared"])
        return out, aux

    return moe_apply_ep
