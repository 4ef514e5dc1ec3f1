"""Flash-decoding over a sequence-split KV cache, on ``torch.distributed``
(the reference's ``repro.launch.flash_decode``, a ``shard_map`` of
einsums and collectives; no Pallas kernel).

Each rank of the ``model`` axis owns S/msz cache slots, computes its
masked local attention's partials (the row maximum m, the denominator l
and the numerator; ``chunked_attention``'s own scan, so that one rank
gives the single-device decode to the last bit), and the ranks merge
them with the
log-sum-exp combine, the same merge as the shared-prefix kernel's
(``kernels.ref.lse_merge``): one all-reduce MAX of m and two SUMs, in
place of the reference's ``pmax`` and two ``psum``s. Per layer that moves
(B, H, Dv) + 2 (B, H) values, where gathering the cache would move all
of it. One code path serves GQA's full attention, the local ring buffer
and MLA's latent MQA (KV = 1, Dv = the latent width).

The override takes the global tensors on every rank, as the reference's
mapped function does, and returns the global output on every rank, as
its ``out_specs`` do: a rank reads its own slots and batch rows only. A
cache held split across the ranks (the memory reason for flash-decoding)
belongs with training's sharding and is not built here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.attention import decode_partials

from .mesh import gather_cat, place


def make_decode_attention(mesh):
    """The ``decode_attention`` override for ``mesh`` (install it with
    ``models.shardctx.rules({"decode_attention": ...})``), or None when
    the mesh has no ``model`` axis."""
    pl = place(mesh)
    if pl is None:
        return None
    msz, dsz = pl.msz, pl.dsz

    def override(q, k, v, valid_len, scale):
        """q: (B, 1, H, D); k: (B, S, KV, D); v: (B, S, KV, Dv); valid
        (B,). Returns (B, 1, H, Dv) in q's dtype, or None if this mesh and
        these shapes cannot take the path."""
        B, T, H, _ = q.shape
        S = k.shape[1]
        if T != 1 or S % msz != 0 or (pl.has_data and B % dsz != 0):
            return None
        B_l, S_l = B // dsz, S // msz
        rows = slice(pl.di * B_l, (pl.di + 1) * B_l)
        cols = slice(pl.mi * S_l, (pl.mi + 1) * S_l)
        valid_loc = torch.clamp(valid_len[rows].to(q.device) - pl.mi * S_l, 0, S_l)
        # the local partials: chunked_attention's own scan over this
        # rank's slots, so that a model axis of 1 gives its result to the
        # last bit; masked scores are -1e30, so a rank whose slots are all
        # past valid has m = -1e30 and weight 0 below
        num, m_loc, den = decode_partials(q[rows], k[rows, cols], v[rows, cols], valid_loc,
                                          scale)
        # merge across the model axis (the flash-decoding combine)
        m_g = m_loc.clone()
        dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=pl.model_group)
        w = torch.exp(m_loc - m_g)
        num = num * w[..., None]
        den = den * w
        dist.all_reduce(num, group=pl.model_group)
        dist.all_reduce(den, group=pl.model_group)
        out = (num / torch.clamp(den, min=1e-30)[..., None]).reshape(B_l, 1, H, -1).to(q.dtype)
        if dsz > 1:
            out = gather_cat(out, pl.data_group, [row[pl.mi] for row in pl.ranks])
        return out

    return override
