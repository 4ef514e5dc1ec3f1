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

The override returns the global output on every rank, as the reference's
``out_specs`` do, and takes the cache in either of two forms:

* held split, as the reference places it (``P(data, "model", None,
  None)``; :class:`SplitCaches`): k and v are this rank's block as it is,
  its S/msz slots at offset mi S/msz (and its batch rows), and ``block``
  (a ``models.attention.CacheBlock``) says where it sits. Each rank
  allocates and holds only its slots: the memory reason for
  flash-decoding;
* whole on every rank (``block`` None), as the reference's mapped function
  takes global tensors: a rank reads its own slots and batch rows only.

q and the valid lengths are the whole batch's on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.models import shardctx
from repro_torch.models.attention import CacheBlock, decode_partials
from repro_torch.training.data_parallel import ModelParallel
from repro_torch.training.tree import flatten_with_paths, tree_map, unflatten

from .mesh import (Sharding, axis_size, data_axes, gather_cat, local_block, partitioned_leaves,
                   path_keys, place)

SLOT_LEAVES = ("k", "v", "c_kv", "k_rope")      # the caches indexed by slot


def make_decode_attention(mesh):
    """The ``decode_attention`` override for ``mesh`` (install it with
    ``models.shardctx.rules({"decode_attention": ...})``), or None when
    the mesh has no ``model`` axis."""
    pl = place(mesh)
    if pl is None:
        return None
    msz, dsz = pl.msz, pl.dsz

    def override(q, k, v, valid_len, scale, block=None):
        """q: (B, 1, H, D); k: (B, S, KV, D); v: (B, S, KV, Dv), or this
        rank's block of them (``block``); valid (B,). Returns (B, 1, H, Dv)
        in q's dtype, or None if this mesh and these shapes cannot take the
        path."""
        B, T, H, _ = q.shape
        S = k.shape[1] if block is None else block.total
        if T != 1 or S % msz != 0 or (pl.has_data and B % dsz != 0):
            return None
        B_l, S_l = B // dsz, S // msz
        rows = slice(pl.di * B_l, (pl.di + 1) * B_l)
        if block is None:
            cols = slice(pl.mi * S_l, (pl.mi + 1) * S_l)
            k, v = k[rows, cols], v[rows, cols]
        else:
            if (block.slot, block.slots) != (pl.mi * S_l, S_l):
                raise ValueError(f"a cache block of slots [{block.slot}, "
                                 f"{block.slot + block.slots}) on model rank {pl.mi} of {msz}: "
                                 f"the cache is not split over this mesh's model axis")
            if not block.row <= rows.start < rows.stop <= block.row + block.rows:
                raise ValueError(f"a cache block of rows [{block.row}, {block.row + block.rows}) "
                                 f"does not hold data rank {pl.di}'s rows [{rows.start}, "
                                 f"{rows.stop})")
            own = slice(rows.start - block.row, rows.stop - block.row)
            k, v = k[own], v[own]
        valid_loc = torch.clamp(valid_len[rows].to(q.device) - pl.mi * S_l, 0, S_l)
        # the local partials: chunked_attention's own scan over this
        # rank's slots, so that a model axis of 1 gives its result to the
        # last bit; masked scores are -1e30, so a rank whose slots are all
        # past valid has m = -1e30 and weight 0 below
        num, m_loc, den = decode_partials(q[rows], k, v, valid_loc, scale)
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


def _leaf(path: str) -> str:
    return path[path.rindex("[") + 2:-2]


def _lead(path: str) -> int:
    """The dims before the batch: 1 for the blocks stacked over tiles."""
    return 1 if path.startswith("['blocks']") else 0


def _kind(model, path: str) -> str:
    """The block kind of the layer a cache leaf belongs to."""
    keys = path_keys(path)
    if keys[0] == "blocks":
        return model.cfg.block_pattern[int(keys[1][1:])]
    return model.tail_kinds[keys[1]]


def _layer(path: str) -> str:
    return path[:path.rindex("[")]


class SplitCaches:
    """The caches of a ``TransformerLM`` held split over ``mesh``. Each
    attention cache (K, V; MLA's c_kv and k_rope) is split as the
    reference's flash-decoding places it (``P(data, "model", None,
    None)``): on its slots over ``"model"``, rank mi holding the contiguous
    slots [mi S/msz, (mi+1) S/msz), and on its batch rows over the data
    axes where they divide the batch (else whole there). Where the
    parameters (``params``, DTensors placed on ``mesh``, with their
    ``model``) partition attention over ``"model"`` (``launch.mesh.
    partitioned_leaves``), each GQA layer's K and V are split on their KV
    heads instead (``(B, S, KV, D)`` on ``P(None, None, "model", None)``):
    a rank computes and holds only its heads, and reads them with no
    merge; an MQA layer's (one KV head, its wk and wv replicated) and each
    MLA layer's latent cache are held whole on every rank (every head reads
    all of it: 576 values a token a layer of MLA at full width). Where they
    partition the RG-LRU on its width, each RG-LRU layer's state (``h`` (B,
    W) and ``conv`` (B, K-1, W)) is split on its last dim, rank r holding
    the channels it computes; where they partition the xLSTM blocks on
    their heads, each mLSTM layer's C (B, H, dh, dh), n and m and each
    sLSTM layer's c, n, m and h (B, H, dh) are split on H, and the mLSTM's
    ``conv`` (B, 3, 2d) on its channels; every other recurrent state is
    whole on every rank. The batch rows of a cache split on its heads or
    its width are whole on every rank (every rank computes every row).
    Cached as DTensors.

    Installed as the ``models.shardctx`` rule ``"cache_split"``, it makes
    the model's ``init_cache`` and ``prefill`` allocate and keep only this
    rank's block of each attention cache (:meth:`block`), and its
    ``decode_step`` read caches held so (:meth:`local`), whether written
    under the rule or placed by ``reshard_state(caches,
    split.shardings(model, batch, cache_len))``. A cache placed otherwise
    (a recurrent state, a latent cache or a non-partitioned layer's
    attention cache split on any dim; a partitioned layer's K and V held
    otherwise than on their heads, or its state otherwise than on its
    width or heads) is gathered whole for the step, and the rank keeps its
    block of what the step wrote. Parameters on the mesh come to the model
    through :meth:`params`: a partitioned leaf's block, every other leaf
    whole."""

    def __init__(self, mesh, model=None, params=None) -> None:
        from torch.distributed.tensor import DTensor

        names = tuple(mesh.mesh_dim_names)
        if "model" not in names:
            raise ValueError(f"mesh axes {names} hold no 'model' axis to split the caches over")
        self.mesh = mesh
        self.parallel, self._placed, self._parted = None, None, frozenset()
        self._ep = None             # (parallel, parted) under the expert-parallel override
        self._mqa = False           # attention partitioned with its KV head replicated
        if params is None:
            return
        items = []
        for path, t in flatten_with_paths(params):
            if not isinstance(t, DTensor) or t.device_mesh != mesh:
                raise ValueError(f"params{path} is not a DTensor on the caches' mesh")
            items.append((path, tuple(t.shape), tuple(t.placements)))
        families, self._parted = partitioned_leaves(model.cfg, mesh, items)
        self._placed = {path: pl for path, _, pl in items}
        self._mqa = "attn" in families and not any(
            p.endswith("['attn']['wk']") for p in self._parted)
        if families:
            self.parallel = ModelParallel(mesh, families)
        if "moe" in families:
            # under the expert-parallel override the MoE's weights come whole
            fams, parted = partitioned_leaves(model.cfg, mesh, items, gathered=("moe",))
            self._ep = ((ModelParallel(mesh, fams, self.parallel._count), parted) if fams
                        else (None, frozenset()))

    def _gqa_parted(self, model, kind: str) -> bool:
        return (self.parallel is not None and "attn" in self.parallel.families
                and kind in ("attn", "local") and not model._mla(kind))

    def on_heads(self, model, kind: str) -> bool:
        """Whether a ``kind`` layer's K and V are held split on their heads
        (its GQA attention partitioned over ``"model"``, the KV heads too)."""
        return self._gqa_parted(model, kind) and not self._mqa

    def latent_whole(self, model, kind: str) -> bool:
        """Whether a ``kind`` layer's attention cache is held whole on every
        rank: MLA's latent, or MQA's one KV head, partitioned over
        ``"model"``."""
        return (self._gqa_parted(model, kind) and self._mqa
                or self.parallel is not None and "mla" in self.parallel.families
                and model._mla(kind))

    def on_width(self, model, kind: str) -> bool:
        """Whether a ``kind`` layer's recurrent state is held split on its
        width (the RG-LRU partitioned over ``"model"``)."""
        return (kind == "rglru" and self.parallel is not None
                and "rglru" in self.parallel.families)

    def lru_width(self, model, kind: str) -> int:
        """The RG-LRU channels this rank holds of a ``kind`` layer's state."""
        W = model.cfg.lru_width
        return W // self.parallel.size if self.on_width(model, kind) else W

    def xlstm_parted(self, model, kind: str) -> bool:
        """Whether a ``kind`` layer is an xLSTM block partitioned over
        ``"model"`` on its heads (its state held split on them)."""
        return (kind in ("mlstm", "slstm") and self.parallel is not None
                and kind in self.parallel.families)

    def state_heads(self, model, kind: str) -> int:
        """The heads this rank holds of a ``kind`` xLSTM layer's state."""
        H = model.cfg.n_heads
        return H // self.parallel.size if self.xlstm_parted(model, kind) else H

    def state_dim(self, model, path: str, shape) -> Optional[int]:
        """The dim a partitioned layer's recurrent state leaf at ``path``
        (of ``shape``) is held split on over ``"model"``: an RG-LRU's state
        and the mLSTM's conv inputs on their last dim (channels), every
        other xLSTM state on H (the dim after the batch); None for any
        other leaf."""
        kind = _kind(model, path)
        if self.on_width(model, kind) or self.xlstm_parted(model, kind) and _leaf(path) == "conv":
            return len(shape) - 1
        if self.xlstm_parted(model, kind):
            return _lead(path) + 1
        return None

    def slot_split(self, model, kind: str) -> bool:
        """Whether a ``kind`` layer's attention cache is held split on its
        slots (and read through :class:`CacheBlock`)."""
        return (kind in ("attn", "local") and not self.on_heads(model, kind)
                and not self.latent_whole(model, kind))

    def kv_heads(self, model, kind: str) -> int:
        """The KV heads this rank holds of a ``kind`` layer's cache."""
        n = model.cfg.n_kv_heads
        return n // self.parallel.size if self.on_heads(model, kind) else n

    def params(self, model, params):
        """The parameters for this rank's prefill or decode step, and the
        ``shardctx`` rules they run under: placed parameters (DTensors, as
        they were when the rule was made) give each partitioned leaf's
        block and every other leaf whole (gathered where split), under
        ``"model_parallel"``; plain tensors are whole already."""
        from torch.distributed.tensor import DTensor

        flat = flatten_with_paths(params)
        if not any(isinstance(t, DTensor) for _, t in flat):
            if self._placed is not None:
                raise ValueError("these caches were laid out for parameters on the mesh; the "
                                 "parameters given are plain tensors")
            return params, {}
        if self._placed is None:
            raise ValueError("parameters on a mesh (DTensors) serve under SplitCaches(mesh, "
                             "model, params), made with them")
        parallel, parted = self.parallel, self._parted
        if self._ep is not None and shardctx.get("moe_apply") is not None:
            parallel, parted = self._ep
        out = []
        for path, t in flat:
            if not isinstance(t, DTensor) or tuple(t.placements) != self._placed.get(path):
                raise ValueError(f"params{path} is not placed as when the rule was made "
                                 f"({self._placed.get(path)})")
            out.append(t.to_local() if path in parted else t.full_tensor())
        rules = {"model_parallel": parallel} if parallel is not None else {}
        return unflatten(params, out), rules

    def _sharding(self, batch: int, ndim: int, lead: int) -> Sharding:
        dp = data_axes(self.mesh)
        rows = None
        if dp and batch % axis_size(self.mesh, dp) == 0:
            rows = dp[0] if len(dp) == 1 else dp
        return Sharding(self.mesh, (None,) * lead + (rows, "model") + (None,) * (ndim - lead - 2))

    def _leaf_sharding(self, model, path: str, shape) -> Sharding:
        """The placement :meth:`shardings` gives the cache leaf at ``path``."""
        lead, kind = _lead(path), _kind(model, path)
        if _leaf(path) in ("k", "v") and self.on_heads(model, kind):
            return Sharding(self.mesh, (None,) * lead + (None, None, "model", None))
        d = self.state_dim(model, path, shape)
        if d is not None:
            return Sharding(self.mesh, tuple("model" if i == d else None
                                             for i in range(len(shape))))
        if _leaf(path) in SLOT_LEAVES and self.latent_whole(model, kind):
            return Sharding(self.mesh)
        if _leaf(path) in SLOT_LEAVES:
            return self._sharding(shape[lead], len(shape), lead)
        return Sharding(self.mesh)

    def block(self, batch: int, slots: int, what: str = "") -> CacheBlock:
        """This rank's block of an attention cache of ``batch`` rows and
        ``slots`` slots; a slot count that does not divide over
        ``"model"`` raises, naming ``what``."""
        shape = (batch, slots)
        off, loc = local_block(shape, self.mesh,
                               self._sharding(batch, 2, 0).placements(shape, what))
        return CacheBlock(row=off[0], rows=loc[0], slot=off[1], slots=loc[1], total=slots)

    def shardings(self, model, batch: int, cache_len: int):
        """The placements of ``model.init_cache(batch, cache_len)``'s
        leaves: a tree of :class:`~repro_torch.launch.mesh.Sharding` for
        ``reshard_state``."""
        shapes = model.cache_specs(batch, cache_len)
        specs = []
        for path, t in flatten_with_paths(shapes):
            sh = self._leaf_sharding(model, path, tuple(t.shape))
            sh.placements(tuple(t.shape), "caches" + path)
            specs.append(sh)
        return unflatten(shapes, specs)

    def hold(self, model, caches, batch: int, cache_len: int):
        """``caches`` as this rank holds them (each attention cache its
        block) as DTensors placed by :meth:`shardings` (no collective)."""
        from torch.distributed.tensor import DTensor

        def held(local, sh, t):
            return DTensor.from_local(local, sh.mesh, sh.placements(tuple(t.shape)),
                                      run_check=False, shape=t.shape, stride=t.stride())

        return tree_map(held, caches, self.shardings(model, batch, cache_len),
                        model.cache_specs(batch, cache_len))

    def local(self, model, caches, position):
        """The caches for this rank's decode step at ``position`` (B,), per
        layer in the order the layers run its attention cache's
        :class:`CacheBlock` (None where the rank reads it whole, or holds
        its heads, or for a recurrent state), and a function that ends the
        step. Plain tensors are caches held whole. A leaf placed as
        :meth:`shardings` places it is read as it is held; a leaf placed
        otherwise is gathered whole (a layer's attention caches together)
        and, when the step ends, the rank keeps its block of it. A
        partitioned layer's K and V gathered so are handed to it as this
        rank's KV heads; each rank writes only its heads of the new row,
        so the step's end all-gathers the new rows' heads over ``"model"``
        (B x KV x D values a leaf) before the rank that holds the slot
        keeps them. A partitioned recurrent layer's state gathered so is
        handed to it as this rank's channels or heads (:meth:`state_dim`),
        and the step's end all-gathers the new state over ``"model"``."""
        from torch.distributed.tensor import DTensor

        flat = flatten_with_paths(caches)
        if not any(isinstance(t, DTensor) for _, t in flat):
            return caches, [None] * model.cfg.n_layers, lambda: None
        gather = set()
        for path, t in flat:
            where = "caches" + path
            if not isinstance(t, DTensor):
                raise ValueError(f"{where} is a plain tensor among caches on a mesh")
            if t.device_mesh != self.mesh:
                raise ValueError(f"{where} is on another mesh than the rule's")
            shape = tuple(t.shape)
            want = self._leaf_sharding(model, path, shape).placements(shape, where)
            if tuple(t.placements) != want:
                gather.add(_layer(path) if _leaf(path) in SLOT_LEAVES else path)
        out, blocks, back, rows, states = [], {}, [], [], []
        for path, t in flat:
            kind = _kind(model, path)
            if path in gather or (_leaf(path) in SLOT_LEAVES and _layer(path) in gather):
                whole = t.full_tensor()
                d = self.state_dim(model, path, tuple(t.shape))
                if d is not None:
                    # the rank's channels or heads for its step; the whole
                    # new state gathered from the ranks' at the step's end
                    n = whole.shape[d] // self.parallel.size
                    out.append(whole.narrow(d, self.parallel.index * n, n).contiguous())
                    states.append((whole, out[-1], d))
                    back.append((t, whole))
                    continue
                if _leaf(path) in ("k", "v") and self.on_heads(model, kind):
                    n = whole.shape[-2] // self.parallel.size
                    mine = whole[..., self.parallel.index * n:(self.parallel.index + 1) * n, :]
                    out.append(mine.contiguous())
                    rows.append((whole, out[-1], model._window(kind)))
                    back.append((t, whole))
                    continue
                out.append(whole)
                if any(p.is_shard() for p in t.placements):
                    back.append((t, whole))
                continue
            lead, shape = _lead(path), tuple(t.shape)
            if _leaf(path) in SLOT_LEAVES and self.slot_split(model, kind):
                blocks[_layer(path)] = self.block(shape[lead], shape[lead + 1], "caches" + path)
            out.append(t.to_local())

        def done():
            """Each gathered leaf's block of what the step wrote, kept."""
            for whole, mine, window in rows:
                self._new_rows(whole, mine, window, position)
            for whole, mine, d in states:
                whole.copy_(self.parallel.gather(mine, dim=d))
            for t, whole in back:
                off, loc = local_block(tuple(t.shape), self.mesh, t.placements)
                t.to_local().copy_(whole[tuple(slice(o, o + n) for o, n in zip(off, loc))])

        tile = [blocks.get(f"['blocks']['g{g}']") for g in range(len(model.cfg.block_pattern))]
        tail = [blocks.get(f"['tail'][{i}]") for i in range(model.n_tail)]
        return unflatten(caches, out), tile * model.n_tiles + tail, done

    def _new_rows(self, whole, mine, window: int, position) -> None:
        """Into ``whole`` (a K or V leaf (lead, B, S, KV, D) gathered for the
        step), the rows a decode step at ``position`` wrote into this rank's
        heads ``mine`` of it, with the other ranks' heads of them: one
        all-gather over ``"model"``."""
        lead = mine.ndim - 4
        pos = position.to(mine.device)
        at = (slice(None),) * lead + (torch.arange(mine.shape[lead], device=mine.device),
                                      pos % window if window > 0 else pos)
        whole[at] = self.parallel.gather(mine[at], dim=-2).to(whole.dtype)
