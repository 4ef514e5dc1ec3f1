"""The train step over a mesh (the reference gets it from ``jax.jit`` of its
pure step on a state placed by ``reshard_state``: GSPMD compiles whatever
placement it is given).

Every leaf of the state is a DTensor on one mesh, placed leaf by leaf:
replicated, or split over any mesh axes (``launch.mesh.Sharding``). The
moments mirror the parameters (``optimizer.py``), so ZeRO-1 (the moments
split over the data axes) and parameters split over ``model`` are two
choices of the same per-leaf placements. Each rank holds its own
contiguous rows of the global batch (rank ``di`` of ``dsz`` on the data
axes: rows [di B/dsz, (di+1) B/dsz)); the ranks of one ``model`` row hold
the same rows. The step computes what the reference's one program
computes on the global batch:

* each parameter is gathered whole for the forward and backward (an
  all-gather over each mesh axis it is split on); compute stays at full
  width on every rank;
* the loss is the global batch's: the masked cross-entropy sums its
  numerator and its token count over the data group, and the MoE aux loss
  takes f_e and m_e over the global batch (``models`` read the
  :class:`DataParallel` that the step installs in ``models.shardctx``
  under ``"data_parallel"``; m_e carries a gradient, so its sum is an
  autograd function whose backward sums the gradients: every rank holds
  the same loss, so each rank's gradient comes out ``dsz`` times its own
  rows' share);
* MoE capacity is per chunk of the reference's per-device capacity: the
  step installs ``moe_chunks = dsz``, so chunk r is rank r's rows and its
  capacity is the global C // dsz;
* microbatch i is the global rows [i B/n, (i+1) B/n), each split over the
  ranks (:meth:`DataParallel.microbatch_rows`);
* each gradient is averaged over the data group straight into its
  moments' placement (:meth:`DataParallel.reduce_grad`): a reduce-scatter
  over each data axis the moments are split on, an all-reduce over the
  others, a local slice over a ``model`` axis they are split on; then
  compression, the global-norm clip and AdamW run on the moments' local
  shards, with the whole tensor's scale and norm (:class:`Splits`), and
  each parameter's updated shard goes back to the parameter's own
  placement (:meth:`DataParallel.redistribute`: all-gathers);
* μ and ν of a leaf may be placed apart: the update runs on μ's placement,
  ν is redistributed into it and back (:class:`Placed`).

Partitioned compute over ``model`` (Megatron's column/row split, what
GSPMD derives from the same placements): where a family is placed so
(``launch.mesh.partitioned_leaves``: GQA's wq, wk, wv (MQA's wq alone) or
MLA's wq_b, w_uk, w_uv split on their output dim and wo on its input dim;
the RG-LRU's products so and its per-channel leaves on their width; the
xLSTM blocks' on their heads; the dense MLP's w_gate, w_up and w_down
likewise; an MoE layer's routed experts on their
expert dim or on their f columns, its shared experts as a dense MLP; the
embedding on its vocabulary rows and the head on its vocabulary columns,
"vocab"), its leaves are not gathered. Each rank computes its own heads
(H/m query heads and their KV/m key-value heads, or MQA's one; MLA's H/m
heads over the shared latent), its own RG-LRU channels, its own columns of the MLP, its own experts (or columns of
every expert) over the routing that every rank computes alike, or its own
V/m of the vocabulary (a masked lookup summed over ``model``; its block of
the logits, which the vocabulary-parallel cross-entropy reduces without
building the whole), with one all-reduce after each row product, MoE
combine or lookup (:class:`ModelParallel`, the ``shardctx`` rule
``"model_parallel"``, whose two autograd functions the models call); a
partitioned leaf's gradient is its block already and is averaged over the
data group only (a tied embedding's two uses both land in the rank's own
rows). The q and k norms of GQA, replicated but applied to each rank's
heads only, MQA's replicated wk and wv (every rank's query heads read
the one KV head) and a partitioned sLSTM's replicated w_in (each rank
reads its heads' columns), get their gradient summed over ``model`` (one
packed all-reduce a step); every other replicated leaf (the norms, the
final norm, MLA's down-projections, the router, the sLSTM's w_ff_down)
gets its whole gradient on every rank, from the ``enter`` calls the models
place after it. An RG-LRU layer partitioned on its width computes its W/m
channels: the x and gate branches' columns, the conv and the recurrence on
them, the gates' columns of the whole conv output (one differentiable
all-gather a layer, a reduce-scatter backward) and w_out's rows. An xLSTM
block partitioned on its heads (``"mlstm"``, ``"slstm"``:
``models.xlstm``) computes its H/m heads, its out_norm's mean of squares
summed over ``model`` (an all-reduce each way). With every family
partitioned, only the norms, the router, MLA's down-projections, MQA's KV
head and the sLSTM's w_in and w_ff_down stay replicated.
"""

from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import DATA_AXES, data_place, gather_cat, partitioned_leaves

from .elastic import is_dtensor
from .tree import flatten_with_paths

# torch 2.13 renames the tensor forms of the two collectives (same arguments)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor

# A leaf's placement on the mesh: per mesh dim, the tensor dim split over
# it, or None where the leaf is replicated over it.
Layout = Tuple[Optional[int], ...]


def layout_of(t) -> Layout:
    """A DTensor's placements as a :data:`Layout`."""
    return tuple(p.dim % t.ndim if p.is_shard() else None for p in t.placements)


def _dense_view(x: torch.Tensor) -> Optional[torch.Tensor]:
    """``x`` with its dims in the order of their strides: a contiguous view
    of its memory where its elements are dense (``x`` itself where it is
    contiguous), else None."""
    view = x.permute(sorted(range(x.ndim), key=lambda d: -x.stride(d)))
    return view if view.is_contiguous() else None


def _scatter_sum(x: torch.Tensor, d: int, n: int, group) -> torch.Tensor:
    """``x`` summed over the ``n`` ranks of ``group``, this rank's block of
    it along ``d`` (a reduce-scatter)."""
    src = x.movedim(d, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _reduce_scatter(out, src, group=group)
    return out.movedim(0, d)


def _without(layout: Layout, k: Optional[int]) -> Layout:
    """``layout`` with mesh dim ``k`` replicated (a partitioned leaf's block
    is the whole tensor for the other mesh dims)."""
    return layout if k is None else layout[:k] + (None,) + layout[k + 1:]


class _AllSum(torch.autograd.Function):
    """The sum over the data group on every rank; its transpose sums the
    ranks' gradients."""

    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return dp.sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.dp.sum_(g.clone()), None


class _ToModel(torch.autograd.Function):
    """Megatron's f, before the column products: the identity forward; the
    gradient summed over the model group backward (each rank's heads or
    columns give a part of the input's gradient)."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.sum_(g.clone(memory_format=torch.contiguous_format)), None


class _FromModel(torch.autograd.Function):
    """Megatron's g, after the row products: each rank's partial product
    summed over the model group forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, mp):
        return mp.sum_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumModel(torch.autograd.Function):
    """The sum over the model group forward, and the sum of the ranks'
    gradients backward: a total each rank holds a part of (a norm's sum of
    squares over its channels), read by every rank for its channels only,
    so that each gives a part of the total's gradient."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp = mp
        return mp.sum_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return ctx.mp.sum_(g.clone(memory_format=torch.contiguous_format)), None


class _GatherModel(torch.autograd.Function):
    """The ranks' blocks concatenated along ``dim`` in the model group's
    order (an all-gather) forward; the transpose backward: the gradient
    summed over the model group, this rank's block of it (a
    reduce-scatter). Each rank's columns downstream give a part of every
    block's gradient."""

    @staticmethod
    def forward(ctx, x, mp, dim):
        ctx.mp, ctx.dim = mp, dim
        return mp.gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        # contiguous, as the plain route's gradient is: a reduction or a
        # product downstream then sums in the plain route's order
        return ctx.mp.scatter_sum(g, ctx.dim).contiguous(), None, None


class ModelParallel:
    """Partitioned compute over a mesh's ``model`` axis: the model group,
    its size and this rank's index on it, the families that are
    partitioned (``"attn"``, ``"mla"``, ``"mlp"``, ``"moe"``, ``"rglru"``,
    ``"mlstm"``, ``"slstm"``, ``"vocab"``) and the two functions their code calls around its
    products: :meth:`enter` on a replicated tensor that this rank's columns
    read (the block's input; MLA's normed latents; the MoE's tokens and
    combine weights; the head's normed input) and :meth:`leave` after the
    row product, the combine or the masked lookup. The RG-LRU's gates read
    the whole of a tensor each rank holds a block of: :meth:`gather_blocks`
    (differentiable), as the mLSTM's q, k, v and gates; the xLSTM blocks'
    norms sum their means of squares with :meth:`all_sum`
    (differentiable). The vocabulary-parallel cross-entropy reduces with
    :meth:`max_` and :meth:`sum_`; serving gathers the logits with
    :meth:`gather`. Installed as the
    ``models.shardctx`` rule ``"model_parallel"`` (the train step's, with
    ``count`` the data group's counter, or a serving path's, counting its
    own); without the rule, the models call none of them. Its collectives
    are counted in ``kinds``."""

    def __init__(self, mesh, families, count=None) -> None:
        self.group = mesh.get_group("model")
        self.size = int(mesh.shape[tuple(mesh.mesh_dim_names).index("model")])
        self.index = int(mesh.get_local_rank("model"))
        self.families = frozenset(families)
        self.kinds: Counter = Counter()
        self._count = count if count is not None else self._own

    def _own(self, kind: str) -> None:
        self.kinds[kind] += 1

    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model group, in place (no gradient)."""
        self._count("all_reduce")
        dist.all_reduce(x, group=self.group)
        return x

    def max_(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s maximum over the model group, in place (no gradient);
        counted as an all-reduce."""
        self._count("all_reduce")
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=self.group)
        return x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` (one shape) concatenated along ``dim`` in the
        model group's order (no gradient)."""
        self._count("all_gather")
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=dim)

    def scatter_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` summed over the model group, this rank's block of it along
        ``dim`` (no gradient)."""
        self._count("reduce_scatter")
        return _scatter_sum(x, dim, self.size, self.group)

    def gather_blocks(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in the model group's
        order, differentiable: the backward is a reduce-scatter (the sum of
        the ranks' gradients, this rank's block)."""
        return _GatherModel.apply(x, self, dim)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the model group, differentiable: the backward
        sums the ranks' gradients (an all-reduce each way)."""
        return _SumModel.apply(x, self)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _ToModel.apply(x, self)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return _FromModel.apply(x, self)


class DataParallel:
    """The groups of a mesh for the train step: the data group (its size,
    this rank's index), one group a mesh dim, and the collectives the step
    and the models call, counted in ``calls`` (and by kind in ``kinds``)."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.group, self.size, self.index, self.ranks = data_place(mesh)
        names = tuple(mesh.mesh_dim_names)
        self.data_dims = tuple(k for k, n in enumerate(names) if n in DATA_AXES)
        self.dim_groups = [mesh.get_group(n) for n in names]
        self.dim_sizes = tuple(int(n) for n in mesh.shape)
        self.coord = tuple(mesh.get_coordinate())
        self.model_dim = names.index("model") if "model" in names else None
        me = dist.get_rank()
        for k, g in enumerate(self.dim_groups):
            # a gathered or scattered chunk i belongs to the group's rank i:
            # that must be coordinate i on the mesh dim
            if dist.get_group_rank(g, me) != self.coord[k]:
                raise ValueError(f"the group of mesh dim {names[k]!r} is not in the mesh's order")
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.kinds: Counter = Counter()

    def _count(self, kind: str) -> None:
        self.calls += 1
        self.kinds[kind] += 1

    # -- the data group ---------------------------------------------------
    def sum_(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data group, in place (no gradient). NCCL
        sums contiguous tensors only: a dense ``x`` laid out otherwise (a
        gradient that autograd hands back transposed, as hubert's
        ``conv_pos`` weight's) is summed through a contiguous view of its
        own memory, so it keeps its layout and the sums read from it later
        associate as on the plain step's gradient."""
        self._count("all_reduce")
        view = _dense_view(x)
        if view is None:
            x = view = x.contiguous()
        dist.all_reduce(view, group=self.group)
        return x

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data group, differentiable."""
        return _AllSum.apply(x, self)

    def microbatch_rows(self, batch: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
        """This rank's rows of each of ``n`` global microbatches, in order:
        microbatch i (global rows [i B/n, (i+1) B/n)) split over the ranks.
        A batch of token ids is a few KB, so it is all-gathered over the
        data group and cut; with one microbatch, or one rank, the rank's
        own rows are its part."""
        if n <= 1 or self.size == 1:
            return batch
        out = {}
        for key in sorted(batch):                 # the same order on every rank
            v = batch[key]
            bl = v.shape[0]
            if bl % n:
                raise ValueError(f"{bl} rows a rank do not split into {n} microbatches")
            self._count("all_gather")
            full = gather_cat(v, self.group, self.ranks)
            m, s = full.shape[0] // n, bl // n
            out[key] = torch.cat([full[i * m + self.index * s:i * m + (self.index + 1) * s]
                                  for i in range(n)])
        return {k: out[k] for k in batch}

    # -- one mesh dim at a time ---------------------------------------------
    def _gather_dim(self, x: torch.Tensor, k: int, d: int) -> torch.Tensor:
        """The blocks of mesh dim ``k``'s ranks concatenated along ``d``."""
        self._count("all_gather")
        src = x.movedim(d, 0).contiguous()
        out = src.new_empty((self.dim_sizes[k] * src.shape[0],) + tuple(src.shape[1:]))
        _all_gather(out, src, group=self.dim_groups[k])
        return out.movedim(0, d).contiguous()

    def _scatter_dim(self, x: torch.Tensor, k: int, d: int) -> torch.Tensor:
        """``x`` summed over mesh dim ``k``, this rank's block along ``d``."""
        self._count("reduce_scatter")
        return _scatter_sum(x, d, self.dim_sizes[k], self.dim_groups[k]).contiguous()

    def _slice_dim(self, x: torch.Tensor, k: int, d: int) -> torch.Tensor:
        """This rank's block of ``x`` along ``d`` over mesh dim ``k`` (a view)."""
        return x.chunk(self.dim_sizes[k], dim=d)[self.coord[k]]

    # -- placements -------------------------------------------------------
    def full(self, x: torch.Tensor, layout: Layout) -> torch.Tensor:
        """The whole tensor from this rank's block ``x`` (the inner mesh dims
        first, so that a dim split over several comes back in order)."""
        for k in reversed(range(len(layout))):
            if layout[k] is not None:
                x = self._gather_dim(x, k, layout[k])
        return x

    def local(self, x: torch.Tensor, layout: Layout) -> torch.Tensor:
        """This rank's block of the whole tensor ``x`` (the same on every
        rank): views, the outer mesh dims first."""
        for k, d in enumerate(layout):
            if d is not None:
                x = self._slice_dim(x, k, d)
        return x

    def reduce_grad(self, g: torch.Tensor, layout: Layout) -> torch.Tensor:
        """The mean over the data group of every rank's whole gradient ``g``,
        as this rank's block of ``layout`` (the moments' placement): a
        reduce-scatter over each data dim that splits it, a slice over each
        other dim that does (every rank of a ``model`` row holds the same
        gradient), then an all-reduce over the data dims that do not. A
        leaf split over no data dim is all-reduced in place over the data
        group, in one call."""
        if not any(layout[k] is not None for k in self.data_dims):
            x = self.local(g, layout)
            if x is not g:          # a block of its own: the whole gradient can go
                x = x.clone(memory_format=torch.contiguous_format)
            return self.sum_(x).div_(self.size)
        x = g
        for k, d in enumerate(layout):
            if d is None:
                continue
            if k in self.data_dims:
                x = self._scatter_dim(x, k, d)
            else:
                x = self._slice_dim(x, k, d).contiguous()
        for k in self.data_dims:
            if layout[k] is None:
                self._count("all_reduce")
                dist.all_reduce(x, group=self.dim_groups[k])
        return x.div_(self.size)

    def redistribute(self, x: torch.Tensor, src: Layout, dst: Layout) -> torch.Tensor:
        """This rank's block ``x`` of ``src`` as its block of ``dst``: the
        whole tensor (an all-gather over each mesh dim ``src`` splits),
        then ``dst``'s block of it."""
        return x if src == dst else self.local(self.full(x, src), dst).contiguous()


class Splits:
    """For the optimizer and the compression on the moments' local shards:
    each leaf's mesh dims (those its moments are split on) and its whole
    size, so that a norm, an error sum or a scale is the whole tensor's.
    A per-leaf value is reduced over the dims its leaf is split on; a
    replicated leaf is counted once. One all-reduce a mesh dim a call."""

    def __init__(self, dp: DataParallel, layouts: Sequence[Layout],
                 numels: Sequence[int]) -> None:
        self.dp = dp
        self.dims = [tuple(k for k, d in enumerate(lay) if d is not None) for lay in layouts]
        self.numels = list(numels)

    def _reduce(self, values: List[torch.Tensor], op, which: Optional[List[int]]
                ) -> List[torch.Tensor]:
        dims = self.dims if which is None else [self.dims[i] for i in which]
        out = list(values)
        for k in range(len(self.dp.dim_sizes)):
            idx = [i for i, ds in enumerate(dims) if k in ds]
            if not idx:
                continue
            stacked = torch.stack([out[i] for i in idx])
            self.dp._count("all_reduce")
            dist.all_reduce(stacked, op=op, group=self.dp.dim_groups[k])
            for j, i in enumerate(idx):
                out[i] = stacked[j]
        return out

    def sum(self, values: List[torch.Tensor], which: Optional[List[int]] = None
            ) -> List[torch.Tensor]:
        """Each leaf's local sum (a 0-d tensor) summed over its split dims;
        ``which`` names the leaf of each value (default: one a leaf)."""
        return self._reduce(values, dist.ReduceOp.SUM, which)

    def max(self, values: List[torch.Tensor], which: Optional[List[int]] = None
            ) -> List[torch.Tensor]:
        """Each leaf's local maximum, the maximum over its split dims."""
        return self._reduce(values, dist.ReduceOp.MAX, which)


def state_mesh(state: Any) -> Optional[Any]:
    """The mesh of a state whose every leaf is a DTensor on it (replicated or
    split, leaf by leaf); None for a state of plain tensors. A plain
    tensor in a meshed state, a pending reduction or two meshes raise,
    naming the leaf: nothing is gathered quietly."""
    pairs = flatten_with_paths(state)
    if not any(is_dtensor(t) for _, t in pairs):
        return None
    mesh = None
    for path, t in pairs:
        if not is_dtensor(t):
            raise ValueError(f"{path} is a plain tensor in a state on a mesh")
        if not all(p.is_replicate() or p.is_shard() for p in t.placements):
            raise ValueError(f"{path} is placed {tuple(t.placements)}: a state leaf is "
                             f"replicated or split, not a pending reduction")
        if mesh is None:
            mesh = t.device_mesh
        elif t.device_mesh != mesh:
            raise ValueError(f"{path} is on another mesh than the state's first leaf")
    return mesh


class Placed:
    """The placements of a state on a mesh, leaf by leaf, checked once a
    step: each parameter's own (``params``), its moments' (``moments``, μ's:
    the update runs there; ``nu``, ν's, redistributed into μ's and back
    where they differ) and its compression residual's; which parameters
    are partitioned over ``model`` (``parted``; with ``cfg``, the model's
    config, for the heads), the :class:`ModelParallel` of their families
    (``mp``, None where none is) and the leaves whose gradient each model
    rank holds a part of (``partial``: the q and k norms of partitioned
    attention, MQA's wk and wv, a partitioned sLSTM's w_in). A leaf is
    partitioned only where its moments and residual are split over
    ``model`` as it is (and no data axis splits that dim);
    else its family takes the gathered route, as do the families named in
    ``gathered``."""

    def __init__(self, state: Any, dp: DataParallel, cfg: Any = None,
                 gathered: Tuple[str, ...] = ()) -> None:
        self.dp = dp
        params = flatten_with_paths(state["params"])
        mu = [layout_of(t) for _, t in flatten_with_paths(state["opt"]["mu"])]
        nu = [layout_of(t) for _, t in flatten_with_paths(state["opt"]["nu"])]
        res = flatten_with_paths(state["compress"]) if "compress" in state else None
        self.params = [layout_of(t) for _, t in params]
        self.moments, self.nu = mu, nu
        self.residuals = [layout_of(t) for _, t in res] if res is not None else None
        self.numels = [p.numel() for _, p in params]
        self.splits = Splits(dp, self.moments, self.numels)
        km = dp.model_dim
        self.parted, self.partial, self.mp = [False] * len(params), [], None
        if km is None or cfg is None:
            return
        index = {path: i for i, (path, _) in enumerate(params)}

        def agree(path: str) -> bool:
            i = index[path]
            d = self.params[i][km]
            others = [mu[i], nu[i]] + ([self.residuals[i]] if res is not None else [])
            return all(lay[km] == d and d not in _without(lay, km) for lay in others)

        families, paths = partitioned_leaves(
            cfg, dp.mesh, [(path, tuple(t.shape), t.placements) for path, t in params], agree,
            gathered)
        if not families:
            return
        self.parted = [path in paths for path, _ in params]
        self.mp = ModelParallel(dp.mesh, families, dp._count)
        # the q and k norms of a partitioned attention group, MQA's
        # replicated wk and wv (each rank's query heads read the one KV
        # head) and a partitioned sLSTM's replicated w_in (each rank reads
        # its heads' columns of it)
        groups = {path.rsplit("[", 1)[0] for path in paths}
        self.partial = [i for i, (path, _) in enumerate(params) if path not in paths and (
            path.endswith(("['q_norm']['scale']", "['k_norm']['scale']"))
            and path.rsplit("[", 2)[0] in groups
            or path.endswith(("['attn']['wk']", "['attn']['wv']", "['core']['w_in']"))
            and path.rsplit("[", 1)[0] in groups)]

    def _rel(self, i: int, lay: Layout) -> Layout:
        """Leaf ``i``'s layout within its ``model`` block where it is
        partitioned (its blocks are taken there), else ``lay``."""
        return _without(lay, self.dp.model_dim) if self.parted[i] else lay

    def _move(self, x: torch.Tensor, i: int, src: Layout, dst: Layout) -> torch.Tensor:
        """Leaf ``i``'s block ``x`` of ``src`` as its block of ``dst``."""
        return self.dp.redistribute(x, self._rel(i, src), self._rel(i, dst))

    def compute_params(self, params: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each parameter for the forward and backward: a partitioned one
        its local block, every other one whole (gathered from its block)."""
        return [p if part else self.dp.full(p, lay)
                for p, lay, part in zip(params, self.params, self.parted)]

    def sum_partial(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients of :attr:`partial` summed over the model group: one
        all-reduce of them packed together."""
        if not self.partial:
            return grads
        flat = torch.cat([grads[i].reshape(-1) for i in self.partial])
        self.mp.sum_(flat)
        out, at = list(grads), 0
        for i in self.partial:
            n = grads[i].numel()
            out[i] = flat[at:at + n].view_as(grads[i])
            at += n
        return out

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each gradient (whole, or a partitioned leaf's block) averaged over
        the data group, on its moments' placement. Takes the list's
        gradients out of it as it goes, so that each can be freed once its
        block is made."""
        out = []
        for i, lay in enumerate(self.moments):
            out.append(self.dp.reduce_grad(grads[i], self._rel(i, lay)))
            grads[i] = None
        return out

    def regions(self, full: List[torch.Tensor]) -> List[torch.Tensor]:
        """Each parameter's block on its moments' placement (views), from
        :meth:`compute_params`'s tensors."""
        return [self.dp.local(p, self._rel(i, lay))
                for i, (p, lay) in enumerate(zip(full, self.moments))]

    def to_params(self, regions: List[torch.Tensor]) -> List[torch.Tensor]:
        """The updated blocks back on each parameter's own placement."""
        return [self._move(r, i, lay, own)
                for i, (r, lay, own) in enumerate(zip(regions, self.moments, self.params))]

    def nu_in(self, nu: List[torch.Tensor]) -> List[torch.Tensor]:
        """ν's blocks on μ's placement, for the update."""
        return [self._move(n, i, src, dst)
                for i, (n, src, dst) in enumerate(zip(nu, self.nu, self.moments))]

    def nu_back(self, nu: List[torch.Tensor]) -> List[torch.Tensor]:
        return [self._move(n, i, src, dst)
                for i, (n, src, dst) in enumerate(zip(nu, self.moments, self.nu))]

    def residuals_to_moments(self, res: List[torch.Tensor]) -> List[torch.Tensor]:
        return [self._move(r, i, own, lay)
                for i, (r, own, lay) in enumerate(zip(res, self.residuals, self.moments))]

    def residuals_back(self, res: List[torch.Tensor]) -> List[torch.Tensor]:
        return [self._move(r, i, lay, own)
                for i, (r, lay, own) in enumerate(zip(res, self.moments, self.residuals))]
