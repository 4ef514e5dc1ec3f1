"""Device meshes over ``torch.distributed``, and :class:`Sharding`, the
placement of one tensor on a mesh (the reference's ``NamedSharding``).

The production shapes are a single pod of (data=16, model=16) and two
pods of (pod=2, data=16, model=16), 512 devices. The meshes are built by
functions, so importing this module initialises no process group and no
CUDA context: a caller first starts the default process group (its
store, world size and rank), then builds the mesh over its ranks.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

DATA_AXES = ("pod", "data")


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *, device: DeviceLike = None):
    """Any mesh (small-mesh tests, elastic re-meshing) over the ranks of
    the default process group, whose size must be the product of
    ``shape``. ``device`` None means the card (NCCL); ``"cpu"`` builds a
    CPU mesh (gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def data_axes(mesh) -> Tuple[str, ...]:
    """Axes carrying the batch dimension: ('pod', 'data') when multi-pod."""
    return tuple(a for a in mesh.mesh_dim_names if a in DATA_AXES)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.mesh_dim_names else None


def axis_size(mesh, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    out = 1
    for n in names:
        out *= mesh.shape[mesh.mesh_dim_names.index(n)]
    return out


@dataclass(frozen=True)
class Place:
    """This rank's place on a mesh of data axes and a ``model`` axis, for
    the launch programs that take global tensors on every rank: ``mi`` of
    ``msz`` on the model axis, ``di`` of ``dsz`` on the data axes taken
    together (the first axis major, as a ``PartitionSpec`` orders them),
    the process groups along each, and ``ranks[di][mi]``, the global rank
    at each place."""

    msz: int
    dsz: int
    mi: int
    di: int
    has_data: bool
    model_group: object
    data_group: object
    ranks: Tuple[Tuple[int, ...], ...]


def place(mesh) -> Optional[Place]:
    """This rank's :class:`Place` on ``mesh``; None when it has no
    ``model`` axis. Every rank of the mesh calls it (it may create a
    process group over several data axes, which is collective)."""
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names:
        return None
    other = [a for a in names if a != "model" and a not in DATA_AXES]
    if other:
        raise ValueError(f"mesh axes {other} are neither data axes {DATA_AXES} nor 'model'")
    dp = data_axes(mesh)
    msz, dsz = axis_size(mesh, "model"), axis_size(mesh, dp)
    order = [names.index(a) for a in dp] + [names.index("model")]
    grid = mesh.mesh.permute(order).reshape(dsz, msz)
    coord = dict(zip(names, mesh.get_coordinate()))
    di = 0
    for a in dp:
        di = di * axis_size(mesh, a) + coord[a]
    mi = coord["model"]
    if len(dp) == 1:
        data_group = mesh.get_group(dp[0])
    elif dp:
        data_group = None
        for m in range(msz):                      # every rank creates every group
            g = dist.new_group(grid[:, m].tolist())
            if m == mi:
                data_group = g
    else:
        data_group = None
    model_group = mesh.get_group("model")
    # an all-to-all sends its i-th chunk to the group's rank i: that must
    # be model coordinate i
    if [dist.get_group_rank(model_group, r) for r in grid[di].tolist()] != list(range(msz)):
        raise ValueError("the model group's ranks are not in the mesh's order")
    return Place(msz=msz, dsz=dsz, mi=mi, di=di, has_data=bool(dp),
                 model_group=model_group, data_group=data_group,
                 ranks=tuple(tuple(int(r) for r in row) for row in grid.tolist()))


def data_place(mesh) -> Tuple[Optional[object], int, int, Tuple[int, ...]]:
    """For a data-parallel program on ``mesh``: the process group over its
    data axes taken together, its size ``dsz``, this rank's index ``di``
    on it (the first axis major) and the global ranks in that order. A
    ``model`` axis may have any size: the data group is this rank's
    column of the mesh, and the ranks of one ``model`` row hold the same
    batch rows (the reference's batch on ``P("data")``); a mesh of
    ``model`` alone has a data group of one rank each, every rank holding
    the whole batch (the reference's batch replicated). Any other axis
    raises. Every rank of the mesh calls it (it may create a group:
    collective)."""
    names = tuple(mesh.mesh_dim_names)
    if not data_axes(mesh):
        if names != ("model",):
            raise ValueError(f"mesh axes {names} hold no data axis {DATA_AXES}")
        me, group = dist.get_rank(), None
        for r in mesh.mesh.flatten().tolist():      # every rank creates every group
            g = dist.new_group([int(r)])
            if int(r) == me:
                group = g
        return group, 1, 0, (me,)
    if model_axis(mesh) is not None:
        pl = place(mesh)
        return pl.data_group, pl.dsz, pl.di, tuple(row[pl.mi] for row in pl.ranks)
    other = [a for a in names if a not in DATA_AXES]
    if other:
        raise ValueError(f"mesh axes {other} are not data axes {DATA_AXES}")
    ranks = tuple(int(r) for r in mesh.mesh.flatten().tolist())
    coord = dict(zip(names, mesh.get_coordinate()))
    di = 0
    for a in names:
        di = di * axis_size(mesh, a) + coord[a]
    group = mesh.get_group(names[0]) if len(names) == 1 else dist.new_group(list(ranks))
    return group, len(ranks), di, ranks


def local_block(shape: Tuple[int, ...], mesh, placements) -> Tuple[Tuple[int, ...],
                                                                   Tuple[int, ...]]:
    """Where this rank's local block of a tensor of global ``shape``, placed
    by the DTensor ``placements`` on ``mesh``, starts in each dim, and its
    shape. A dim split over several mesh dims is split by the first one
    first (the major one), as DTensor and a ``PartitionSpec`` of a tuple
    split it."""
    coord = mesh.get_coordinate()
    local, off = list(shape), [0] * len(shape)
    for k, pl in enumerate(placements):
        if pl.is_shard():
            local[pl.dim] //= mesh.shape[k]
            off[pl.dim] += coord[k] * local[pl.dim]
    return tuple(off), tuple(local)


def gather_cat(x: torch.Tensor, group, ranks, dim: int = 0) -> torch.Tensor:
    """The tensors ``x`` (all of one shape) of the group's members,
    concatenated along ``dim`` in the order of the global ``ranks``."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat([parts[dist.get_group_rank(group, r)] for r in ranks], dim=dim)


@dataclass(frozen=True)
class Sharding:
    """A tensor's placement on ``mesh``, as ``NamedSharding(mesh,
    PartitionSpec(*spec))`` places it: ``spec`` gives each tensor dim a
    mesh axis name, a tuple of names (the first the major one) or None.
    An empty spec replicates a tensor of any rank; any other spec has one
    entry per tensor dim. A sharded dim must divide evenly, as the
    reference requires. It becomes DTensor ``Shard(d)`` and ``Replicate()``
    placements, one per mesh dim."""

    mesh: Any
    spec: Tuple[Any, ...] = ()

    def placements(self, shape: Tuple[int, ...], what: str = "") -> tuple:
        """The DTensor placements of a tensor of ``shape``; raises, naming
        ``what``, where the spec does not fit it or the mesh."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.mesh_dim_names)
        where = f" for {what}" if what else ""
        if self.spec and len(self.spec) != len(shape):
            raise ValueError(f"spec {self.spec}{where} has {len(self.spec)} entries, the tensor "
                             f"{len(shape)} dims {tuple(shape)}")
        out = [Replicate() for _ in names]
        for d, entry in enumerate(self.spec):
            axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
            for a in axes:
                if a not in names:
                    raise ValueError(f"spec {self.spec}{where} names axis {a!r}; the mesh has "
                                     f"{names}")
                if not isinstance(out[names.index(a)], Replicate):
                    raise ValueError(f"spec {self.spec}{where} uses axis {a!r} twice")
                out[names.index(a)] = Shard(d)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                # DTensor splits a dim over its mesh dims in mesh order
                raise ValueError(f"spec {self.spec}{where}: axes {axes} of dim {d} are not in "
                                 f"the mesh's order {names}")
            if shape[d] % axis_size(self.mesh, axes or None):
                raise ValueError(f"spec {self.spec}{where}: dim {d} of {tuple(shape)} does not "
                                 f"divide over {axes}")
        return tuple(out)

    def distribute(self, t: torch.Tensor, what: str = ""):
        """``t`` (the same on every rank) as a DTensor placed by this
        sharding; collective (every rank calls it)."""
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t, self.mesh, self.placements(tuple(t.shape), what))


# -- partitioned compute over "model" (Megatron's column/row split) ----------

# The products a placement can partition, by the dict that holds their
# leaves: a column leaf split over "model" on its output (last) dim, a row
# leaf on its input dim (the one before it). "attn" holds GQA's (wq, wk,
# wv; wo) or MLA's (wq_b, w_uk, w_uv, head-major in their columns; wo);
# "ffn" a dense MLP's (w_gate, w_up; w_down) or an MoE layer's routed
# experts, (E, d, f) and (E, f, d) after the tiles' dim, which may also be
# split on E (the "expert" role); "shared" an MoE layer's shared experts,
# a dense MLP; "core" an RG-LRU layer's (wx, wgate, and the gates' dense
# (W, W) w_input_gate, w_rec_gate; w_out), an mLSTM block's (w_up,
# w_gate_up, wq, wk, wv, and the gates' (2d, H) w_igate, w_fgate; w_down)
# or an sLSTM block's (w_ff_up (d, 2ff) on its rows), whose per-channel
# leaves (:data:`WIDTH`: log_lambda, the depthwise conv's w (K, W) and b
# (W) in its nested ``conv`` dict, the xLSTM's ``out_norm`` scale) split on
# their last dim too (the "width" role), and the sLSTM's block-diagonal
# recurrent weights (:data:`HEAD`, (H, dh, dh)) on H (the "head" role).
# Beside them, the vocabulary leaves at the top of the tree (the "vocab"
# role): ``embed`` (V, d) split on its rows, ``lm_head`` (d, V) on its
# columns, each rank V/m of the vocabulary.
COLUMN = {"attn": ("wq", "wk", "wv", "wq_b", "w_uk", "w_uv"), "ffn": ("w_gate", "w_up"),
          "shared": ("w_gate", "w_up"),
          "core": ("wx", "wgate", "w_input_gate", "w_rec_gate", "w_up", "w_gate_up", "wq", "wk",
                   "wv", "w_igate", "w_fgate")}
ROW = {"attn": ("wo",), "ffn": ("w_down",), "shared": ("w_down",),
       "core": ("w_out", "w_down", "w_ff_up")}
# a core leaf's name in its group
WIDTH = ("log_lambda", "conv.w", "conv.b", "out_norm.scale")
HEAD = ("r_i", "r_f", "r_z", "r_o")
NESTED = ("conv", "out_norm")                 # the dicts a core holds its nested leaves in
EXPERTS = ("w_gate", "w_up", "w_down")
VOCAB = {"embed": 0, "lm_head": 1}            # the leaf and its vocabulary dim
# the keys a train state puts before a parameter's own path
STATE_KEYS = ("params", "opt", "mu", "nu", "compress")
_KEY = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def path_keys(path: str) -> list:
    """The keys of a ``flatten_with_paths`` path, e.g. ``['blocks']['g0']``
    -> ``['blocks', 'g0']`` (list indices as ints)."""
    return [k if i == "" else int(i) for k, i in _KEY.findall(path)]


def _vocab_leaf(keys: list) -> bool:
    """Whether ``keys`` name a top-level :data:`VOCAB` leaf (after a
    state's own keys, if any)."""
    return bool(keys) and keys[-1] in VOCAB and all(k in STATE_KEYS for k in keys[:-1])


def _group_of(path: str, keys: list) -> Optional[Tuple[str, str, str]]:
    """The group of the leaf at ``path`` (``keys``): the path of the dict
    of :data:`COLUMN` that holds it, that dict's key and the leaf's name in
    the group (a ``conv`` or ``out_norm`` leaf of a ``core`` dict as
    ``"conv.w"``, ``"out_norm.scale"``); None for a leaf of no such dict."""
    if len(keys) >= 3 and keys[-3] == "core" and keys[-2] in NESTED:
        return path[:path.rindex(f"['{keys[-2]}']")], "core", f"{keys[-2]}.{keys[-1]}"
    if len(keys) >= 2 and keys[-2] in COLUMN:
        return path[:path.rindex("[")], keys[-2], keys[-1]
    return None


def partition_role(path: str, shape: Tuple[int, ...], placements, mesh) -> Optional[str]:
    """``"column"``, ``"row"``, ``"expert"``, ``"width"``, ``"head"`` or
    ``"vocab"`` where the parameter at ``path`` (a ``flatten_with_paths``
    path, with or without a state's prefix: ``['params']``, the moments,
    the residuals), of global ``shape`` and placed on ``mesh`` by the
    DTensor ``placements``, is a :data:`COLUMN` leaf split over ``"model"``
    on its last dim, a :data:`ROW` leaf split on its dim before the last,
    an MoE layer's routed expert (``(E, d, f)`` after the tiles' dim) split
    on E, a recurrent block's per-channel leaf (:data:`WIDTH`) split on its
    last dim, an sLSTM's recurrent weight (:data:`HEAD`, ``(H, dh, dh)``
    after the tiles' dim) split on H, or the top-level ``embed`` (V, d)
    split on its rows or ``lm_head`` (d, V) on its columns
    (:data:`VOCAB`); split evenly, and replicated over every other mesh
    dim; else None. A ``model`` axis of size 1 counts: the layout is named
    by the placement alone."""
    names = tuple(mesh.mesh_dim_names)
    keys = path_keys(path)
    vocab = _vocab_leaf(keys)
    group = None if vocab else _group_of(path, keys)
    if "model" not in names or not vocab and group is None:
        return None
    kind, leaf = (None, keys[-1]) if vocab else group[1:]
    lead = 1 if "blocks" in keys else 0           # the tiles' stacking dim
    nd = len(shape)
    experts = kind == "ffn" and leaf in EXPERTS and nd == lead + 3
    width = kind == "core" and leaf in WIDTH and nd in (lead + 1, lead + 2)
    head = kind == "core" and leaf in HEAD and nd == lead + 3
    if nd != lead + 2 and not (experts or width or head):
        return None
    km = names.index("model")
    if any(not p.is_replicate() for k, p in enumerate(placements) if k != km):
        return None
    p = placements[km]
    if not p.is_shard() or shape[p.dim % nd] % int(mesh.shape[km]):
        return None
    dim = p.dim % nd
    if vocab:
        return "vocab" if dim == VOCAB[leaf] else None
    if experts and dim == lead:
        return "expert"
    if width:
        return "width" if dim == nd - 1 else None
    if head:
        return "head" if dim == lead else None
    if leaf in COLUMN[kind] and dim == nd - 1:
        return "column"
    if leaf in ROW[kind] and dim == nd - 2:
        return "row"
    return None


def _replicated(placements) -> bool:
    return all(p.is_replicate() for p in placements)


def _family(got: dict, kind: str) -> Optional[str]:
    """The family of a group of leaves ``got`` held by a dict ``kind`` of
    :data:`COLUMN`: "attn" (GQA), "mla", "mlp" (a dense MLP), "moe" (an MoE
    layer's routed experts with their router, or its shared experts),
    "rglru", "mlstm" or "slstm" (a ``core`` with w_rec_gate, w_igate or
    r_i); None for an ``attn`` dict of neither attention and for a ``core``
    of none of the three."""
    if kind == "attn":
        return "mla" if "w_uk" in got else "attn" if "wk" in got else None
    if kind == "core":
        for fam, leaf in (("rglru", "w_rec_gate"), ("mlstm", "w_igate"), ("slstm", "r_i")):
            if leaf in got:
                return fam
        return None
    if kind == "shared":
        return "moe"
    return "moe" if "router" in got else "mlp"


# the roles a whole group takes: for each family, the choices of
# {leaf: role}; every other leaf of the group replicated. Attention's
# second choice is MQA's: the query heads split, the one KV head (wk, wv
# and a k_norm) replicated on every rank. The sLSTM's w_in and w_ff_down
# stay replicated: w_in's columns are gate-major and w_ff_up's are two GLU
# halves, so no contiguous column block of either is a rank's heads'
# gates or whole GLU pairs
ROLES = {
    "attn": ({"wq": "column", "wk": "column", "wv": "column", "wo": "row"},
             {"wq": "column", "wo": "row"}),
    "mla": ({"wq_b": "column", "w_uk": "column", "w_uv": "column", "wo": "row"},),
    "mlp": ({"w_gate": "column", "w_up": "column", "w_down": "row"},),
    "experts": ({"w_gate": "expert", "w_up": "expert", "w_down": "expert"},
                {"w_gate": "column", "w_up": "column", "w_down": "row"}),
    "rglru": ({"wx": "column", "wgate": "column", "w_input_gate": "column",
               "w_rec_gate": "column", "w_out": "row", "log_lambda": "width",
               "conv.w": "width", "conv.b": "width"},),
    "mlstm": ({"w_up": "column", "w_gate_up": "column", "wq": "column", "wk": "column",
               "wv": "column", "w_igate": "column", "w_fgate": "column", "w_down": "row",
               "conv.w": "width", "conv.b": "width", "out_norm.scale": "width"},),
    "slstm": ({"r_i": "head", "r_f": "head", "r_z": "head", "r_o": "head",
               "out_norm.scale": "width", "w_ff_up": "row"},),
}


def partitioned_leaves(cfg, mesh, items, agree=None, gathered=()) -> Tuple[frozenset, frozenset]:
    """The families a model's parameter placements partition, and the paths
    of their split leaves. ``items`` are (path, global shape, DTensor placements)
    of every parameter; ``agree(path)``, where given, must also hold for a
    leaf (the train step's: its moments are split over "model" as it is);
    the families named in ``gathered`` are never partitioned (the MoE
    under the launcher's expert-parallel override, which takes global
    weights).

    A group is one dict of :data:`COLUMN` and :data:`ROW` leaves: GQA's or
    MLA's ``attn``, a dense MLP's ``ffn`` (w_gate, w_up, w_down; or w_up,
    w_down), an MoE layer's ``ffn`` (its routed experts and router) or its
    ``shared`` experts, an RG-LRU, mLSTM or sLSTM block's ``core`` (with
    its ``conv`` and ``out_norm``). A family ("attn", "mla", "mlp", "moe",
    "rglru", "mlstm", "slstm") is partitioned when the
    model has one of its groups at least and every group of it is whole in
    its roles (:data:`ROLES`, each leaf's by :func:`partition_role`; every
    other leaf of the group, the norms, MLA's down-projections and the
    router, replicated), and the ``model`` axis divides the heads or the
    width: GQA's ``cfg.n_heads`` and ``cfg.n_kv_heads`` (the heads are
    contiguous in the columns: rank r holds q heads [r H/m, (r+1) H/m) and
    exactly their KV heads), or for MQA (``cfg.n_kv_heads`` 1, wk and wv
    replicated: attention's second choice) ``cfg.n_heads`` alone, every
    rank reading the one KV head; MLA's ``cfg.n_heads``; the RG-LRU's
    ``cfg.lru_width`` (rank r holds the channels [r W/m, (r+1) W/m) of every
    product's output, of the conv and of the recurrence); the xLSTM
    blocks' ``cfg.n_heads`` (rank r holds heads [r H/m, (r+1) H/m): the
    mLSTM's columns of them in every product, and its channels of the conv
    and the norm; the sLSTM's recurrent weights, norm channels and
    w_ff_up's rows of them, with w_in and w_ff_down replicated; a
    placement that splits w_in or w_ff_up on its columns is not the
    family). A KV wider than
    one head with replicated wk and wv is not MQA: its heads would pair
    with the wrong query heads, so it stays gathered. An MoE layer's
    experts are split on E (rank r holds experts [r E/m, (r+1) E/m)) or on
    their f columns; its shared experts as a dense MLP. "vocab" is
    partitioned when every vocabulary leaf the model has (a tied model's
    ``embed``, an untied one's ``embed`` and ``lm_head``, an audio model's
    ``lm_head``) is in the "vocab" role: rank r holds the vocabulary [r
    V/m, (r+1) V/m). One of the two split and the other not, or ``embed``
    split on d, is not the family. Every other leaf, and every leaf of a
    family that is not partitioned, takes the gathered route."""
    groups: dict = {}
    for path, shape, placements in items:
        group = _group_of(path, path_keys(path))
        if group is None:
            continue
        g = groups.setdefault(group[0], {"kind": group[1], "leaves": {}})
        role = partition_role(path, shape, placements, mesh)
        if agree is not None and role is not None and not agree(path):
            role = None
        g["leaves"][group[2]] = (path, role, _replicated(placements))
    m = axis_size(mesh, "model") if "model" in mesh.mesh_dim_names else 0
    fam_groups: dict = {}
    for g in groups.values():
        fam = _family(g["leaves"], g["kind"])
        if fam is not None:
            fam_groups.setdefault(fam, []).append(g)
    families, paths = set(), set()
    vocab = {}
    for path, shape, placements in items:
        if _vocab_leaf(path_keys(path)):
            role = partition_role(path, shape, placements, mesh)
            vocab[path] = role == "vocab" and (agree is None or agree(path))
    if m and "vocab" not in gathered and vocab and all(vocab.values()):
        families.add("vocab")
        paths.update(vocab)
    for fam, gs in fam_groups.items():
        if not m or fam in gathered:
            continue
        choices = ROLES["experts" if fam == "moe" else fam]
        if fam == "attn":
            # GQA's split of the KV heads where "model" divides them; MQA's
            # replicated KV head where there is one
            choices = [c for c, ok in zip(choices, (cfg.n_kv_heads % m == 0,
                                                    cfg.n_kv_heads == 1)) if ok]
            if cfg.n_heads % m:
                continue
        if fam == "mla" and cfg.n_heads % m:
            continue
        if fam == "rglru" and cfg.lru_width % m:
            continue
        if fam in ("mlstm", "slstm") and cfg.n_heads % m:
            continue
        if all(_group_ok(g, fam, choices) for g in gs):
            families.add(fam)
            paths.update(p for g in gs for p, role, _ in g["leaves"].values() if role)
    return frozenset(families), frozenset(paths)


def _group_ok(g, fam: str, choices) -> bool:
    """The group whole in one of ``choices`` (the GELU MLP has no w_gate),
    each leaf in its role, every other leaf replicated."""
    got = g["leaves"]
    if fam == "moe" and g["kind"] != "ffn":       # the shared experts: a dense MLP
        choices = ROLES["mlp"]
    for want in choices:
        need = set(want) - ({"w_gate"} if fam == "mlp" else set())
        if need <= set(got) and all(role == want[n] if n in want else rep
                                    for n, (_, role, rep) in got.items()):
            return True
    return False
