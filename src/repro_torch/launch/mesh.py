"""Device meshes over ``torch.distributed``, and :class:`Sharding`, the
placement of one tensor on a mesh (the reference's ``NamedSharding``).

The production shapes are a single pod of (data=16, model=16) and two
pods of (pod=2, data=16, model=16), 512 devices. The meshes are built by
functions, so importing this module initialises no process group and no
CUDA context: a caller first starts the default process group (its
store, world size and rank), then builds the mesh over its ranks.
"""

from __future__ import annotations

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
    ``model`` axis is allowed at size 1 only; any other axis raises. Every
    rank of the mesh calls it (it may create a group: collective)."""
    names = tuple(mesh.mesh_dim_names)
    if not data_axes(mesh):
        raise ValueError(f"mesh axes {names} hold no data axis {DATA_AXES}")
    if model_axis(mesh) is not None:
        pl = place(mesh)
        if pl.msz != 1:
            raise ValueError(f"a data-parallel program needs a model axis of 1, not {pl.msz}")
        return pl.data_group, pl.dsz, pl.di, tuple(row[0] for row in pl.ranks)
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
