"""Data and tensor parallelism over torch.distributed (port of
seal3d_tpu/parallel/mesh.py).

The reference lays one `jax.sharding.Mesh` over its devices and lets XLA
insert the collectives. Here every rank is a process that holds its own
shard, and the collectives are written out:

- a 1-D `data` mesh (`make_mesh`): each rank takes a contiguous slice of
  the global ray batch (`shard_rays`), params and optimizer state are
  replicated (`replicate`), and the gradients are summed over `data`;
- a 2-D `data` x `model` mesh (`make_mesh_2d`, rank = i * n_model + j): the
  batch is sliced over `data`, and the hash-table level stack over `model`
  (HashGridConfig.shard_levels): rank (i, j) holds levels
  [j * L / n_model, (j + 1) * L / n_model) of each grid, encodes its rows at
  those levels and exchanges the features over `model` (`gather_model`).

Every collective goes through `collective`, which logs its op, axis,
element count and payload in `Mesh.log`; `find_batch_collectives` scans
that log as the reference scans a partitioned HLO module. The collectives
are `all_reduce` (sum) and `broadcast` alone: they are the two gloo runs on
CUDA tensors, so two or four gloo ranks can share one card, and NCCL runs
the same code on a host with a card per rank. An all-gather is written as
an all_reduce of a zero-filled buffer, at n times its bytes.

`constrain` and `data_sharding` have no counterpart: a rank's tensors are
its shard already. The ambient mesh (`set_mesh`, read by `current_mesh`)
takes the place of `jax.sharding.set_mesh`: the level-sharded encode reads
it, as the reference's encoder reads the abstract mesh, and so do the MLP
weight casts (ops/mlp.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from seal3d_tpu_torch.train.checkpoint import flatten_tree, map_tree


class Collective(NamedTuple):
    """One logged collective: op ('all_reduce' | 'broadcast'), mesh axis,
    the tensor's shape, element count and bytes, and what it carried."""

    op: str
    axis: str
    shape: tuple
    elems: int
    nbytes: int
    what: str


@dataclass
class Mesh:
    """This rank's view of a data (x model) mesh.

    axis_names: ('data',) or ('data', 'model'); shape: axis -> size;
    coords: axis -> this rank's index along it; ranks: axis -> the global
    ranks of this rank's group along it (index order); groups: axis -> its
    process group; log: the collectives since the last `reset_log`."""

    axis_names: tuple
    shape: dict
    coords: dict
    ranks: dict
    groups: dict
    log: list = field(default_factory=list)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def reset_log(self):
        self.log = []


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized torch.distributed "
                           "process group (parallel.launch starts ranks)")
    return dist.get_world_size()


def make_mesh(world: Optional[int] = None) -> Mesh:
    """1-D data-parallel mesh over all ranks of the process group (`world`,
    if given, must equal its size)."""
    n = _world()
    if world is not None and world != n:
        raise ValueError(f"make_mesh({world}): the process group has {n} "
                         f"ranks")
    rank = dist.get_rank()
    return Mesh(axis_names=("data",), shape={"data": n},
                coords={"data": rank}, ranks={"data": list(range(n))},
                groups={"data": dist.group.WORLD})


def make_mesh_2d(n_data: int, n_model: int) -> Mesh:
    """2-D (data x model) mesh: rank = i * n_model + j holds data index i and
    model index j (`model` is the minor axis, as in the reference). Every
    rank creates every group, in the same order."""
    n = _world()
    if n_data * n_model != n:
        raise ValueError(f"make_mesh_2d({n_data}, {n_model}): the process "
                         f"group has {n} ranks")
    rank = dist.get_rank()
    i, j = divmod(rank, n_model)
    groups, ranks = {}, {}
    for jj in range(n_model):               # one data group per column
        members = [ii * n_model + jj for ii in range(n_data)]
        g = dist.new_group(members)
        if jj == j:
            groups["data"], ranks["data"] = g, members
    for ii in range(n_data):                # one model group per row
        members = [ii * n_model + jj for jj in range(n_model)]
        g = dist.new_group(members)
        if ii == i:
            groups["model"], ranks["model"] = g, members
    return Mesh(axis_names=("data", "model"),
                shape={"data": n_data, "model": n_model},
                coords={"data": i, "model": j}, ranks=ranks, groups=groups)


_AMBIENT: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]):
    """Make `mesh` (or None) the ambient mesh of this process; a Trainer
    sets its own where its steps, grid updates and renders start."""
    global _AMBIENT
    _AMBIENT = mesh


def current_mesh() -> Optional[Mesh]:
    return _AMBIENT


def collective(op: str, x: torch.Tensor, mesh: Mesh, axis: str,
               what: str) -> torch.Tensor:
    """`op` over the mesh axis, in place on x (returned): 'all_reduce' sums
    it over the axis' group, 'broadcast' copies the group's first rank's x
    to every rank. Logs the call in mesh.log."""
    if op not in ("all_reduce", "broadcast"):
        raise ValueError(f"unknown collective {op!r}")
    mesh.log.append(Collective(op, axis, tuple(x.shape), x.numel(),
                               x.numel() * x.element_size(), what))
    group = mesh.groups[axis]
    if op == "all_reduce":
        dist.all_reduce(x, group=group)
    else:
        dist.broadcast(x, src=mesh.ranks[axis][0], group=group)
    return x


def shard_rays(tree: Any, mesh: Optional[Mesh]):
    """This rank's contiguous slice along the leading (ray) axis of every
    tensor in `tree` (a tensor, None, or a dict / list of them); the tree
    unchanged without a mesh."""
    if mesh is None or tree is None:
        return tree
    n, i = mesh.size("data"), mesh.index("data")

    def part(_, t):
        if t.shape[0] % n:
            raise ValueError(f"shard_rays: batch {t.shape[0]} must divide "
                             f"the mesh 'data' axis (size {n})")
        rows = t.shape[0] // n
        return t[i * rows:(i + 1) * rows]

    return map_tree(tree, part)


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str,
                what: str) -> torch.Tensor:
    """The [n * rows, ...] tensor from the [rows, ...] slices of the n
    ranks along `axis`, in their index order (an all-gather written as an
    all_reduce of a zero-filled buffer)."""
    n, i, rows = mesh.size(axis), mesh.index(axis), x.shape[0]
    full = x.new_zeros((n * rows, *x.shape[1:]))
    full[i * rows:(i + 1) * rows] = x
    return collective("all_reduce", full, mesh, axis, what)


def replicate(tree: Any, mesh: Mesh, sharded=lambda path: False):
    """`tree` with every leaf broadcast from the first rank of the mesh,
    so that all ranks start from the same numbers; leaves where
    sharded(path) is true (a model rank's level shard) are broadcast over
    `data` alone. One broadcast per axis for each kind and dtype of leaf."""
    src = dict(flatten_tree(tree))
    kinds = {}
    for k, t in src.items():
        kinds.setdefault((bool(sharded(k)), t.dtype), []).append(k)
    out = {}
    for (shard, _), keys in kinds.items():
        buf = torch.cat([src[k].reshape(-1) for k in keys])
        axes = ["data"] if shard else [a for a in ("model", "data")
                                       if a in mesh.axis_names]
        for axis in axes:
            collective("broadcast", buf, mesh, axis, "replicate")
        for k, part in zip(keys, buf.split([src[k].numel() for k in keys])):
            out[k] = part.reshape(src[k].shape)
    return map_tree(tree, lambda k, _: out[k])


class _GatherModel(torch.autograd.Function):
    """Columns [begin, begin + n) of an [M, total, F] tensor from each model
    rank's [M, n, F] slice: forward writes this rank's columns into a zero
    slab and sums it over `model`; backward takes this rank's columns of the
    cotangent and sums nothing, since every model rank runs the same
    computation on the same rows after the exchange."""

    @staticmethod
    def forward(ctx, local, mesh, begin, total):
        ctx.cols = (begin, begin + local.shape[1])
        slab = local.new_zeros((local.shape[0], total, *local.shape[2:]))
        slab[:, begin:begin + local.shape[1]] = local
        return collective("all_reduce", slab, mesh, "model", "features")

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.cols
        return g[:, a:b], None, None, None


def gather_model(local: torch.Tensor, mesh: Mesh, begin: int,
                 total: int) -> torch.Tensor:
    """[M, total, F] features from this model rank's levels
    [begin, begin + n) ([M, n, F]); differentiable in `local`."""
    return _GatherModel.apply(local, mesh, begin, total)


def find_batch_collectives(log, min_elems: int) -> list:
    """The DP scaling guard: logged collectives of >= min_elems elements,
    other than the gradient sum ('grads'), whose size is the parameter
    count and not the batch's. A train step of a data mesh must have none:
    a collective at candidate scale (the reference's all-gathered [N, C]
    packing sort) means the ranks compute on the whole batch, and n ranks
    train at one rank's speed."""
    return [c for c in log if c.elems >= min_elems and c.what != "grads"]


def find_table_collectives(log, table_rows: int, n_model: int) -> list:
    """Logged `model`-axis collectives of a table's or a level shard's
    shape ([table_rows, F] or [table_rows / n_model, F], any F): the
    level-sharded encode must exchange features ([M, L, F]) over `model`,
    never the table."""
    rows = {table_rows, table_rows // n_model}
    return [c for c in log if c.axis == "model" and len(c.shape) == 2
            and c.shape[0] in rows]
