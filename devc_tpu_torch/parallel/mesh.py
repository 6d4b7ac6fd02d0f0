"""Process groups as a ("data", "model") mesh (mirrors
devc_tpu/parallel/mesh.py).

devc_tpu lays its devices out as a jax.sharding.Mesh and lets XLA insert
the collectives. The port runs one process per rank (`torchrun`, or
`parallel/launch.py::spawn_ranks`) and does the same with
`torch.distributed` process groups, written out:

  * "data": the batch of frames, clips or training samples is split
    over it; gradients are averaged over it (train/loop.py);
  * "model": the N x N correspondence is split over it, by query rows
    or by keys (parallel/sharded_corr.py).

Rank r sits at (r // n_model, r % n_model). Every rank holds its own copy
of the parameters (`shard_params` makes them equal) and its block of each
batch (`shard_batch`); a "spec" is a tuple with one entry per axis of an
array, an axis name or None, as jax's PartitionSpec.

Backends (`init_distributed`): NCCL when each rank has a card of its
own, gloo when ranks share a card or run on the CPU. Gloo runs every
collective used here (all_reduce SUM and MAX, broadcast, all_gather) on
CUDA tensors itself (checked on an H100 with two ranks on one card,
fp32 and uint8), so the helpers never copy to the host. Every group gets
an explicit timeout, so that a collective some rank never reaches raises
instead of hanging. The collective helpers below take `group=None` to
mean "one process, no collective" (a mesh made without a process group).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

AXES = ("data", "model")
# how long a rank waits at a collective before it raises
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


@dataclasses.dataclass(frozen=True)
class DistContext:
    """What `init_distributed` set up for this process."""
    rank: int
    world: int
    device: torch.device
    backend: str | None  # None: one process, no process group


def init_distributed(device="cuda", timeout=COLLECTIVE_TIMEOUT,
                     init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None) -> DistContext:
    """Join the default process group of this run, and pick this rank's
    device.

    rank / world_size default to torchrun's RANK / WORLD_SIZE (a single
    process when unset: no process group), init_method to "env://"
    (MASTER_ADDR / MASTER_PORT). On "cuda" rank r takes card
    LOCAL_RANK % device_count and the backend is NCCL when the local ranks
    have a card each, gloo when they share one; on "cpu" it is gloo. A
    CUDA device without a GPU raises."""
    from devc_tpu_torch.utils.convert import checked_device

    device = checked_device(device)
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
             else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if device.type == "cuda":
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return DistContext(dist.get_rank(), dist.get_world_size(), device,
                           dist.get_backend())
    if world == 1 and init_method is None:
        return DistContext(0, 1, device, None)
    backend = ("nccl" if device.type == "cuda"
               and local_world <= torch.cuda.device_count() else "gloo")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, timeout=timeout)
    print(f"rank {rank} of {world}: backend {backend}, device {device}",
          flush=True)
    return DistContext(rank, world, device, backend)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (n_data, n_model) grid of ranks and its process groups.

    coords: this rank's (data, model) index, None for a rank outside the
    mesh. groups: {"data", "model", "mesh"} -> ProcessGroup ("mesh": all
    its ranks); None each when the mesh has no process group (one
    process)."""
    shape: tuple
    coords: tuple | None
    groups: dict
    axis_names: tuple = AXES

    def size(self, axis: str) -> int:
        return self.shape[AXES.index(axis)]

    def index(self, axis: str) -> int:
        return self.coords[AXES.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def member(self) -> bool:
        return self.coords is not None


def make_mesh(n_data: int | None = None, n_model: int = 1,
              timeout=COLLECTIVE_TIMEOUT) -> Mesh:
    """A ("data", "model") mesh over the ranks of the default process
    group (one rank when there is none). n_data defaults to world //
    n_model; ranks past n_data * n_model are left out, as devc_tpu leaves
    devices out. Every rank must call this, with the same arguments."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs that many "
                         f"ranks; there are {world}")
    size = n_data * n_model
    coords = (rank // n_model, rank % n_model) if rank < size else None
    if not dist.is_initialized():
        return Mesh((n_data, n_model), coords,
                    {"data": None, "model": None, "mesh": None})
    # every rank creates every group, in the same order
    groups = {"mesh": dist.new_group(list(range(size)), timeout=timeout)}
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)],
                           timeout=timeout)
        if coords is not None and coords[0] == d:
            groups["model"] = g
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)],
                           timeout=timeout)
        if coords is not None and coords[1] == m:
            groups["data"] = g
    if coords is None:
        groups = {"data": None, "model": None, "mesh": None}
    return Mesh((n_data, n_model), coords, groups)


def data_sharding(mesh: Mesh, ndim: int, batch_axis: int = 0) -> tuple:
    """The spec that splits one axis over "data" and keeps the rest."""
    spec = [None] * ndim
    spec[batch_axis] = "data"
    return tuple(spec)


def replicated(mesh: Mesh) -> tuple:
    """The spec of an array every rank holds whole."""
    return ()


def shard(mesh: Mesh, x, spec: tuple):
    """This rank's block of x (a tensor or numpy array) under spec: each
    axis named in spec cut into the axis's size, the block at this rank's
    index. An axis must divide by its mesh axis."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.size(axis), mesh.index(axis)
        if x.shape[dim] % n:
            raise ValueError(f"axis {dim} of size {x.shape[dim]} does not "
                             f"divide over {n} {axis!r} ranks")
        step = x.shape[dim] // n
        index = [slice(None)] * x.ndim
        index[dim] = slice(i * step, (i + 1) * step)
        x = x[tuple(index)]
    return x


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's block of a batched tree (dicts, lists, tuples of
    tensors or numpy arrays), each leaf cut along axis 0 over "data"."""
    return _map(lambda x: shard(mesh, x, data_sharding(mesh, x.ndim)), tree)


def gather_batch(mesh: Mesh, tree):
    """The inverse of shard_batch for tensors: every rank's block
    gathered along axis 0 over "data" (devc_tpu's global array)."""
    return _map(lambda x: all_gather(x, mesh.group("data")), tree)


def _leaves(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return []


@torch.no_grad()
def shard_params(mesh: Mesh, params):
    """Make every rank of the mesh hold rank 0's parameters: one broadcast
    per dtype of all the tensors in `params` (modules, tensors, or dicts
    and lists of them), written back in place. Returns params."""
    group = mesh.group("mesh")
    if group is None:
        return params
    by_dtype = {}
    for t in _leaves(params):
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        dist.broadcast(flat, src=dist.get_global_rank(group, 0), group=group)
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return params


# ---------------------------------------------------------- collectives
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x, op: str = "sum", group=None):
    """The sum or max of x over the group's ranks, out of place (x
    itself when group is None)."""
    if group is None:
        return x
    x = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, op=_OPS[op], group=group)
    return x


def all_gather(x, group=None, dim: int = 0):
    """Every rank's x (same shape on all), concatenated along dim in rank
    order."""
    if group is None:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _PSum(torch.autograd.Function):
    """all_reduce SUM whose backward sums the cotangents over the ranks:
    the transpose of psum, as devc_tpu's shard_map step takes it. A loss
    that each rank computes from a global mean then sends every rank's
    share of the gradient to every rank; averaging the gradients over the
    ranks (train/loop.py::_pmean) gives the one-process gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, "sum", group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, "sum", ctx.group), None


def psum(x, group=None):
    """Differentiable all_reduce SUM (x itself when group is None)."""
    if group is None:
        return x
    return _PSum.apply(x, group)


def axis_size(group) -> int:
    """The number of ranks in group (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group) -> int:
    """This rank's index in group (0 for None)."""
    return 0 if group is None else dist.get_rank(group)
