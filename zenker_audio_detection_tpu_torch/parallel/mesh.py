"""Device meshes and sharding over `torch.distributed`.

The port of the JAX package's `parallel/mesh.py`. JAX runs every device of
a mesh in one process and XLA inserts the collectives; here each device is
one rank of a process group (`parallel/launch.py` starts them, or
`torchrun`), a mesh is a `torch.distributed.device_mesh.DeviceMesh` over
those ranks, and the collectives XLA would insert are written out, here
and nowhere else:

  * training: parameters and optimizer state replicated (`replicate`), the
    batch's rows sharded over the mesh (`shard_batch`); each rank's logits
    are gathered into the global batch (`gather_rows`) so that the loss
    and its batch statistics are the global batch's, and the parameter
    gradients are summed over the mesh (`all_reduce_grads`) — over one
    named sub-mesh (`mesh["data"]`) for fold and trial groups, with no
    collective across groups;
  * inference: the models replicated, each chunk's windows sharded, the
    probabilities gathered back in window order.

Rank order is JAX's flattened device order: the ranks of a mesh in
row-major (dcn-major) order, and a rank's shard is its contiguous slice of
the leading axis. A hierarchical ("dcn", "data") mesh keeps each slice's
ranks contiguous, as JAX's reshape does; the batch still shards over all
of its ranks.

The backend is the process group's: NCCL between cards, gloo on the CPU
(gloo also carries `broadcast` and `all_reduce` of CUDA tensors, which is
all this module sends). Nothing here talks to a process group at import
time.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
DCN_AXIS = "dcn"
FOLD_AXIS = "fold"


def _device_type(device) -> str:
    return "cpu" if torch.device(device).type == "cpu" else "cuda"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main(mesh=None) -> bool:
    """Whether this rank writes: global rank 0, or with `mesh` its first
    rank (a fold group's writer)."""
    if mesh is None:
        return rank() == 0
    return mesh_rank(mesh) == 0


def barrier(mesh=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=None if mesh is None else group_of(mesh))


def _need_group(what: str) -> None:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{what} needs a torch.distributed process group: run under "
            "parallel.launch.spawn (the CLIs' --num-devices) or torchrun")


def _visible(device_type: str) -> int:
    if device_type == "cuda":
        return torch.cuda.device_count()
    return world_size()


def _grid(ranks, shape, names):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_current_device_type(),
                      torch.as_tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=names)


# set by parallel/launch.py in each rank: the device its work lives on
RANK_DEVICE_ENV = "ZENKER_RANK_DEVICE"


def _current_device_type() -> str:
    """Where this rank's tensors live: the launcher's record, else (under
    torchrun) the card for NCCL and the CPU for gloo."""
    recorded = os.environ.get(RANK_DEVICE_ENV)
    if recorded:
        return _device_type(recorded)
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_mesh(devices=None, num_slices: int = 1):
    """1-D mesh (axis "data") over the given ranks (default: every rank of
    the process group), or a hierarchical ("dcn", "data") mesh when
    num_slices > 1, each slice's ranks contiguous."""
    _need_group("a mesh")
    ranks = list(range(world_size()) if devices is None else devices)
    if num_slices <= 1:
        return _grid(ranks, (len(ranks),), (DATA_AXIS,))
    if len(ranks) % num_slices:
        raise ValueError(f"{len(ranks)} devices not divisible by "
                         f"{num_slices} slices")
    return _grid(ranks, (num_slices, len(ranks) // num_slices),
                 (DCN_AXIS, DATA_AXIS))


def make_mesh(num_devices: int | None, num_slices: int | None = None,
              axis_name: str = DATA_AXIS, device="cuda"):
    """Mesh over the first `num_devices` ranks; None when <= 1 requested
    (single-device mode). The CLI-facing constructor: validates
    availability instead of silently shrinking. `num_slices` > 1 builds the
    hierarchical dcn x data mesh. `axis_name` renames the 1-D axis (e.g.
    "fold" for fold-parallel training). "Visible" devices are the cards
    (`torch.cuda.device_count()`) on CUDA and the process group's ranks on
    the CPU."""
    if num_slices is not None and num_slices < 1:
        raise ValueError(f"num_slices must be >= 1, got {num_slices}")
    if num_slices is not None and num_slices > 1 and axis_name != DATA_AXIS:
        raise ValueError("num_slices > 1 only applies to the data axis")
    if num_devices is None or num_devices == 1:
        if num_slices is not None and num_slices > 1:
            raise ValueError("num_slices > 1 requires num_devices > 1")
        return None
    if num_devices < 1:
        raise ValueError(f"num_devices must be >= 1, got {num_devices}")
    check_visible(num_devices, device)
    _need_group("a mesh")
    if world_size() != num_devices:
        raise ValueError(f"requested {num_devices} devices, the process "
                         f"group has {world_size()} ranks")
    ranks = list(range(num_devices))
    if num_slices is None or num_slices <= 1:
        return _grid(ranks, (num_devices,), (axis_name,))
    return data_mesh(ranks, num_slices=num_slices)


def check_visible(num_devices: int, device="cuda") -> None:
    """Raise JAX's error when fewer devices are visible than requested. On
    the CPU before any process group exists every count is visible (the
    launcher starts that many ranks)."""
    device_type = _device_type(device)
    if device_type == "cpu" and not dist.is_initialized():
        return
    visible = _visible(device_type)
    if visible < num_devices:
        raise ValueError(
            f"requested {num_devices} devices, only {visible} visible")


def fold_data_mesh(num_devices: int, data_per_fold: int,
                   axis_name: str = FOLD_AXIS, device="cuda"):
    """2-D (`axis_name`, "data") mesh: groups of `data_per_fold` ranks, one
    group per concurrently trained fold (train/fold_parallel.py) or sweep
    trial (train/trial_parallel.py, axis_name="trial"). Within a group a
    fold's rows are sharded over "data" and its gradient is summed over
    the group's ranks only; across groups there is no collective.
    Contiguous blocks of ranks form the groups."""
    if data_per_fold < 1:
        raise ValueError(f"data_per_fold must be >= 1, got {data_per_fold}")
    if num_devices % data_per_fold:
        raise ValueError(f"{num_devices} devices not divisible into "
                         f"groups of {data_per_fold}")
    check_visible(num_devices, device)
    _need_group("a mesh")
    if world_size() != num_devices:
        raise ValueError(f"requested {num_devices} devices, the process "
                         f"group has {world_size()} ranks")
    return _grid(list(range(num_devices)),
                 (num_devices // data_per_fold, data_per_fold),
                 (axis_name, DATA_AXIS))


def mesh_ranks(mesh) -> list[int]:
    """The mesh's ranks in flattened (row-major) order."""
    return mesh.mesh.flatten().tolist()


def mesh_rank(mesh) -> int:
    """This rank's position in the mesh's flattened order."""
    return mesh_ranks(mesh).index(rank())


def mesh_size(mesh) -> int:
    return mesh.mesh.numel()


def group_of(mesh):
    """The process group spanning every rank of `mesh`: its own group for
    a 1-D mesh; a multi-dimensional mesh spans the whole process group."""
    if mesh.mesh.dim() == 1:
        return mesh.get_group()
    if mesh_size(mesh) != world_size():
        raise ValueError("a multi-dimensional mesh must span every rank")
    return dist.group.WORLD


def replicate(tree, mesh):
    """Every rank of `mesh` holds its first rank's tensors (a nested dict
    of tensors, or one tensor), in place and returned."""
    group = group_of(mesh)
    src = mesh_ranks(mesh)[0]
    leaves = [tree] if isinstance(tree, torch.Tensor) else list(_leaves(tree))
    for leaf in leaves:
        dist.broadcast(leaf.data, src=src, group=group)
    return tree


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif isinstance(v, torch.Tensor):
            yield v


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0,
                    pad_value=0.0) -> tuple[np.ndarray, int]:
    """Pad `axis` up to a multiple of `multiple`; returns (padded, n_valid).

    Sharded batches must divide evenly across devices; callers mask out the
    padded tail using n_valid.
    """
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return np.pad(x, widths, constant_values=pad_value), n


def local_batch_size(global_batch: int, mesh) -> int:
    n = mesh_size(mesh)
    if global_batch % n:
        raise ValueError(
            f"global batch {global_batch} not divisible by {n} devices")
    return global_batch // n


def _slice(n: int, mesh) -> slice:
    b = local_batch_size(n, mesh)
    r = mesh_rank(mesh)
    return slice(r * b, (r + 1) * b)


def shard_batch(x, mesh, dim: int = 0, device=None):
    """This rank's contiguous slice of `x` along `dim` (the leading axis by
    default), a tensor on `device` (default: a tensor stays where it is, a
    numpy array goes to this rank's device)."""
    sl = _slice(x.shape[dim], mesh)
    index = (slice(None),) * dim + (sl,)
    if isinstance(x, torch.Tensor):
        out = x[index]
        return out if device is None else out.to(device)
    out = torch.from_numpy(np.ascontiguousarray(np.asarray(x)[index]))
    return out.to(rank_device(mesh) if device is None else device)


def rank_device(mesh=None) -> torch.device:
    """This rank's device: its current card when the mesh carries CUDA
    tensors, else the CPU."""
    device_type = (mesh.device_type if mesh is not None
                   else _current_device_type())
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def gather_rows(local: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The global tensor of which every rank of `mesh` holds its
    contiguous slice along `dim`, on every rank, in mesh order. A sum of
    zero-padded slices (exact: each element has one nonzero term), so it
    runs on `all_reduce`, which both backends take for CUDA and CPU
    tensors alike."""
    n = mesh_size(mesh)
    b = local.shape[dim]
    shape = list(local.shape)
    shape[dim] = b * n
    out = local.new_zeros(shape)
    r = mesh_rank(mesh)
    out.narrow(dim, r * b, b).copy_(local)
    dist.all_reduce(out, group=group_of(mesh))
    return out


def local_rows(global_tensor: torch.Tensor, mesh, dim: int = 0):
    """This rank's slice along `dim` of a tensor every rank holds whole."""
    b = local_batch_size(global_tensor.shape[dim], mesh)
    return global_tensor.narrow(dim, mesh_rank(mesh) * b, b)


def all_reduce_grads(grads: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """The sum of every rank's gradients over `mesh`, in one collective
    (the leaves flattened into one buffer per dtype)."""
    if not grads:
        return grads
    group = group_of(mesh)
    out = list(grads)
    by_dtype: dict = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        offset = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[offset: offset + n].view_as(grads[i])
            offset += n
    return out


def all_gather_objects(obj, mesh=None) -> list:
    """Every rank's picklable `obj`, in rank order (over `mesh`, default
    the whole process group)."""
    if not dist.is_initialized():
        return [obj]
    group = None if mesh is None else group_of(mesh)
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
