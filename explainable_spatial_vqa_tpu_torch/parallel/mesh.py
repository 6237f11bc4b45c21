"""Meshes over the ranks of ``torch.distributed``, ported from
``explainable_spatial_vqa_tpu/parallel/mesh.py``.

JAX puts every local device into one process and shards arrays over a
``Mesh`` of devices; the port runs one process per card (a rank), so a mesh
is a grid of ranks with named axes (a ``DeviceMesh``), and "sharding a
batch" means each rank holding its own contiguous rows.  The primary layout
is pure data parallelism over a 1-D ``("data",)`` mesh: parameters
replicated (broadcast from the axis's first rank), batches split by rows,
gradients averaged by an all-reduce (``train.trainer``).  A
``("data", "model")`` mesh also gives the tensor-parallel rules of
``parallel.sharding`` their ``model`` axis.

With no process group initialised, :func:`make_mesh` gives a one-rank mesh,
on which every path here is the identity; any larger mesh needs the group
(``parallel.multihost.initialize`` or ``torchrun``).

The data-parallel losses divide by global counts, as JAX's do over its
global batch: inside :func:`data_parallel`, :func:`global_normaliser` sums a
count over the data axis, and each rank's loss is its share of the global
loss (see the function).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh", "batch_sharding", "replicated", "shard_batch",
           "pad_to_multiple", "gather_rows", "data_parallel", "global_count",
           "global_normaliser", "collective_device"]


class Mesh:
    """Named axes over the process group's ranks, in rank order.

    ``shape`` maps each axis to its size (as ``jax.sharding.Mesh.shape``
    does); ``device_mesh`` is the ``DeviceMesh`` (None for the one-rank mesh
    made without a process group)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], device_mesh=None):
        self.axes = tuple(axes)
        self.shape: Dict[str, int] = dict(zip(self.axes, (int(s) for s in shape)))
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    def rank(self, axis: str = "data") -> int:
        """This rank's coordinate along ``axis``."""
        return 0 if self.device_mesh is None else self.device_mesh.get_local_rank(axis)

    def group(self, axis: str = "data"):
        """The process group of the ranks along ``axis`` through this rank
        (None on the one-rank mesh)."""
        return None if self.device_mesh is None else self.device_mesh.get_group(axis)

    def __getitem__(self, axis: str):
        """The 1-D ``DeviceMesh`` of ``axis`` (for ``parallelize_module``)."""
        if self.device_mesh is None:
            raise ValueError("a one-rank mesh made without a process group has no DeviceMesh")
        return self.device_mesh[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = ("data",),
              device_type: Optional[str] = None) -> Mesh:
    """A mesh over every rank of the process group; a single -1 absorbs the
    ranks the other axes leave.  The shape must cover the world exactly.
    ``device_type`` is the DeviceMesh's (default ``cuda`` under NCCL, else
    ``cpu``).  Without a process group the world is one rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[shape.index(-1)] = world // known
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover the {world} rank(s) of the "
                         "process group (initialise it with parallel.multihost.initialize)")
    if not dist.is_initialized():
        return Mesh(shape, axes)
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, axes, init_device_mesh(device_type, tuple(shape),
                                              mesh_dim_names=tuple(axes)))


def collective_device(group=None) -> torch.device:
    """Where host data goes for a collective on ``group``: the current card
    under NCCL, else the CPU (gloo gathers host tensors)."""
    if dist.is_initialized() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def batch_sharding(mesh: Mesh, rows: int, axis: str = "data") -> slice:
    """This rank's contiguous rows of a batch of ``rows`` split over
    ``axis``: rank ``r`` of ``n`` holds ``[r * rows/n, (r+1) * rows/n)``."""
    n = mesh.shape[axis]
    if rows % n:
        raise ValueError(f"{rows} rows do not split over the {n} ranks of axis {axis!r}")
    per = rows // n
    r = mesh.rank(axis)
    return slice(r * per, (r + 1) * per)


def replicated(obj: Any, mesh: Mesh, axis: str = "data") -> Any:
    """Broadcast ``obj`` in place from the first rank of ``axis``: a module's
    parameters and buffers, a tensor, or a sequence of tensors.  Each written
    tensor's version counter is bumped, so weights cached on the parameters
    (``models.layers.cached_on_params``: cast and K2-fused weights) are built
    anew."""
    group = mesh.group(axis)
    if isinstance(obj, torch.nn.Module):
        tensors = [*obj.parameters(), *obj.buffers()]
    elif isinstance(obj, torch.Tensor):
        tensors = [obj]
    else:
        tensors = list(obj)
    if group is None or dist.get_world_size(group) == 1:
        return obj
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
            torch.autograd.graph.increment_version(t)
    return obj


def pad_to_multiple(array: Any, multiple: int, axis: int = 0):
    """Pad ``array`` with zeros along ``axis`` so its size divides
    ``multiple``; returns (padded, original_size)."""
    size = array.shape[axis]
    remainder = size % multiple
    if remainder == 0:
        return array, size
    pad = multiple - remainder
    widths = [(0, 0)] * array.ndim
    widths[axis] = (0, pad)
    return np.pad(np.asarray(array), widths), size


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data") -> Any:
    """This rank's contiguous rows of every array in a dict, list or tuple
    of arrays (numpy or tensors); scalars stay whole."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh, axis) for v in batch)
    if getattr(batch, "ndim", 0) == 0:
        return batch
    return batch[batch_sharding(mesh, batch.shape[0], axis)]


def gather_rows(arrays: Dict[str, np.ndarray], mesh: Mesh,
                axis: str = "data") -> Dict[str, np.ndarray]:
    """Every rank's ``arrays``, concatenated along rows in rank order, on
    every rank: one all-gather of the arrays' bytes (each rank must hold the
    same shapes and types)."""
    group = mesh.group(axis)
    if group is None or dist.get_world_size(group) == 1:
        return dict(arrays)
    world = dist.get_world_size(group)
    names = sorted(arrays)
    flat = [np.ascontiguousarray(arrays[k]) for k in names]
    payload = np.concatenate([a.reshape(-1).view(np.uint8) for a in flat])
    device = collective_device(group)
    local = torch.from_numpy(payload).to(device)
    pieces = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(pieces, local, group=group)
    out: Dict[str, np.ndarray] = {}
    blobs = [p.cpu().numpy() for p in pieces]
    offset = 0
    for name, a in zip(names, flat):
        parts = [b[offset:offset + a.nbytes].view(a.dtype).reshape(a.shape) for b in blobs]
        out[name] = np.concatenate(parts, axis=0)
        offset += a.nbytes
    return out


_DATA_PARALLEL: contextvars.ContextVar[Optional[Tuple[Any, int]]] = contextvars.ContextVar(
    "data_parallel", default=None)


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh], axis: str = "data") -> Iterator[None]:
    """Within the block, :func:`global_normaliser` sums over ``axis`` of
    ``mesh`` (the trainer's steps run in it); a one-rank mesh or None
    changes nothing."""
    group = None if mesh is None else mesh.group(axis)
    if group is None or dist.get_world_size(group) == 1:
        yield
        return
    token = _DATA_PARALLEL.set((group, dist.get_world_size(group)))
    try:
        yield
    finally:
        _DATA_PARALLEL.reset(token)


def global_count(count: torch.Tensor) -> torch.Tensor:
    """``count`` summed over the data axis inside :func:`data_parallel` (a
    constant, no gradient); ``count`` itself outside it."""
    active = _DATA_PARALLEL.get()
    if active is None:
        return count
    summed = count.detach().float().clone()
    dist.all_reduce(summed, group=active[0])
    return summed


def global_normaliser(total: torch.Tensor, floor: float = 1.0) -> torch.Tensor:
    """``max(total, floor)``, where a loss divides a sum by it.

    Inside :func:`data_parallel` over n ranks ``total`` is this rank's count:
    the counts are summed over the ranks (a constant, no gradient) and the
    result is ``max(global total, floor) / n``.  Each rank's loss is then its
    rows' sum over that, and the mean of the ranks' losses is the global
    batch's loss, ``sum / max(global total, floor)``, as in JAX's global
    jit; averaging the ranks' gradients gives its gradient.  Losses that
    take a plain mean over rows need nothing: every rank holds as many."""
    active = _DATA_PARALLEL.get()
    if active is None:
        return torch.clamp(total, min=floor)
    return torch.clamp(global_count(total), min=floor) / active[1]
