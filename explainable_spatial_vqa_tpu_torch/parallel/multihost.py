"""Multi-process entry points, ported from
``explainable_spatial_vqa_tpu/parallel/multihost.py``.

JAX runs one process per host over all of its devices and joins the hosts
with ``jax.distributed.initialize``; the port runs one process per card and
joins them with ``torch.distributed.init_process_group``.  Every process
computes the same global batch permutation (seeded identically) and gathers
only its own contiguous rows (:func:`host_batch_slice`, used by
``train.data.batches``), and the data-parallel trainer averages the
gradients.  With one process every path is the single-process one
(tests/test_torch_parallel.py runs the one-process dry run).

Start N processes with ``torchrun --nproc_per_node N -m
explainable_spatial_vqa_tpu_torch.cli --multihost ...`` (the rendezvous comes
from the environment), or start each with ``--multihost
--coordinator_address HOST:PORT --num_processes N --process_id I``.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from explainable_spatial_vqa_tpu_torch.parallel.mesh import Mesh, make_mesh

__all__ = [
    "initialize",
    "is_multihost",
    "process_index",
    "process_count",
    "host_batch_slice",
    "global_batch",
    "make_global_mesh",
]

logger = logging.getLogger(__name__)


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    ``coordinator_address`` is process 0's ``host:port`` (``tcp://``); left
    unset, the rendezvous, world size and rank come from the environment
    (``env://``, as ``torchrun`` sets it).  The backend is ``nccl`` when
    CUDA is available, else ``gloo``; pass ``backend="gloo"`` for ranks that
    share one card (NCCL refuses two ranks on a device; gloo all-reduces and
    broadcasts CUDA tensors).  Under NCCL each process takes the card
    ``LOCAL_RANK`` (or its rank modulo the cards).  ``num_processes=1`` is
    the one-process group, which must behave as no group."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    if backend == "nccl":
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)
    logger.info("multihost: process %d/%d (%s)", dist.get_rank(), dist.get_world_size(), backend)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_multihost() -> bool:
    return process_count() > 1


def host_batch_slice(global_batch_size: int, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> slice:
    """This process's contiguous row slice of every global batch.

    Global rows are process-major (process p owns rows
    ``[p*per_host, (p+1)*per_host)``), matching :func:`make_global_mesh`'s
    rank order, so each process reads only its own rows."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    if global_batch_size % process_count:
        raise ValueError(
            f"global batch size {global_batch_size} must divide across "
            f"{process_count} processes"
        )
    per_host = global_batch_size // process_count
    return slice(process_index * per_host, (process_index + 1) * per_host)


def make_global_mesh(shape: Sequence[int] = (-1,), axes: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over every process in rank order (process-major, as JAX's
    global mesh is): the data axis's rank ``r`` holds rows
    :func:`host_batch_slice` gives process ``r``."""
    return make_mesh(shape, axes)


def global_batch(batch: Any, mesh: Mesh, axis: str = "data") -> Any:
    """The global batch as the port holds it: every process keeps its own
    :func:`host_batch_slice` rows, so this is the local batch with its
    arrays as CPU tensors; no row moves between processes.  With one
    process it is the identity on the batch's values."""
    del mesh, axis  # the local rows are this rank's shard already

    def put(x):
        return torch.as_tensor(np.asarray(x))

    if isinstance(batch, dict):
        return {k: put(v) for k, v in batch.items()}
    return put(batch)
