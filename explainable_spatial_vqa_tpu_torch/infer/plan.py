"""Host-side batch planning for the sorted and bucketed chain modes, copied
from ``explainable_spatial_vqa_tpu/infer/plan.py:18-83`` (numpy only).

Both plans return ``(depth, size, indices, real)`` per batch: ``indices`` has
length ``size`` (a tail batch rounds up to the next power of two at least
``min_tail``, at most ``batch``, then up to a ``multiple``), the padding
repeats the last real index, and ``real`` counts the real prefix.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["plan_sorted", "plan_buckets"]


def _tail_size(real: int, batch: int, min_tail: int, multiple: int) -> int:
    size = batch if real == batch else min(batch, max(min_tail, 1 << (real - 1).bit_length()))
    if size % multiple:
        size = (size + multiple - 1) // multiple * multiple
    return size


def _padded(part: np.ndarray, batch: int, min_tail: int, multiple: int):
    real = part.size
    size = _tail_size(real, batch, min_tail, multiple)
    if real < size:
        part = np.concatenate([part, np.repeat(part[-1], size - real)])
    return size, part, real


def plan_sorted(num_steps, batch: int, min_tail: int = 32,
                multiple: int = 1) -> List[Tuple[int, int, np.ndarray, int]]:
    """Questions sorted by chain depth (stable) and cut into batches; each
    batch's depth is its own deepest chain, the loop bound it runs to."""
    num_steps = np.asarray(num_steps)
    order = np.argsort(num_steps, kind="stable")
    plan = []
    for start in range(0, len(order), batch):
        size, part, real = _padded(order[start:start + batch], batch, min_tail, multiple)
        plan.append((int(num_steps[part].max()), size, part, real))
    return plan


def plan_buckets(num_steps, batch: int, bucket_edges, min_tail: int = 32,
                 multiple: int = 1) -> List[Tuple[int, int, np.ndarray, int]]:
    """Each question in a batch of the shallowest bucket edge that holds its
    depth; the batch's depth is the edge.  Raises if the edges do not cover
    the deepest chain."""
    num_steps = np.asarray(num_steps)
    plan = []
    assigned = np.zeros(len(num_steps), bool)
    for depth in bucket_edges:
        select = (~assigned) & (num_steps <= depth)
        assigned |= select
        idx = np.flatnonzero(select)
        for start in range(0, idx.size, batch):
            size, part, real = _padded(idx[start:start + batch], batch, min_tail, multiple)
            plan.append((depth, size, part, real))
    if not assigned.all():
        raise ValueError(
            f"{int((~assigned).sum())} questions exceed the deepest bucket edge "
            f"{max(bucket_edges)} (max num_steps {int(num_steps.max())})")
    return plan
