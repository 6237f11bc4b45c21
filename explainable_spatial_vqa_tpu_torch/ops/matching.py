"""Box geometry and set matching for the DETR-style box decoder, ported from
``explainable_spatial_vqa_tpu/ops/matching.py``.

- IoU / GIoU, elementwise and pairwise (cost matrices);
- Sinkhorn-relaxed assignment, on the tensor's device;
- the exact matcher on the device, :func:`hungarian_assignment_device`: the
  JAX package's default, ``hungarian_assignment_jax`` (``:238-340``), the
  Jonker-Volgenant LAP of ``_lap_single`` batched over problems, at any size.
  On the card it is ``csrc/hungarian.cu``, launched on the current stream with
  no host read and no wait: one warp per problem while m + 1 <= 32 (m =
  max(Q, T); :data:`MAX_SIDE`), one block per problem past that; on the CPU it
  is :func:`hungarian_assignment_device_plain`, the same float32 operations in
  the same order on tensors.  Both break ties among optimal assignments as
  JAX does (the first index of a minimum wins);
- the exact matcher on the host, :func:`hungarian_assignment`: scipy's
  ``linear_sum_assignment``, as the JAX package's ``_hungarian_host``
  (``:182-207``) does.  It finds an optimal assignment too, so it agrees with
  the device matcher wherever the optimum is unique, and breaks ties its own
  way.  The price on the card is one device-to-host copy of the (B, Q, T)
  cost (with the mask) per call, and with it one wait for the card.

Conventions: boxes are (xmin, ymin, xmax, ymax) in [0, 1]; masks are boolean
with True = valid.  The matcher's assignments are constants, as in DETR:
nothing here is differentiated through them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from explainable_spatial_vqa_tpu_torch.ops import _build

__all__ = ["box_area", "box_iou", "box_giou", "pairwise_iou", "pairwise_giou", "pairwise_l1",
           "sinkhorn", "sinkhorn_assignment", "hungarian_assignment",
           "hungarian_assignment_device", "hungarian_assignment_device_plain", "kernel_launches",
           "set_shared_limit", "MAX_SIDE"]

# the warp kernel's largest max(Q, T): one lane per column, plus column 0;
# larger problems take the block kernel
MAX_SIDE = 31


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def _intersection(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    wh = torch.clamp(torch.minimum(a[..., 2:], b[..., 2:]) - torch.maximum(a[..., :2], b[..., :2]),
                     min=0.0)
    return wh[..., 0] * wh[..., 1]


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Elementwise IoU over matching leading dims; a, b: (..., 4)."""
    inter = _intersection(a, b)
    return inter / (box_area(a) + box_area(b) - inter + eps)


def box_giou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Generalized IoU (Rezatofighi et al. 2019), elementwise."""
    inter = _intersection(a, b)
    union = box_area(a) + box_area(b) - inter + eps
    wh = torch.clamp(torch.maximum(a[..., 2:], b[..., 2:]) - torch.minimum(a[..., :2], b[..., :2]),
                     min=0.0)
    hull = wh[..., 0] * wh[..., 1] + eps
    return inter / union - (hull - union) / hull


def pairwise_iou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """pred (..., Q, 4) x target (..., T, 4) -> (..., Q, T)."""
    return box_iou(pred[..., :, None, :], target[..., None, :, :])


def pairwise_giou(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return box_giou(pred[..., :, None, :], target[..., None, :, :])


def pairwise_l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred[..., :, None, :] - target[..., None, :, :]).sum(dim=-1)


def sinkhorn(log_alpha: torch.Tensor, n_iters: int = 20) -> torch.Tensor:
    """Sinkhorn normalization of (..., Q, T) log scores (higher = better) to a
    doubly-stochastic matrix: rows, then columns, ``n_iters`` times."""
    for _ in range(n_iters):
        log_alpha = log_alpha - torch.logsumexp(log_alpha, dim=-1, keepdim=True)
        log_alpha = log_alpha - torch.logsumexp(log_alpha, dim=-2, keepdim=True)
    return torch.exp(log_alpha)


def sinkhorn_assignment(cost: torch.Tensor, target_mask: Optional[torch.Tensor] = None,
                        n_iters: int = 20, tau: float = 1.0) -> torch.Tensor:
    """Per-query argmax over a Sinkhorn-relaxed transport plan: cost (..., Q, T),
    target_mask (..., T) True = valid; returns (..., Q) int64 target indices
    (meaningless where no valid target exists).  ``tau`` is the entropic
    temperature: lower is sharper, closer to the exact assignment."""
    if target_mask is not None:
        cost = torch.where(target_mask[..., None, :], cost, torch.full_like(cost, 1e9))
    return torch.argmax(sinkhorn(-cost / tau, n_iters), dim=-1)


def hungarian_assignment(cost: torch.Tensor, target_mask: torch.Tensor) -> torch.Tensor:
    """Exact optimal assignment on the host.

    cost (B, Q, T) float; target_mask (B, T) bool, valid targets anywhere.
    Returns (B, Q) int64 on cost's device: the target each query is matched
    to, -1 for unmatched queries (more queries than valid targets, or none).
    The cost and the mask cross to the host in one copy.
    """
    batch, num_q, num_t = cost.shape
    host = torch.cat([cost.detach().float(), target_mask[:, None, :].float()], dim=1).cpu().numpy()
    out = np.full((batch, num_q), -1, dtype=np.int64)
    for b in range(batch):
        cols = np.flatnonzero(host[b, num_q] > 0)
        if len(cols) == 0:
            continue
        rows, picked = linear_sum_assignment(host[b, :num_q][:, cols])
        out[b, rows] = cols[picked]
    return torch.from_numpy(out).to(cost.device)


def _padded_costs(cost: torch.Tensor, target_mask: torch.Tensor) -> torch.Tensor:
    """``hungarian_assignment_jax``'s padding (``:324-330``): invalid targets
    and, when Q > T, Q - T dummy columns cost ``max|cost·mask| * 4 + 1e3``
    of their problem; (B, Q, max(Q, T)) float32."""
    b, q, t = cost.shape
    keep = target_mask[:, None, :]
    pad = torch.where(keep, cost, 0.0).abs().amax(dim=(1, 2), keepdim=True) * 4.0 + 1e3
    cost = torch.where(keep, cost, pad)
    if q > t:
        cost = torch.cat([cost, pad.expand(b, q, q - t)], dim=-1)
    return cost


def _argmin_first(values: torch.Tensor) -> torch.Tensor:
    """``jnp.argmin`` along the last dim: the first NaN, else the first
    index of the minimum."""
    nan = torch.isnan(values)
    return torch.where(nan.any(-1), nan.to(torch.uint8).argmax(-1), values.argmin(-1))


def hungarian_assignment_device_plain(cost: torch.Tensor,
                                      target_mask: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`hungarian_assignment_device`:
    ``_lap_single`` (``explainable_spatial_vqa_tpu/ops/matching.py:238-309``)
    op for op in float32, vectorised over the batch.  Each while loop runs
    until every problem in the batch is done, with the finished problems
    masked, and at most m + 1 times (a NaN or infinite cost cannot loop
    forever).  Same contract as :func:`hungarian_assignment_device`."""
    cost = cost.detach().to(torch.float32)
    target_mask = target_mask.to(torch.bool)
    b, n, t = cost.shape
    dev = cost.device
    if b == 0 or n == 0 or t == 0:
        return torch.full((b, n), -1, dtype=torch.int64, device=dev)
    padded = _padded_costs(cost, target_mask)
    m = padded.shape[-1]
    costp = torch.nn.functional.pad(padded, (1, 0, 1, 0))  # 1-based, row/col 0 = 0
    big = torch.tensor(torch.finfo(torch.float32).max / 4, dtype=torch.float32, device=dev)
    cols = torch.arange(m + 1, device=dev)
    rows = torch.arange(b, device=dev)
    u = torch.zeros(b, n + 1, device=dev)
    v = torch.zeros(b, m + 1, device=dev)
    p = torch.zeros(b, m + 1, dtype=torch.int64, device=dev)
    for i in range(n):
        p[:, 0] = i + 1
        minv = big.expand(b, m + 1).clone()
        way = torch.zeros(b, m + 1, dtype=torch.int64, device=dev)
        used = torch.zeros(b, m + 1, dtype=torch.bool, device=dev)
        j0 = torch.zeros(b, dtype=torch.int64, device=dev)
        for _ in range(m + 1):
            i0 = p[rows, j0]
            active = i0 != 0
            if not bool(active.any()):
                break
            act = active[:, None]
            used_n = used | (act & (cols == j0[:, None]))
            cur = (costp[rows, i0] - u[rows, i0][:, None]) - v
            upd = ~used_n & (cur < minv) & (cols > 0)
            minv_n = torch.where(upd, cur, minv)
            way_n = torch.where(upd, j0[:, None], way)
            masked = torch.where(used_n | (cols == 0), big, minv_n)
            j1 = _argmin_first(masked)
            delta = masked[rows, j1][:, None]
            u_n = u.scatter_add(1, p, torch.where(used_n, delta, 0.0))
            v_n = torch.where(used_n, v - delta, v)
            minv_n = torch.where(used_n, minv_n, minv_n - delta)
            used = torch.where(act, used_n, used)
            minv = torch.where(act, minv_n, minv)
            way = torch.where(act, way_n, way)
            u = torch.where(act, u_n, u)
            v = torch.where(act, v_n, v)
            j0 = torch.where(active, j1, j0)
        for _ in range(m + 1):  # augment along way
            moving = j0 != 0
            if not bool(moving.any()):
                break
            j1 = way[rows, j0]
            p = torch.where(moving[:, None] & (cols == j0[:, None]), p[rows, j1][:, None], p)
            j0 = torch.where(moving, j1, j0)
    # row_to_col[p[j] - 1] = j - 1 for matched columns; unset rows read 0, as
    # the JAX package's zero-initialised scatter leaves them
    row_to_col = torch.zeros(b, n + 1, dtype=torch.int64, device=dev)
    matched = p[:, 1:] > 0
    row_to_col.scatter_(1, torch.where(matched, p[:, 1:] - 1, n),
                        torch.arange(m, device=dev).expand(b, m).clone())
    assign = row_to_col[:, :n]
    valid = (assign < t) & torch.gather(target_mask, 1, assign.clamp(max=t - 1))
    return torch.where(valid, assign, torch.full_like(assign, -1))


@functools.lru_cache(maxsize=None)
def _esv_hungarian():
    """The C entries of ``csrc/hungarian.cu``: (``esv_hungarian``,
    ``esv_hungarian_scratch_bytes``), their types set; bound once, on the
    first call, after ``_build.load`` has built and loaded the library."""
    lib = _build.load("hungarian")
    return (_build.bind_entry(lib, "esv_hungarian",
                              (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)),
            _build.bind_entry(lib, "esv_hungarian_scratch_bytes", (ctypes.c_int,) * 3,
                              ctypes.c_longlong))


def kernel_launches() -> Dict[str, int]:
    """The matcher's launches by kernel, as the C library counts them since it
    was loaded: ``hungarian_kernel`` (a warp a problem, m + 1 <= 32),
    ``hungarian_block_kernel`` (a block a problem) and, among the latter,
    ``hungarian_block_kernel_global_state`` (the launches whose state went to
    global memory).  The kernel is chosen in ``esv_hungarian`` alone; the
    difference of two readings says which ran.  Needs the library (a card
    and ``nvcc``)."""
    names, count = _launch_counters()
    return {n: count(i) for i, n in enumerate(names)}


@functools.lru_cache(maxsize=None)
def _launch_counters():
    return _build.launch_counters("hungarian", "esv_hungarian_kernel", "esv_hungarian_launches")


def set_shared_limit(nbytes: Optional[int]) -> Optional[int]:
    """Cap the block kernel's shared memory at ``nbytes`` (None: the card's
    capacity, the default); the cap it replaces.  Past the cap a launch keeps
    its state in a global scratch that the wrapper allocates, so a cap of 0
    exercises that path at any size.  Needs the library."""
    fn = _build.load("hungarian").esv_hungarian_set_shared_limit
    fn.argtypes, fn.restype = [ctypes.c_longlong], ctypes.c_longlong
    old = fn(-1 if nbytes is None else nbytes)
    return None if old < 0 else old


def hungarian_assignment_device(cost: torch.Tensor, target_mask: torch.Tensor) -> torch.Tensor:
    """Exact optimal assignment on the tensors' device, with JAX's ties.

    cost (B, Q, T) float; target_mask (B, T) bool, valid targets anywhere.
    Returns (B, Q) int64: the target each query is matched to, -1 for
    unmatched queries (a dummy column when Q > T, an invalid target, or no
    valid target at all).  Any Q and T, as JAX's.  A CUDA tensor launches
    ``csrc/hungarian.cu`` on the current stream (no host read, no wait); a
    CPU tensor runs :func:`hungarian_assignment_device_plain`.
    """
    if cost.ndim != 3 or target_mask.shape != (cost.shape[0], cost.shape[2]):
        raise ValueError(f"hungarian_assignment_device: cost (B, Q, T) and target_mask (B, T); "
                         f"got {tuple(cost.shape)} and {tuple(target_mask.shape)}")
    if cost.device.type == "cpu":
        return hungarian_assignment_device_plain(cost, target_mask)
    if cost.device.type != "cuda" or target_mask.device != cost.device:
        raise ValueError(f"hungarian_assignment_device: cost on {cost.device}, target_mask on "
                         f"{target_mask.device}; both must be on one CUDA device or the CPU")
    b, q, t = cost.shape
    if b == 0 or q == 0 or t == 0:
        return torch.full((b, q), -1, dtype=torch.int64, device=cost.device)
    cost = cost.detach().to(torch.float32).contiguous()
    keep = target_mask.to(torch.bool).contiguous()
    out = cost.new_empty((b, q), dtype=torch.int64)
    launch, scratch_bytes = _esv_hungarian()
    with torch.cuda.device(cost.device):
        nbytes = scratch_bytes(b, q, t)  # the block kernel's state past shared memory
        _build.check(-nbytes if nbytes < 0 else 0, "esv_hungarian_scratch_bytes")
        scratch = cost.new_empty((nbytes,), dtype=torch.uint8) if nbytes else None
        hungarian_assignment_device.launches += 1
        status = launch(cost.data_ptr(), keep.data_ptr(), out.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), b, q, t,
                        torch.cuda.current_stream(cost.device).cuda_stream)
    _build.check(status, "esv_hungarian")
    return out


hungarian_assignment_device.launches = 0
