"""Box geometry and set matching for the DETR-style box decoder, ported from
``explainable_spatial_vqa_tpu/ops/matching.py``.

- IoU / GIoU, elementwise and pairwise (cost matrices);
- Sinkhorn-relaxed assignment, on the tensor's device;
- the exact matcher, :func:`hungarian_assignment`: scipy's
  ``linear_sum_assignment`` on the host, as the JAX package's
  ``_hungarian_host`` (``:182-207``) does.  The JAX default is an in-jit
  Jonker-Volgenant (``hungarian_assignment_jax``, ``:312``); both find the
  optimal assignment, so they agree wherever it is unique.  The price on the
  card is one device-to-host copy of the (B, Q, T) cost (with the mask) per
  call, and with it one wait for the card.

Conventions: boxes are (xmin, ymin, xmax, ymax) in [0, 1]; masks are boolean
with True = valid.  The matcher's assignments are constants, as in DETR:
nothing here is differentiated through them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

__all__ = ["box_area", "box_iou", "box_giou", "pairwise_iou", "pairwise_giou", "pairwise_l1",
           "sinkhorn", "sinkhorn_assignment", "hungarian_assignment"]


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
