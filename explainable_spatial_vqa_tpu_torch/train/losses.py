"""Loss functions, ported from ``explainable_spatial_vqa_tpu/train/losses.py``.

- ``cross_entropy``: token CE with optional ignore-index masking and label
  weights;
- ``executor_set_loss``: the thesis executor objective (§3.4.2 pp.20-22):
  routing CE (weight 0.1) + for box-branch rows a matched L1+GIoU
  regression with confidence BCE (weight 5.0) + for token-branch rows a
  value-token CE (weight 1.0).  The matching cost is
  ``5·L1 + 2·(1−GIoU) − log s``, taken without autograd; the assignment is
  exact on the tensors' device (``matcher="auto"`` or ``"hungarian_jax"``,
  as JAX's ``losses.py:89-95`` maps them:
  :func:`~explainable_spatial_vqa_tpu_torch.ops.matching.hungarian_assignment_device`,
  the kernel ``csrc/hungarian.cu`` on the card, with JAX's ties), exact on
  the host (``"hungarian"``: scipy,
  :func:`~explainable_spatial_vqa_tpu_torch.ops.matching.hungarian_assignment`,
  one copy to the host and a wait for the card) or Sinkhorn-relaxed on the
  device (``"sinkhorn"``).

Each loss that divides a sum by a count (``max(count, 1)``) divides by the
global batch's count when the trainer runs data parallel
(``parallel.mesh.global_normaliser``), as JAX's losses do over its global
batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.ops.matching import (
    box_giou,
    hungarian_assignment,
    hungarian_assignment_device,
    pairwise_giou,
    pairwise_l1,
    sinkhorn_assignment,
)
from explainable_spatial_vqa_tpu_torch.parallel.mesh import global_normaliser

__all__ = ["cross_entropy", "binary_cross_entropy", "matching_cost", "assign_targets",
           "executor_set_loss", "smooth_l1", "masked_box_regression_loss",
           "perturb_input_boxes"]

EXACT_MATCHERS = ("auto", "hungarian", "hungarian_jax")


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, ignore_index: Optional[int] = None,
                  label_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token-level CE: logits (..., V), targets (...) int.  Averages over
    positions with ``targets != ignore_index``, each weighted by
    ``label_weights``, over at least 1.  A target outside the logits gives
    NaN, as in the JAX package."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    targets = targets.long()
    inside = (targets >= 0) & (targets < log_probs.shape[-1])
    nll = -torch.gather(log_probs, -1, torch.where(inside, targets, 0)[..., None])[..., 0]
    nll = torch.where(inside, nll, torch.full_like(nll, float("nan")))
    weights = torch.ones_like(nll) if label_weights is None else label_weights.float()
    if ignore_index is not None:
        weights = weights * (targets != ignore_index)
    return (nll * weights).sum() / global_normaliser(weights.sum())


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-7) -> torch.Tensor:
    probs = torch.clamp(probs.float(), eps, 1.0 - eps)
    return -(targets * torch.log(probs) + (1.0 - targets) * torch.log(1.0 - probs))


def matching_cost(pred_boxes: torch.Tensor, pred_conf: torch.Tensor, target_boxes: torch.Tensor,
                  config: ExecutorConfig) -> torch.Tensor:
    """(B, Q, T) matching cost ``l1_w·L1 + giou_w·(1 − GIoU) − conf_w·log s``,
    without autograd (the assignments are constants, as in DETR)."""
    with torch.no_grad():
        pred_boxes, pred_conf = pred_boxes.float(), pred_conf.float()
        return (config.cost_l1 * pairwise_l1(pred_boxes, target_boxes)
                + config.cost_giou * (1.0 - pairwise_giou(pred_boxes, target_boxes))
                - config.cost_conf * torch.log(torch.clamp(pred_conf, 1e-7, 1.0))[..., None])


def assign_targets(cost: torch.Tensor, target_box_mask: torch.Tensor,
                   config: ExecutorConfig) -> torch.Tensor:
    """(B, Q) int64 target index per query, -1 = unmatched, by the
    configuration's matcher."""
    if config.matcher in ("auto", "hungarian_jax"):
        return hungarian_assignment_device(cost, target_box_mask)
    if config.matcher == "hungarian":
        return hungarian_assignment(cost, target_box_mask)
    if config.matcher != "sinkhorn":
        raise ValueError(f"unknown matcher {config.matcher!r}; have {EXACT_MATCHERS + ('sinkhorn',)}")
    assign = sinkhorn_assignment(cost, target_box_mask, n_iters=config.sinkhorn_iters,
                                 tau=config.sinkhorn_tau)
    # every query gets a "match": queries whose pick is not a valid target
    # are unmatched
    valid_at = torch.gather(target_box_mask, 1, assign)
    return torch.where(valid_at, assign, torch.full_like(assign, -1))


def executor_set_loss(
    outputs: Dict[str, torch.Tensor],
    target_boxes: torch.Tensor,
    target_box_mask: torch.Tensor,
    token_targets: torch.Tensor,
    is_box_branch: torch.Tensor,
    config: ExecutorConfig,
    sample_weight: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Full executor objective.

    outputs: ``ProgramExecutor`` output dict; target_boxes (B, T, 4);
    target_box_mask (B, T) bool; token_targets (B,) int; is_box_branch (B,)
    bool; ``sample_weight`` (B,) optionally down-weights rows (None = ones).
    Returns 'loss', its components and the 'assignment'.
    """
    pred_boxes = outputs["pred_boxes"].float()  # (B, Q, 4)
    pred_conf = outputs["pred_conf"].float()  # (B, Q)
    target_boxes = target_boxes.float()
    assign = assign_targets(matching_cost(pred_boxes, pred_conf, target_boxes, config),
                            target_box_mask, config)

    matched = assign >= 0
    safe = torch.clamp(assign, min=0)
    matched_targets = torch.gather(target_boxes, 1, safe[..., None].expand(-1, -1, 4))
    l1 = torch.abs(pred_boxes - matched_targets).sum(dim=-1)  # (B, Q)
    giou = box_giou(pred_boxes, matched_targets)
    reg = torch.where(matched, l1 + (1.0 - giou), torch.zeros_like(l1))

    is_box = is_box_branch.float()
    weight = torch.ones_like(is_box) if sample_weight is None else sample_weight.float()
    box_sample = (is_box * weight)[:, None]  # (B, 1)
    matched_f = matched.float()
    box_reg_loss = (reg * box_sample).sum() / global_normaliser((matched_f * box_sample).sum())
    conf_bce = binary_cross_entropy(pred_conf, matched_f)
    num_box_queries = global_normaliser(box_sample.sum() * pred_conf.shape[1])
    conf_loss = (conf_bce * box_sample).sum() / num_box_queries
    box_loss = box_reg_loss + conf_loss

    token_loss = cross_entropy(outputs["token_logits"], token_targets,
                               label_weights=(1.0 - is_box) * weight)
    # routing: 0 = box branch, 1 = token branch
    routing_loss = cross_entropy(outputs["routing_logits"], 1 - is_box_branch.long(),
                                 label_weights=weight)
    total = (config.routing_weight * routing_loss + config.bbox_weight * box_loss
             + config.token_weight * token_loss)
    return {
        "loss": total,
        "routing_loss": routing_loss,
        "box_loss": box_loss,
        "box_reg_loss": box_reg_loss,
        "conf_loss": conf_loss,
        "token_loss": token_loss,
        "assignment": assign,
    }


def smooth_l1(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise Huber/SmoothL1 (torch convention)."""
    diff = torch.abs(pred.float() - target.float())
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def masked_box_regression_loss(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Mean SmoothL1 over valid box slots: (B, S, 4) boxes, (B, S) mask."""
    per_box = smooth_l1(pred_boxes, target_boxes).sum(dim=-1)
    valid = mask.float()
    return (per_box * valid).sum() / global_normaliser(valid.sum() * 4.0)


def perturb_input_boxes(boxes: torch.Tensor, mask: torch.Tensor, generator: torch.Generator,
                        noise_scale: float, drop_prob: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grounding-noise augmentation for executor training: Gaussian noise on
    the corners of the valid dependency boxes (clipped to [0, 1]) and valid
    slots dropped with probability ``drop_prob``, approximating the upstream
    error chained inference sees.  The draws come from ``generator`` (on its
    own device) and move to the boxes' device."""
    if noise_scale > 0.0:
        noise = torch.randn(boxes.shape, generator=generator, device=generator.device)
        noise = (noise_scale * noise).to(boxes.device)
        boxes = torch.clamp(boxes + noise * mask[..., None], 0.0, 1.0)
    if drop_prob > 0.0:
        keep = torch.rand(mask.shape, generator=generator, device=generator.device) >= drop_prob
        mask = mask & keep.to(mask.device)
    return boxes, mask
