"""Per-function box detection precision/recall @ IoU >= 0.5 and token-output
accuracy per function (thesis Tables 4.3 / 4.4, pp.28-30), copied from
``explainable_spatial_vqa_tpu/evalsuite/detection.py``: numpy on the host.

Matching protocol: a predicted box counts as a true positive if it matches an
unclaimed ground-truth box with IoU >= threshold (greedy best-first, each GT
claimed once).  Precision = TP / #pred, recall = TP / #gt, aggregated per
function token over all evaluated steps.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["DetectionTally", "greedy_box_match", "box_iou_matrix", "calibrate_conf_threshold"]


def box_iou_matrix(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(P, 4) x (G, 4) -> (P, G) IoU."""
    if len(pred) == 0 or len(gt) == 0:
        return np.zeros((len(pred), len(gt)))
    lt = np.maximum(pred[:, None, :2], gt[None, :, :2])
    rb = np.minimum(pred[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_p = np.clip(pred[:, 2] - pred[:, 0], 0, None) * np.clip(pred[:, 3] - pred[:, 1], 0, None)
    area_g = np.clip(gt[:, 2] - gt[:, 0], 0, None) * np.clip(gt[:, 3] - gt[:, 1], 0, None)
    union = area_p[:, None] + area_g[None, :] - inter + 1e-9
    return inter / union


def greedy_box_match(pred: np.ndarray, gt: np.ndarray, iou_threshold: float = 0.5) -> int:
    """Number of true positives under greedy best-first matching."""
    iou = box_iou_matrix(pred, gt)
    tp = 0
    claimed = np.zeros(len(gt), bool)
    order = np.dstack(np.unravel_index(np.argsort(-iou, axis=None), iou.shape))[0]
    used_pred = np.zeros(len(pred), bool)
    for p, g in order:
        if iou[p, g] < iou_threshold:
            break
        if used_pred[p] or claimed[g]:
            continue
        used_pred[p] = True
        claimed[g] = True
        tp += 1
    return tp


@dataclass
class DetectionTally:
    """Accumulates per-function box P/R and token accuracy."""

    iou_threshold: float = 0.5
    box_tp: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    box_pred: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    box_gt: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    token_correct: Dict[str, int] = field(default_factory=lambda: defaultdict(int))
    token_total: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def add_box_step(self, function: str, pred: np.ndarray, gt: np.ndarray) -> None:
        base = function.split("[")[0]
        self.box_tp[base] += greedy_box_match(pred, gt, self.iou_threshold)
        self.box_pred[base] += len(pred)
        self.box_gt[base] += len(gt)

    def add_token_step(self, function: str, pred, gt) -> None:
        base = function.split("[")[0]
        self.token_correct[base] += int(pred == gt)
        self.token_total[base] += 1

    def precision_recall(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for fn in sorted(set(self.box_pred) | set(self.box_gt)):
            p = self.box_tp[fn] / self.box_pred[fn] if self.box_pred[fn] else 0.0
            r = self.box_tp[fn] / self.box_gt[fn] if self.box_gt[fn] else 0.0
            out[fn] = {"precision": p, "recall": r}
        return out

    def token_accuracy(self) -> Dict[str, float]:
        return {
            fn: self.token_correct[fn] / self.token_total[fn]
            for fn in sorted(self.token_total)
            if self.token_total[fn]
        }

    def report(self) -> str:
        lines = [f"Box P/R @ IoU>={self.iou_threshold}:"]
        for fn, pr in self.precision_recall().items():
            lines.append(f"  {fn}: P={pr['precision']:.2f} R={pr['recall']:.2f}")
        lines.append("Token accuracy per function:")
        for fn, acc in self.token_accuracy().items():
            lines.append(f"  {fn}: {acc:.2f}")
        return "\n".join(lines)


def calibrate_conf_threshold(
    confidences: np.ndarray, is_true_positive_at: np.ndarray,
    thresholds: Optional[np.ndarray] = None, total_gt: Optional[int] = None,
) -> Tuple[float, float]:
    """Pick the confidence threshold maximizing box F1 on a validation set.

    ``confidences``: flat (N,) predicted confidences; ``is_true_positive_at``:
    (N,) bool, whether that prediction matches an unclaimed GT at IoU>=0.5
    (from greedy matching with threshold 0 applied first).  ``total_gt`` is
    the TOTAL ground-truth box count, GT no prediction matched included;
    when omitted it falls back to the matched-GT count, which inflates recall
    and biases the scan toward precision.  Returns (best_threshold, best_f1);
    the first of equal F1s wins.
    """
    if thresholds is None:
        thresholds = np.linspace(0.05, 0.95, 19)
    if total_gt is None:
        total_gt = int(np.sum(is_true_positive_at))
    best = (0.5, -1.0)
    for t in thresholds:
        keep = confidences >= t
        tp = int(np.sum(is_true_positive_at & keep))
        fp = int(np.sum(keep)) - tp
        fn = total_gt - tp
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-9)
        if f1 > best[1]:
            best = (float(t), f1)
    return best
