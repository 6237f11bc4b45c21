"""Count-style metrics, ported from ``explainable_spatial_vqa_tpu/train/metrics.py``.

Every metric is a sum or a count, so it adds up exactly across batches.
The sums stay tensors on the batch's device: :class:`MetricAccumulator`
adds them there and reads them to the host once, when its ``totals`` are
asked for (once per epoch in the trainer), not once per step.  A
data-parallel trainer sums them over its ranks before it reads them
(:meth:`MetricAccumulator.sum_over`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from explainable_spatial_vqa_tpu_torch.ops.matching import box_iou

__all__ = ["answer_metrics", "program_metrics", "masked_token_metrics", "mean_iou",
           "MetricAccumulator"]

Number = Union[int, float, torch.Tensor]


def answer_metrics(answer_logits: torch.Tensor, answers: torch.Tensor) -> Dict[str, Number]:
    pred = torch.argmax(answer_logits, dim=-1)
    return {"answer_correct": (pred == answers).sum(), "answer_total": answers.shape[0]}


def program_metrics(program_pred: torch.Tensor, program_targets: torch.Tensor) -> Dict[str, Number]:
    """Exact-match counts over full sequences and token counts (all
    positions, padding included, as the reference compares them)."""
    token_eq = program_pred == program_targets
    return {
        "program_em": token_eq.all(dim=-1).sum(),
        "program_em_total": program_targets.shape[0],
        "token_correct": token_eq.sum(),
        "token_total": token_eq.numel(),
    }


def masked_token_metrics(pred: torch.Tensor, targets: torch.Tensor,
                         pad_id: int = 0) -> Dict[str, Number]:
    """Token accuracy over non-pad positions."""
    valid = targets != pad_id
    return {"token_correct": ((pred == targets) & valid).sum(), "token_total": valid.sum()}


def mean_iou(pred_boxes: torch.Tensor, target_boxes: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> Dict[str, Number]:
    iou = box_iou(pred_boxes, target_boxes)
    if mask is None:
        mask = torch.ones(iou.shape, dtype=torch.bool, device=iou.device)
    return {"iou_sum": torch.where(mask, iou, torch.zeros_like(iou)).sum(),
            "iou_count": mask.sum()}


class MetricAccumulator:
    """Sums of count-style metric dicts, kept where they were computed and
    read to the host in one copy by :attr:`totals`."""

    def __init__(self) -> None:
        self._sums: Dict[str, Number] = {}
        self._read: Optional[Dict[str, float]] = None

    def update(self, metrics: Dict[str, Number]) -> None:
        for key, value in metrics.items():
            if isinstance(value, torch.Tensor):
                value = value.detach()
            self._sums[key] = self._sums.get(key, 0) + value
        self._read = None

    @property
    def totals(self) -> Dict[str, float]:
        if self._read is None:
            tensors = {k: v for k, v in self._sums.items() if isinstance(v, torch.Tensor)}
            read = {k: float(v) for k, v in self._sums.items() if k not in tensors}
            if tensors:
                values = torch.stack([v.double().reshape(()) for v in tensors.values()])
                read.update(zip(tensors, values.tolist()))
            self._read = {k: read[k] for k in self._sums}
        return self._read

    def sum_over(self, group, device: torch.device, means: Tuple[str, ...] = ()) -> None:
        """Replace the totals by their sums over the ranks of ``group`` (one
        all-reduce on ``device``; every rank must hold the same keys), the
        keys in ``means`` by their means over the ranks."""
        import torch.distributed as dist

        totals = self.totals
        keys = sorted(totals)
        values = torch.tensor([totals[k] for k in keys], dtype=torch.float64, device=device)
        dist.all_reduce(values, group=group)
        world = dist.get_world_size(group)
        summed = dict(zip(keys, values.tolist()))
        self._sums = {k: summed[k] / world if k in means else summed[k] for k in totals}
        self._read = dict(self._sums)

    def ratio(self, num: str, den: str) -> float:
        totals = self.totals
        d = totals.get(den, 0.0)
        return totals.get(num, 0.0) / d if d else 0.0

    def mean(self, key: str, count_key: str = "batches") -> float:
        return self.ratio(key, count_key)
