"""The chain-of-thought (bbox-as-tokens) IQAP's loss and metric, ported from
``explainable_spatial_vqa_tpu/models/cot.py``.

In this variant the boxes' coordinates stand inline in the decoded
program/answer sequence as 3-decimal text tokens ('0.123').  The model is
:class:`~explainable_spatial_vqa_tpu_torch.models.iqap.TransformerIQAP`
decoding the combined sequence; here are its pieces:

- :func:`bbox_token_table`, a bool table by token id of the coordinate
  tokens, built once on the host;
- :func:`cross_entropy_skip_bbox`, the sequence CE without the coordinate
  tokens: a gather from the table on the device, then the weighted CE;
- :func:`parse_bboxes_from_tokens` and :func:`mean_sequential_iou`, the
  host-side IoU report over the '(x , y , x , y)' groups of decoded token
  strings (no gradient).
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.evalsuite.detection import box_iou_matrix
from explainable_spatial_vqa_tpu_torch.train.losses import cross_entropy

__all__ = [
    "is_bbox_token",
    "bbox_token_table",
    "cross_entropy_skip_bbox",
    "parse_bboxes_from_tokens",
    "mean_sequential_iou",
]

_BBOX_TOKEN_RE = re.compile(r"^[0-1]\.\d{3}$")
_BBOX_GROUP_RE = re.compile(
    r"\(\s*([0-1]\.\d{3})\s*,\s*([0-1]\.\d{3})\s*,\s*([0-1]\.\d{3})\s*,\s*([0-1]\.\d{3})\s*\)"
)


def is_bbox_token(token: str) -> bool:
    return bool(_BBOX_TOKEN_RE.match(token))


def bbox_token_table(idx_to_token: Mapping[int, str], vocab_size: int) -> np.ndarray:
    """bool[vocab_size]: True where the token is a box coordinate."""
    table = np.zeros(vocab_size, bool)
    for idx, token in idx_to_token.items():
        if 0 <= int(idx) < vocab_size and is_bbox_token(str(token)):
            table[int(idx)] = True
    return table


def cross_entropy_skip_bbox(logits: torch.Tensor, targets: torch.Tensor,
                            bbox_table: torch.Tensor, ignore_index: int = 0) -> torch.Tensor:
    """CE averaged over the targets that are neither coordinates nor padding.
    A target outside the table reads True, as ``jnp.take`` fills a bool
    gather out of bounds."""
    table = torch.as_tensor(bbox_table, device=logits.device)
    ids = targets.long()
    inside = (ids >= 0) & (ids < table.shape[0])
    keep = ~torch.where(inside, table[torch.where(inside, ids, 0)], True)
    return cross_entropy(logits, targets, ignore_index=ignore_index, label_weights=keep.float())


def parse_bboxes_from_tokens(token_ids: Sequence[int], idx_to_token: Mapping[int, str]
                             ) -> List[Tuple[float, float, float, float]]:
    text = " ".join(idx_to_token.get(int(t), "<UNK>") for t in token_ids)
    return [tuple(float(g) for g in m.groups()) for m in _BBOX_GROUP_RE.finditer(text)]


def mean_sequential_iou(pred_seqs: np.ndarray, gt_seqs: np.ndarray,
                        idx_to_token: Mapping[int, str]) -> Dict[str, float]:
    """Position-paired mean IoU over the parsed boxes: the i-th predicted box
    with the i-th ground-truth box, over the rows where both have boxes."""
    total, count = 0.0, 0
    for pred_row, gt_row in zip(pred_seqs, gt_seqs):
        pred = parse_bboxes_from_tokens(pred_row, idx_to_token)
        gt = parse_bboxes_from_tokens(gt_row, idx_to_token)
        if pred and gt:
            pairs = min(len(pred), len(gt))
            iou = box_iou_matrix(np.asarray(pred[:pairs]), np.asarray(gt[:pairs]))
            total += float(np.mean(np.diag(iou)))
            count += 1
    return {"mean_iou": total / count if count else 0.0, "evaluated": float(count)}
