"""Executor step evaluation: per-function box P/R @ IoU 0.5 and token
accuracy (thesis Tables 4.3 / 4.4), and confidence calibration on predicted
chains, ported from ``explainable_spatial_vqa_tpu/evalsuite/executor_eval.py``.

:func:`evaluate_executor_steps` runs the executor over step records
(teacher-forced inputs, as the thesis per-step evaluation does) in eval mode
on the device (on the card: K2 and K1) and tallies detections per function
on the host.  The other functions are numpy on the host: they score and
calibrate the caches an :class:`~explainable_spatial_vqa_tpu_torch.infer.chain.ExecutorChainRunner`
run returns.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Tuple

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.evalsuite.detection import (
    DetectionTally,
    box_iou_matrix,
    calibrate_conf_threshold,
)
from explainable_spatial_vqa_tpu_torch.models.layers import Device, eval_mode
from explainable_spatial_vqa_tpu_torch.train.datasets import _parse_question_steps

__all__ = [
    "evaluate_executor_steps",
    "tally_predicted_chains",
    "calibrate_chain_conf_threshold",
    "calibrate_chain_conf_thresholds_per_function",
    "build_conf_threshold_vector",
]

_INPUTS = ("image", "input_boxes", "input_box_mask", "text", "text_mask")


def evaluate_executor_steps(
    model: torch.nn.Module,
    batches: Iterable[Dict[str, Any]],
    function_names: Mapping[int, str],
    conf_threshold: float = 0.5,
    iou_threshold: float = 0.5,
    device: Device = "cuda",
) -> DetectionTally:
    """``batches`` yield ``executor_step_arrays``-format dicts plus ``image``
    (numpy arrays or tensors); the model's inputs move to ``device``.

    ``function_names`` maps function-vocab ids -> fused token text (e.g.
    'filter_size[large]'); the tally keys on the base function name.
    """
    device = resolve_device(device)
    tally = DetectionTally(iou_threshold=iou_threshold)
    with torch.no_grad(), eval_mode(model):
        for batch in batches:
            out = model(*(torch.as_tensor(batch[k]).to(device) for k in _INPUTS))
            pred_boxes = out["pred_boxes"].float().cpu().numpy()
            pred_conf = out["pred_conf"].float().cpu().numpy()
            token_pred = out["token_logits"].argmax(-1).cpu().numpy()
            host = {k: np.asarray(torch.as_tensor(batch[k]).cpu()) for k in (
                "text", "is_box_branch", "target_boxes", "target_box_mask", "token_target")}
            for i in range(len(pred_boxes)):
                function = function_names.get(int(host["text"][i][0]), "unknown")
                if host["is_box_branch"][i]:
                    keep = pred_conf[i] >= conf_threshold
                    gt = host["target_boxes"][i][host["target_box_mask"][i]]
                    tally.add_box_step(function, pred_boxes[i][keep], gt)
                else:
                    tally.add_token_step(function, int(token_pred[i]),
                                         int(host["token_target"][i]))
    return tally


def _parsed_steps(annotated: Any, function_vocab: Mapping[str, int],
                  value_vocab: Mapping[str, int], max_steps: int):
    """(question row, step, parsed step) for every valid step of every
    question within ``max_steps``: the degenerate-step skips of the training
    data's parser, ``_parse_question_steps`` (one source of truth for raw
    and vocab-converted records)."""
    for i, q in enumerate(annotated):
        for k, p in enumerate(_parse_question_steps(q, function_vocab, value_vocab)[:max_steps]):
            if p["valid"]:
                yield i, k, p


def tally_predicted_chains(
    run_out: Dict[str, np.ndarray],
    annotated: Any,
    function_vocab: Mapping[str, int],
    value_vocab: Mapping[str, int],
    conf_threshold: Any = 0.5,  # float or {base function -> thr} mapping
    iou_threshold: float = 0.5,
    max_steps: int = 28,
) -> DetectionTally:
    """Per-function box P/R + token accuracy on the executor's PREDICTED
    chains (thesis Table 4.3/4.4 protocol, p.28-30): the chain runner
    executed the GT program structure, every step consuming the executor's
    own predicted boxes/tokens; each step's outputs are scored against the
    symbolic executor's ground truth for that step.

    ``run_out``: an ``ExecutorChainRunner`` run's output (box_cache,
    conf_cache, token_cache, token_branch) for chains built from the SAME
    ``annotated`` records in order.  ``conf_threshold`` is a scalar or a
    per-function mapping {base name -> thr} whose fallback is under
    ``"__global__"`` (what :func:`calibrate_chain_conf_thresholds_per_function`
    returns).
    """
    if isinstance(conf_threshold, Mapping):
        default = conf_threshold.get("__global__", 0.5)

        def _thr(fn: str) -> float:
            return conf_threshold.get(fn.split("[")[0], default)
    else:
        def _thr(fn: str) -> float:
            return conf_threshold

    tally = DetectionTally(iou_threshold=iou_threshold)
    for i, k, p in _parsed_steps(annotated, function_vocab, value_vocab, max_steps):
        if p["is_box"]:
            keep = run_out["conf_cache"][i, k] >= _thr(p["function"])
            tally.add_box_step(p["function"], run_out["box_cache"][i, k][keep],
                               p["target_boxes"])
        else:
            # a step routed to the box branch cannot produce the token
            pred = int(run_out["token_cache"][i, k]) if run_out["token_branch"][i, k] else -1
            tally.add_token_step(p["function"], pred, p["token_id"])
    return tally


def _collect_chain_detections(run_out, annotated, function_vocab, value_vocab, iou_threshold,
                              max_steps) -> Tuple[List[float], List[bool], List[str], Dict[str, int]]:
    """(confidence, is-true-positive, base function) of every chained box
    prediction, greedily matched in confidence order at threshold 0 (the
    shared front half of both calibrators), and the GT box count per base
    function (the recall denominators)."""
    confs: List[float] = []
    tps: List[bool] = []
    fns: List[str] = []
    gt_by_fn: Dict[str, int] = {}
    for i, k, p in _parsed_steps(annotated, function_vocab, value_vocab, max_steps):
        if not p["is_box"]:
            continue
        base = p["function"].split("[")[0]
        gt_boxes = p["target_boxes"]
        gt_by_fn[base] = gt_by_fn.get(base, 0) + len(gt_boxes)
        conf = run_out["conf_cache"][i, k]
        order = np.argsort(-conf)
        iou = box_iou_matrix(run_out["box_cache"][i, k][order], np.asarray(gt_boxes))
        claimed = np.zeros(len(gt_boxes), bool)
        for rank, j in enumerate(order):
            hit = False
            if len(gt_boxes):
                avail = np.where(claimed, -1.0, iou[rank])
                g = int(np.argmax(avail))
                if avail[g] >= iou_threshold:
                    claimed[g] = True
                    hit = True
            confs.append(float(conf[j]))
            tps.append(hit)
            fns.append(base)
    return confs, tps, fns, gt_by_fn


def calibrate_chain_conf_threshold(
    run_out: Dict[str, np.ndarray],
    annotated: Any,
    function_vocab: Mapping[str, int],
    value_vocab: Mapping[str, int],
    iou_threshold: float = 0.5,
    max_steps: int = 28,
) -> Tuple[float, float]:
    """F1-maximizing confidence threshold over all chained box predictions:
    (best_threshold, best_f1).  Degenerate steps are skipped with exactly
    :func:`tally_predicted_chains`'s rules, so the threshold optimizes the
    objective the tally reports."""
    confs, tps, _fns, gt_by_fn = _collect_chain_detections(
        run_out, annotated, function_vocab, value_vocab, iou_threshold, max_steps)
    if not confs:
        return 0.5, 0.0
    return calibrate_conf_threshold(np.asarray(confs), np.asarray(tps),
                                    total_gt=sum(gt_by_fn.values()))


def calibrate_chain_conf_thresholds_per_function(
    run_out: Dict[str, np.ndarray],
    annotated: Any,
    function_vocab: Mapping[str, int],
    value_vocab: Mapping[str, int],
    iou_threshold: float = 0.5,
    max_steps: int = 28,
    min_preds: int = 50,
) -> Tuple[Dict[str, float], Dict[str, float]]:
    """Per-FUNCTION F1-maximizing confidence thresholds.

    Functions differ systematically in confidence calibration: same_*
    confidences sit far below the filters', so one global bar starves their
    recall and their downstream steps.  Returns ({base function -> threshold,
    "__global__": fallback}, {base function -> f1, "__global__": global
    f1}).  Functions with fewer than ``min_preds`` predictions keep the
    global fallback."""
    confs, tps, fns, gt_by_fn = _collect_chain_detections(
        run_out, annotated, function_vocab, value_vocab, iou_threshold, max_steps)
    if not confs:
        return {"__global__": 0.5}, {"__global__": 0.0}
    confs, tps, fns = np.asarray(confs), np.asarray(tps), np.asarray(fns)
    g_thr, g_f1 = calibrate_conf_threshold(confs, tps, total_gt=sum(gt_by_fn.values()))
    thr_map = {"__global__": float(g_thr)}
    f1_map = {"__global__": float(g_f1)}
    for fn in sorted(set(fns.tolist())):
        sel = fns == fn
        if int(sel.sum()) < min_preds:
            continue
        thr, f1 = calibrate_conf_threshold(confs[sel], tps[sel], total_gt=gt_by_fn.get(fn, 0))
        thr_map[fn] = float(thr)
        f1_map[fn] = float(f1)
    return thr_map, f1_map


def build_conf_threshold_vector(
    function_vocab: Mapping[str, int],
    thr_map: Mapping[str, float],
    default: float = 0.5,
) -> np.ndarray:
    """Function-vocab-id-indexed threshold vector for the chain runners'
    ``conf_thresholds`` (per-function propagation gating).  Vocab keys are
    fused tokens (e.g. 'filter_size[large]'); thresholds key on the base
    name, falling back to thr_map['__global__'] then ``default``."""
    fallback = float(thr_map.get("__global__", default))
    size = max(function_vocab.values()) + 1
    vec = np.full(size, fallback, np.float32)
    for token, idx in function_vocab.items():
        vec[idx] = float(thr_map.get(token.split("[")[0], fallback))
    return vec
