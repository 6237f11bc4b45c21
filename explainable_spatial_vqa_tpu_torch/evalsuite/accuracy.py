"""Answer / program accuracy metrics, copied from
``explainable_spatial_vqa_tpu/evalsuite/accuracy.py``, including the CLEVR
question-type breakdown of thesis Table 4.2 (Count / Exist / Compare Number /
Compare Attribute / Query Attribute)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

__all__ = ["QUESTION_TYPE_OF_FUNCTION", "question_type", "answer_accuracy_by_type",
           "program_accuracy"]

# CLEVR question type is determined by the final program function
# (Johnson et al. 2017 protocol; thesis Table 4.2 categories).
QUESTION_TYPE_OF_FUNCTION = {
    "count": "count",
    "exist": "exist",
    "equal_integer": "compare_number",
    "less_than": "compare_number",
    "greater_than": "compare_number",
    "equal_color": "compare_attribute",
    "equal_shape": "compare_attribute",
    "equal_size": "compare_attribute",
    "equal_material": "compare_attribute",
    "query_color": "query_attribute",
    "query_shape": "query_attribute",
    "query_size": "query_attribute",
    "query_material": "query_attribute",
}


def question_type(final_function: str) -> str:
    base = final_function.split("[")[0]
    return QUESTION_TYPE_OF_FUNCTION.get(base, "other")


def answer_accuracy_by_type(
    pred_answers: Sequence,
    gt_answers: Sequence,
    final_functions: Sequence[str],
) -> Dict[str, float]:
    """Overall + per-question-type accuracy (thesis Table 4.2 row format)."""
    pred = np.asarray(pred_answers)
    gt = np.asarray(gt_answers)
    correct = pred == gt
    out: Dict[str, float] = {"overall": float(correct.mean()) if len(gt) else 0.0}
    types = np.asarray([question_type(f) for f in final_functions])
    for t in ("count", "exist", "compare_number", "compare_attribute", "query_attribute"):
        sel = types == t
        out[t] = float(correct[sel].mean()) if sel.any() else 0.0
    return out


def program_accuracy(
    pred_programs: np.ndarray,
    gt_programs: np.ndarray,
    pad_id: int = 0,
) -> Dict[str, float]:
    """Exact-match and token accuracy.

    ``exact_match``/``token_acc`` compare all positions (reference semantics,
    train_transformer_iqap.py:331-337); ``token_acc_nonpad`` masks padding.
    """
    pred = np.asarray(pred_programs)
    gt = np.asarray(gt_programs)
    eq = pred == gt
    nonpad = gt != pad_id
    return {
        "exact_match": float(eq.all(axis=-1).mean()) if len(gt) else 0.0,
        "token_acc": float(eq.mean()) if eq.size else 0.0,
        "token_acc_nonpad": float(eq[nonpad].mean()) if nonpad.any() else 0.0,
    }
