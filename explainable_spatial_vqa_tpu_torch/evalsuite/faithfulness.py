"""Faithfulness quadrant tally, copied from
``explainable_spatial_vqa_tpu/evalsuite/faithfulness.py``.

Per sample, (predicted answer vs GT) x (predicted program vs GT) falls in one
of four quadrants: CPCA / CPIA / IPCA / IPIA (thesis Table 4.5 p.31).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

__all__ = ["FaithfulnessTally", "tally_faithfulness"]


@dataclass
class FaithfulnessTally:
    both_correct: int = 0  # CP CA
    program_only: int = 0  # CP IA
    answer_only: int = 0  # IP CA
    neither: int = 0  # IP IA

    @property
    def total(self) -> int:
        return self.both_correct + self.program_only + self.answer_only + self.neither

    def as_fractions(self) -> Dict[str, float]:
        t = max(self.total, 1)
        return {
            "correct_program_correct_answer": self.both_correct / t,
            "correct_program_incorrect_answer": self.program_only / t,
            "incorrect_program_correct_answer": self.answer_only / t,
            "incorrect_program_incorrect_answer": self.neither / t,
        }

    def report(self) -> str:
        f = self.as_fractions()
        lines = [f"Faithfulness over {self.total} samples:"]
        lines += [f"  {k}: {v:.4f}" for k, v in f.items()]
        return "\n".join(lines)


def tally_faithfulness(
    pred_answers: np.ndarray,
    gt_answers: np.ndarray,
    pred_programs: np.ndarray,
    gt_programs: np.ndarray,
    program_mask: Optional[np.ndarray] = None,
) -> FaithfulnessTally:
    """Answers (N,) int/str; programs (N, L) token ids.

    Program correctness is exact match over ``program_mask`` positions (all
    positions when None).  Programs of different widths are zero-padded to a
    common width; positions past the mask's width compare normally.
    """
    pred_answers = np.asarray(pred_answers)
    gt_answers = np.asarray(gt_answers)
    answer_ok = pred_answers == gt_answers
    pred_programs = np.asarray(pred_programs)
    gt_programs = np.asarray(gt_programs)
    width = max(pred_programs.shape[1], gt_programs.shape[1])

    def pad(arr):
        if arr.shape[1] == width:
            return arr
        return np.pad(arr, ((0, 0), (0, width - arr.shape[1])))

    pred_programs, gt_programs = pad(pred_programs), pad(gt_programs)
    eq = pred_programs == gt_programs
    if program_mask is not None:
        mask = np.asarray(program_mask)
        if mask.shape[1] < width:
            mask = np.pad(
                mask, ((0, 0), (0, width - mask.shape[1])),
                constant_values=True,
            )
        eq = np.where(mask, eq, True)
    program_ok = eq.all(axis=-1)

    tally = FaithfulnessTally()
    tally.both_correct = int(np.sum(answer_ok & program_ok))
    tally.program_only = int(np.sum(~answer_ok & program_ok))
    tally.answer_only = int(np.sum(answer_ok & ~program_ok))
    tally.neither = int(np.sum(~answer_ok & ~program_ok))
    return tally
