"""``ChainArrays``, copied from ``explainable_spatial_vqa_tpu/train/datasets.py``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

__all__ = ["ChainArrays"]


@dataclass
class ChainArrays:
    """Per-question static chain metadata for vectorized inference."""

    image_index: np.ndarray  # (N,)
    functions: np.ndarray  # (N, S) function-vocab ids, 0-padded
    deps: np.ndarray  # (N, S, 2) dependency step indices, -1 = absent
    num_steps: np.ndarray  # (N,)
    answers: List[str]  # raw answer strings (for eval)
    # programs deeper than the serving bound whose tails were dropped (their
    # final step then reads a mid-chain value)
    truncated: int = 0
