"""Special tokens, copied from ``explainable_spatial_vqa_tpu/core/tokenizer.py``."""

from __future__ import annotations

from typing import Dict

__all__ = ["SPECIAL_TOKENS", "NULL", "START", "END", "UNK"]

NULL, START, END, UNK = "<NULL>", "<START>", "<END>", "<UNK>"

SPECIAL_TOKENS: Dict[str, int] = {NULL: 0, START: 1, END: 2, UNK: 3}
