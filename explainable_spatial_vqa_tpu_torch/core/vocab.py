"""Vocabulary helpers, copied from ``explainable_spatial_vqa_tpu/core/vocab.py``:
only what the training pipelines and the CLI read."""

from __future__ import annotations

import json
from typing import Any, Dict, Mapping

__all__ = ["load_vocab", "invert_vocab", "canonicalize"]


def invert_vocab(token_to_idx: Mapping[str, int]) -> Dict[int, str]:
    return {int(v): k for k, v in token_to_idx.items()}


def load_vocab(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def canonicalize(token: str) -> str:
    """yes/true -> 'true', no/false -> 'false' (case-insensitive), else as-is."""
    low = token.lower()
    if low in ("yes", "true"):
        return "true"
    if low in ("no", "false"):
        return "false"
    return token
