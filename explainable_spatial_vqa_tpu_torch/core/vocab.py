"""Vocabulary helpers, copied from ``explainable_spatial_vqa_tpu/core/vocab.py``:
only what the training pipelines read."""

from __future__ import annotations

import json
from typing import Any, Dict

__all__ = ["load_vocab", "canonicalize"]


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
