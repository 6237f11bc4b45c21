"""Readers of the training artifacts, copied from
``explainable_spatial_vqa_tpu/core/artifacts.py``: the questions h5
(``questions (N, Lq) int32``, ``programs (N, Lp) int32``, ``answers``,
``image_idxs``, ``orig_idxs``, optional ``question_families``), the annotated
questions h5 (one ``questions`` JSON blob, or one ``q_{i}`` JSON dataset per
question) and the features h5 (``features`` (N, 1024, 14, 14) float32).

``h5py`` is imported inside the readers: only they need it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["EncodedQuestions", "read_questions_h5", "read_annotated_h5", "H5Features"]


@dataclass
class EncodedQuestions:
    """In-memory form of the questions h5 artifact."""

    questions: np.ndarray  # (N, Lq) int32, <NULL>-padded
    image_idxs: np.ndarray  # (N,) int
    orig_idxs: np.ndarray  # (N,) int
    programs: Optional[np.ndarray] = None  # (N, Lp) int32
    answers: Optional[np.ndarray] = None  # (N,) int
    question_families: Optional[np.ndarray] = None  # (N,) int


def read_questions_h5(path: str) -> EncodedQuestions:
    import h5py

    with h5py.File(path, "r") as f:
        return EncodedQuestions(
            questions=f["questions"][()].astype(np.int32),
            image_idxs=f["image_idxs"][()],
            orig_idxs=f["orig_idxs"][()] if "orig_idxs" in f else np.arange(f["questions"].shape[0]),
            programs=f["programs"][()].astype(np.int32) if "programs" in f else None,
            answers=f["answers"][()] if "answers" in f else None,
            question_families=f["question_families"][()] if "question_families" in f else None,
        )


def read_annotated_h5(path: str) -> List[Dict[str, Any]]:
    import h5py

    def text(blob):
        return blob.decode("utf-8") if isinstance(blob, bytes) else blob

    with h5py.File(path, "r") as f:
        if "questions" in f:
            return json.loads(text(f["questions"][()]))["questions"]
        out: List[Dict[str, Any]] = []
        while f"q_{len(out)}" in f:
            out.append(json.loads(text(f[f"q_{len(out)}"][()])))
        return out


class H5Features:
    """The features h5's ``features`` (N, C, H, W), read by image index as
    (B, H*W, C) float32 tokens.  The file stays open until :meth:`close`."""

    def __init__(self, path: str):
        import h5py

        self._file = h5py.File(path, "r")
        self._features = self._file["features"]

    def __getitem__(self, idx: np.ndarray) -> np.ndarray:
        feats = np.stack([self._features[int(i)] for i in idx]).astype(np.float32)
        n, c, h, w = feats.shape
        return feats.reshape(n, c, h * w).transpose(0, 2, 1)

    def close(self) -> None:
        self._file.close()
