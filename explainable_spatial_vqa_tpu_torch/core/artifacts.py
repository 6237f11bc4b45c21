"""Every disk artifact of the pipeline, copied from
``explainable_spatial_vqa_tpu/core/artifacts.py`` with the same datasets,
types and layouts, so each package reads the other's files:

- the question and scene JSONs (:func:`load_questions_json`,
  :func:`load_scenes_json`);
- the questions h5 (``questions (N, Lq) int32``, ``programs (N, Lp) int32``,
  ``answers``, ``image_idxs``, ``orig_idxs``, optional
  ``question_families``): :func:`encode_questions`,
  :func:`write_questions_h5`, :func:`read_questions_h5`;
- the features h5 (``features`` (N, 1024, 14, 14) float32):
  :class:`FeatureWriter`, :func:`read_features`, :class:`H5Features`;
- the scenes h5 (per-image boxes (N, K, 4) float32, class labels (N, K)
  int32, image indices, vlen-bytes file names): :func:`write_scenes_h5`,
  :func:`read_scenes_h5`;
- the annotated questions h5 (one ``questions`` JSON blob, or one ``q_{i}``
  JSON dataset per question): :func:`write_annotated_h5`,
  :func:`read_annotated_h5`.

``h5py`` is imported inside the functions that need it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from explainable_spatial_vqa_tpu_torch.core import programs as prog
from explainable_spatial_vqa_tpu_torch.core.tokenizer import encode, tokenize

__all__ = ["EncodedQuestions", "FeatureWriter", "H5Features", "encode_questions",
           "load_questions_json", "load_scenes_json", "read_annotated_h5", "read_features",
           "read_questions_h5", "read_scenes_h5", "write_annotated_h5", "write_questions_h5",
           "write_scenes_h5"]


def load_questions_json(path: str) -> List[Dict[str, Any]]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)["questions"]


def load_scenes_json(path: str) -> List[Dict[str, Any]]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)["scenes"]


@dataclass
class EncodedQuestions:
    """In-memory form of the questions h5 artifact."""

    questions: np.ndarray  # (N, Lq) int32, <NULL>-padded
    image_idxs: np.ndarray  # (N,) int
    orig_idxs: np.ndarray  # (N,) int
    programs: Optional[np.ndarray] = None  # (N, Lp) int32
    answers: Optional[np.ndarray] = None  # (N,) int
    question_families: Optional[np.ndarray] = None  # (N,) int


def encode_questions(
    questions: Sequence[Dict[str, Any]],
    vocab: Dict[str, Dict[str, int]],
    mode: str = "postfix",
    allow_unk: bool = False,
) -> EncodedQuestions:
    """Tokenize+encode CLEVR question records to padded id arrays.

    Question text keeps ';' ',' and strips '?' '.'; programs are linearized in
    ``mode`` then fused-tokenized; both get <START>/<END> and right-padding
    with <NULL>=0, as the questions h5 holds them.
    """
    q_vocab = vocab["question_token_to_idx"]
    p_vocab = vocab["program_token_to_idx"]
    a_vocab = vocab["answer_token_to_idx"]

    questions_encoded: List[List[int]] = []
    programs_encoded: List[List[int]] = []
    question_families: List[int] = []
    orig_idxs: List[int] = []
    image_idxs: List[int] = []
    answers: List[int] = []

    for orig_idx, q in enumerate(questions):
        orig_idxs.append(orig_idx)
        image_idxs.append(q["image_index"])
        if "question_family_index" in q:
            question_families.append(q["question_family_index"])
        tokens = tokenize(q["question"], punct_to_keep=[";", ","], punct_to_remove=["?", "."])
        questions_encoded.append(encode(tokens, q_vocab, allow_unk=allow_unk))
        if "program" in q:
            program_str = prog.program_to_str(q["program"], mode)
            program_tokens = tokenize(program_str)
            programs_encoded.append(encode(program_tokens, p_vocab, allow_unk=allow_unk))
        if "answer" in q:
            answers.append(a_vocab[q["answer"]])

    def pad(rows: List[List[int]]) -> np.ndarray:
        if not rows:
            return np.zeros((0, 0), dtype=np.int32)
        max_len = max(len(r) for r in rows)
        out = np.zeros((len(rows), max_len), dtype=np.int32)
        for i, r in enumerate(rows):
            out[i, : len(r)] = r
        return out

    return EncodedQuestions(
        questions=pad(questions_encoded),
        image_idxs=np.asarray(image_idxs),
        orig_idxs=np.asarray(orig_idxs),
        programs=pad(programs_encoded) if programs_encoded else None,
        answers=np.asarray(answers) if answers else None,
        question_families=np.asarray(question_families) if question_families else None,
    )


def write_questions_h5(encoded: EncodedQuestions, path: str) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("questions", data=encoded.questions)
        f.create_dataset("image_idxs", data=encoded.image_idxs)
        f.create_dataset("orig_idxs", data=encoded.orig_idxs)
        if encoded.programs is not None and encoded.programs.size:
            f.create_dataset("programs", data=encoded.programs)
        if encoded.question_families is not None and encoded.question_families.size:
            f.create_dataset("question_families", data=encoded.question_families)
        if encoded.answers is not None and encoded.answers.size:
            f.create_dataset("answers", data=encoded.answers)


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


def write_scenes_h5(path: str, bounding_boxes: np.ndarray, class_labels: np.ndarray,
                    image_index: np.ndarray, image_filenames: Sequence[str]) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("bounding_boxes", data=np.asarray(bounding_boxes, dtype=np.float32))
        f.create_dataset("class_labels", data=np.asarray(class_labels, dtype=np.int32))
        f.create_dataset("image_index", data=np.asarray(image_index, dtype=np.int32))
        dset = f.create_dataset("image_filename", (len(image_filenames),),
                                dtype=h5py.special_dtype(vlen=bytes))
        dset[...] = [s.encode("utf8") for s in image_filenames]


def read_scenes_h5(path: str) -> Dict[str, Any]:
    """The scenes h5's per-image boxes (N, K, 4), class labels (N, K), image
    indices and file names (the bbox-head IQAP variant's targets)."""
    import h5py

    with h5py.File(path, "r") as f:
        return {
            "bounding_boxes": f["bounding_boxes"][()],
            "class_labels": f["class_labels"][()],
            "image_index": f["image_index"][()],
            "image_filename": [s.decode("utf8") for s in f["image_filename"][()]],
        }


def write_annotated_h5(annotated_questions: Sequence[Dict[str, Any]], path: str,
                       layout: str = "blob") -> None:
    """``layout="blob"``: one ``questions`` dataset holding ``{"questions":
    [...]}`` JSON, the executor-training input; ``"per_question"``: one
    ``q_{i}`` JSON string dataset per question."""
    import h5py

    dt = h5py.string_dtype(encoding="utf-8")
    with h5py.File(path, "w") as f:
        if layout == "blob":
            f.create_dataset("questions", data=json.dumps({"questions": list(annotated_questions)}),
                             dtype=dt)
        elif layout == "per_question":
            for i, q in enumerate(annotated_questions):
                f.create_dataset(f"q_{i}", data=json.dumps(q), dtype=dt)
        else:
            raise ValueError(f"unknown layout {layout!r}")


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


class FeatureWriter:
    """Streaming writer of the features h5: the ``total``-row float32
    dataset is created at the first batch, from its shape."""

    def __init__(self, path: str, total: int, dataset: str = "features"):
        import h5py

        self._file = h5py.File(path, "w")
        self._dataset_name = dataset
        self._total = total
        self._dset = None
        self._cursor = 0

    def append(self, feats: np.ndarray) -> None:
        feats = np.asarray(feats, dtype=np.float32)
        if self._dset is None:
            self._dset = self._file.create_dataset(
                self._dataset_name, (self._total,) + feats.shape[1:], dtype=np.float32)
        end = self._cursor + feats.shape[0]
        self._dset[self._cursor:end] = feats
        self._cursor = end

    def close(self) -> None:
        self._file.close()

    def __enter__(self) -> "FeatureWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def read_features(path: str, indices: Optional[Sequence[int]] = None) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        dset = f["features"]
        if indices is None:
            return dset[()]
        return np.stack([dset[int(i)] for i in indices])


class H5Features:
    """The features h5's ``features`` (N, C, H, W), read by image index as
    (B, H*W, C) float32 tokens, or with ``as_tokens=False`` as the (B, C, H,
    W) grid.  The file stays open until :meth:`close`."""

    def __init__(self, path: str, as_tokens: bool = True):
        import h5py

        self._file = h5py.File(path, "r")
        self._features = self._file["features"]
        self.as_tokens = as_tokens

    def __getitem__(self, idx: np.ndarray) -> np.ndarray:
        feats = np.stack([self._features[int(i)] for i in idx]).astype(np.float32)
        if not self.as_tokens:
            return feats
        n, c, h, w = feats.shape
        return feats.reshape(n, c, h * w).transpose(0, 2, 1)

    def close(self) -> None:
        self._file.close()
