"""Annotated-string preprocessing, the third vocabulary scheme, copied from
``explainable_spatial_vqa_tpu/core/annotated_strings.py``.

It reads single-string annotated questions (``annotated_program_string``,
from :func:`~explainable_spatial_vqa_tpu_torch.clevr.annotate.annotate_question_string`)
and builds one joint vocabulary, <PAD>=0 and <UNK>=1 followed by the
*sorted* tokens, and the fixed-length id arrays of ``mapped_sequences.h5``:

- question and answer: whitespace tokens;
- program string: '|' spaced out, each chunk split again keeping the
  delimiters ``( ) , : ;`` as tokens of their own, so a 3-decimal
  coordinate stays one token;
- arrays: <PAD>-padded or cut to fixed lengths.

``h5py`` is imported inside the two h5 functions only.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np

__all__ = [
    "parse_program_string",
    "build_string_vocab",
    "tokens_to_ids",
    "build_mapped_sequences",
    "write_mapped_sequences",
    "read_mapped_sequences",
]

PAD_TOKEN, UNK_TOKEN = "<PAD>", "<UNK>"

_DELIM_RE = re.compile(r"([\(\),:;])")


def parse_program_string(program_str: str) -> List[str]:
    """Tokenize an annotated program string."""
    line = program_str.replace("|", " | ")
    tokens: List[str] = []
    for chunk in line.split():
        for part in _DELIM_RE.split(chunk):
            part = part.strip()
            if part:
                tokens.append(part)
    return tokens


def build_string_vocab(
    questions: Sequence[Dict[str, Any]],
) -> Tuple[Dict[str, int], List[List[str]], List[List[str]], List[List[str]], List[int]]:
    """Records -> (token_to_id, question, answer and program tokens, image indices)."""
    token_set: set = set()
    q_tokens: List[List[str]] = []
    a_tokens: List[List[str]] = []
    p_tokens: List[List[str]] = []
    image_indices: List[int] = []
    for q in questions:
        image_indices.append(q["image_index"])
        qs = q["question"].strip().split()
        ans = str(q["answer"]).strip().split()
        prog = parse_program_string(q["annotated_program_string"])
        token_set.update(qs)
        token_set.update(ans)
        token_set.update(prog)
        q_tokens.append(qs)
        a_tokens.append(ans)
        p_tokens.append(prog)

    token_to_id: Dict[str, int] = {PAD_TOKEN: 0, UNK_TOKEN: 1}
    for token in sorted(token_set):
        token_to_id[token] = len(token_to_id)
    return token_to_id, q_tokens, a_tokens, p_tokens, image_indices


def tokens_to_ids(rows: Sequence[Sequence[str]], token_to_id: Mapping[str, int],
                  max_len: int) -> np.ndarray:
    pad = token_to_id[PAD_TOKEN]
    unk = token_to_id[UNK_TOKEN]
    out = np.full((len(rows), max_len), pad, np.int32)
    for i, tokens in enumerate(rows):
        ids = [token_to_id.get(t, unk) for t in tokens][:max_len]
        out[i, : len(ids)] = ids
    return out


def build_mapped_sequences(
    questions: Sequence[Dict[str, Any]],
    max_question_len: int = 20,
    max_answer_len: int = 5,
    max_program_len: int = 100,
) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    token_to_id, qs, ans, progs, image_idx = build_string_vocab(questions)
    arrays = {
        "image_index": np.asarray(image_idx, np.int32),
        "question_tokens": tokens_to_ids(qs, token_to_id, max_question_len),
        "answer_tokens": tokens_to_ids(ans, token_to_id, max_answer_len),
        "program_tokens": tokens_to_ids(progs, token_to_id, max_program_len),
    }
    return arrays, token_to_id


def write_mapped_sequences(arrays: Mapping[str, np.ndarray], path: str) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        for key, value in arrays.items():
            f.create_dataset(key, data=value)


def read_mapped_sequences(path: str) -> Dict[str, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f.keys()}
