"""Vocabularies, copied from ``explainable_spatial_vqa_tpu/core/vocab.py``:

1. the CLEVR three-way vocab (question / fused-program / answer),
   insertion-ordered with the specials 0-3 (:func:`build_clevr_vocab`);
2. the function/other split vocab over annotated step records, bbox text
   excluded and booleans canonicalized (:func:`build_split_vocab`,
   :func:`apply_split_vocab`);

3. the joint vocab over annotated step records, bbox-coordinate tokens
   included, read by the step seq2seq baseline (:func:`build_joint_vocab`,
   :func:`apply_joint_vocab`);
4. the joint vocab with bbox-only texts excluded, the CLEVR reference's
   ``continous`` v1/v2 scheme (:func:`build_joint_noboxes_vocab`,
   :func:`apply_joint_noboxes_vocab`);

and the helpers the pipelines and the CLI read and write
(:func:`load_vocab`, :func:`save_vocab`).
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, Iterable, List, Mapping, Sequence

from explainable_spatial_vqa_tpu_torch.core.tokenizer import SPECIAL_TOKENS, word_tokenize

__all__ = ["EMPTY_TOKEN", "apply_joint_noboxes_vocab", "apply_joint_vocab", "apply_split_vocab",
           "build_clevr_vocab", "build_joint_noboxes_vocab", "build_joint_vocab",
           "build_split_vocab",
           "canonicalize", "invert_vocab", "is_bounding_box_text", "load_vocab",
           "save_vocab", "tokenize_field"]


def invert_vocab(token_to_idx: Mapping[str, int]) -> Dict[int, str]:
    return {int(v): k for k, v in token_to_idx.items()}


def load_vocab(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_vocab(vocab: Mapping[str, Any], path: str) -> None:
    """Write ``vocab`` as the JAX package's files hold it: JSON, indent 4."""
    with open(path, "w", encoding="utf-8") as f:
        json.dump(vocab, f, indent=4)


def build_clevr_vocab(
    question_collections: Iterable[Sequence[Dict[str, Any]]],
) -> Dict[str, Dict[str, int]]:
    """Build the {program, question, answer} vocab from CLEVR question lists.

    ``question_collections`` is an iterable of question-record lists (the
    reference iterates val, test, train in that order; pass collections in
    the same order for the same index assignment).

    Program tokens are the fused ``function[value]`` form, one entry per
    (function, value_input) pair.  Question tokens come from the regex word
    tokenizer, lowercased.
    All three vocabs start with specials <NULL>=0 <START>=1 <END>=2 <UNK>=3.
    """
    program: Dict[str, int] = dict(SPECIAL_TOKENS)
    answer: Dict[str, int] = dict(SPECIAL_TOKENS)
    question: Dict[str, int] = dict(SPECIAL_TOKENS)

    for questions in question_collections:
        for q in questions:
            for item in q.get("program", []):
                fn = item.get("function", "undefined_function")
                values = item.get("value_inputs") or []
                if values:
                    for value in values:
                        key = f"{fn}[{value}]"
                        if key not in program:
                            program[key] = len(program)
                else:
                    if fn not in program:
                        program[fn] = len(program)
            if "answer" in q and q["answer"] not in answer:
                answer[q["answer"]] = len(answer)
            if "question" in q:
                for word in word_tokenize(q["question"]):
                    word = word.lower()
                    if word not in question:
                        question[word] = len(question)

    return {
        "program_token_to_idx": program,
        "question_token_to_idx": question,
        "answer_token_to_idx": answer,
    }


EMPTY_TOKEN = "<EMPTY>"

# One bracketed 4-float group; a text is "bbox text" iff it is exactly a
# space-joined sequence of such groups.
_BBOX_GROUP_RE = re.compile(r"\[\d+\.\d+\s+\d+\.\d+\s+\d+\.\d+\s+\d+\.\d+\]")
_FIELD_TOKEN_RE = re.compile(r"\[|\]|[^\[\]\s]+")


def canonicalize(token: str) -> str:
    """yes/true -> 'true', no/false -> 'false' (case-insensitive), else as-is."""
    low = token.lower()
    if low in ("yes", "true"):
        return "true"
    if low in ("no", "false"):
        return "false"
    return token


def tokenize_field(text: str, field: str) -> List[str]:
    """Function fields are single tokens; others split on brackets/whitespace."""
    if field == "function":
        return [text] if text else []
    return _FIELD_TOKEN_RE.findall(text)


def is_bounding_box_text(text: str) -> bool:
    matches = _BBOX_GROUP_RE.findall(text)
    if not matches:
        return False
    return " ".join(matches).strip() == text.strip()


def build_joint_vocab(
    annotated_questions: Sequence[Dict[str, Any]],
) -> Dict[str, int]:
    """Single joint vocab over annotated records, bbox-coordinate tokens
    included (the ``full_annotation`` scheme consumed by the step-executor
    trainer; preprocess_full_annotation.py:378-403).  Indexing starts at 0,
    no reserved specials — the reference overloads id 0 as CE ignore_index.
    Chain elements contribute both function and the step-index digits.
    """
    vocab: Dict[str, int] = {}

    def add(text: str, field: str) -> None:
        for token in tokenize_field(text, field):
            token = canonicalize(token)
            if token not in vocab:
                vocab[token] = len(vocab)

    for q in annotated_questions:
        add(q.get("answer", ""), "other")
        for chain in q.get("final_chain_of_thought", []):
            parts = chain.split(maxsplit=1)
            add(parts[0] if parts else "", "function")
            if len(parts) > 1:
                add(parts[1], "other")
        for step in q.get("annotated_program", []):
            add(step.get("function", ""), "function")
            add(step.get("input_values", ""), "other")
            add(step.get("output_values", ""), "other")
    return vocab


def apply_joint_vocab(
    annotated_q: Dict[str, Any], vocab: Mapping[str, int]
) -> Dict[str, Any]:
    """Convert texts to joint-vocab id strings in place; unknown tokens are
    silently dropped (preprocess_full_annotation.py:405-426)."""

    def convert(text: str, field: str) -> str:
        out: List[str] = []
        for token in tokenize_field(text, field):
            can = canonicalize(token)
            if can in vocab:
                out.append(str(vocab[can]))
        return " ".join(out)

    annotated_q["answer"] = convert(annotated_q.get("answer", ""), "other")

    def convert_chain(chain: str) -> str:
        parts = chain.split(maxsplit=1)
        func = convert(parts[0] if parts else "", "function")
        rest = convert(parts[1], "other") if len(parts) > 1 else ""
        return f"{func} {rest}".strip() if rest else func

    annotated_q["final_chain_of_thought"] = [
        convert_chain(c) for c in annotated_q.get("final_chain_of_thought", [])
    ]
    for step in annotated_q.get("annotated_program", []):
        step["function"] = convert(step.get("function", ""), "function")
        step["input_values"] = convert(step.get("input_values", ""), "other")
        step["output_values"] = convert(step.get("output_values", ""), "other")
    return annotated_q


def build_split_vocab(
    annotated_questions: Sequence[Dict[str, Any]],
) -> Dict[str, Dict[str, int]]:
    """Build {'function': .., 'other': ..} vocabs from annotated questions.

    Index assignment order matches the reference: per question — answer,
    then each
    chain element's function part, then each step's function / input_values /
    output_values; bbox-only texts contribute nothing; EMPTY_TOKEN is
    guaranteed present in 'other'.
    """
    vocab_function: Dict[str, int] = {}
    vocab_other: Dict[str, int] = {}

    def add(text: str, field: str) -> None:
        if is_bounding_box_text(text):
            return
        target = vocab_function if field == "function" else vocab_other
        for token in tokenize_field(text, field):
            token = canonicalize(token)
            if token not in target:
                target[token] = len(target)

    for q in annotated_questions:
        add(q.get("answer", ""), "other")
        for chain in q.get("final_chain_of_thought", []):
            parts = chain.split(maxsplit=1)
            add(parts[0] if parts else "", "function")
        for step in q.get("annotated_program", []):
            add(step.get("function", ""), "function")
            add(step.get("input_values", ""), "other")
            add(step.get("output_values", ""), "other")

    if EMPTY_TOKEN not in vocab_other:
        vocab_other[EMPTY_TOKEN] = len(vocab_other)
    return {"function": vocab_function, "other": vocab_other}


def apply_split_vocab(
    annotated_q: Dict[str, Any], vocabs: Mapping[str, Mapping[str, int]]
) -> Dict[str, Any]:
    """Convert one annotated question's texts to id strings, in place.

    Numeric tokens (bbox coordinates) pass through verbatim; empty converted
    fields become the EMPTY_TOKEN id; chain elements convert only their
    function part.
    """
    vocab_function = vocabs["function"]
    vocab_other = vocabs["other"]

    def convert(text: str, field: str) -> str:
        out: List[str] = []
        for token in tokenize_field(text, field):
            can = canonicalize(token)
            if field == "other" and token.replace(".", "", 1).isdigit():
                out.append(token)
            elif field == "function":
                if can in vocab_function:
                    out.append(str(vocab_function[can]))
            else:
                if can in vocab_other:
                    out.append(str(vocab_other[can]))
        return " ".join(out)

    annotated_q["answer"] = convert(annotated_q.get("answer", ""), "other")

    def convert_chain(chain: str) -> str:
        parts = chain.split(maxsplit=1)
        func = convert(parts[0] if parts else "", "function")
        rest = parts[1] if len(parts) > 1 else ""
        return f"{func} {rest}".strip() if rest else func

    annotated_q["final_chain_of_thought"] = [
        convert_chain(c) for c in annotated_q.get("final_chain_of_thought", [])
    ]

    for step in annotated_q.get("annotated_program", []):
        step["function"] = convert(step.get("function", ""), "function")
        for key in ("input_values", "output_values"):
            value = step.get(key, "")
            if is_bounding_box_text(value):
                step[key] = value
            else:
                converted = convert(value, "other")
                if not converted.strip():
                    converted = convert(EMPTY_TOKEN, "other")
                step[key] = converted

    return annotated_q


def build_joint_noboxes_vocab(annotated_questions: Sequence[Dict[str, Any]]) -> Dict[str, int]:
    """Single joint vocab with bbox-only texts excluded, the ``continous``
    v1/v2 scheme (preprocess_continous.py:378-403; v2 is code-identical).
    Chain elements contribute function + (non-bbox) rest tokens.
    """
    vocab: Dict[str, int] = {}

    def add(text: str, field: str) -> None:
        if is_bounding_box_text(text):
            return
        for token in tokenize_field(text, field):
            token = canonicalize(token)
            if token not in vocab:
                vocab[token] = len(vocab)

    for q in annotated_questions:
        add(q.get("answer", ""), "other")
        for chain in q.get("final_chain_of_thought", []):
            parts = chain.split(maxsplit=1)
            add(parts[0] if parts else "", "function")
            if len(parts) > 1:
                add(parts[1], "other")
        for step in q.get("annotated_program", []):
            add(step.get("function", ""), "function")
            add(step.get("input_values", ""), "other")
            add(step.get("output_values", ""), "other")
    return vocab


def apply_joint_noboxes_vocab(annotated_q: Dict[str, Any],
                              vocab: Mapping[str, int]) -> Dict[str, Any]:
    """Convert texts to id strings (v1/v2 scheme): bbox texts pass through
    verbatim, unknown tokens are silently dropped
    (preprocess_continous.py:405-441)."""

    def convert(text: str, field: str) -> str:
        return " ".join(str(vocab[canonicalize(t)]) for t in tokenize_field(text, field)
                        if canonicalize(t) in vocab)

    annotated_q["answer"] = convert(annotated_q.get("answer", ""), "other")

    def convert_chain(chain: str) -> str:
        parts = chain.split(maxsplit=1)
        func = convert(parts[0] if parts else "", "function")
        rest = parts[1] if len(parts) > 1 else ""
        if rest and not is_bounding_box_text(rest):
            rest = convert(rest, "other")
        return f"{func} {rest}".strip() if rest else func

    annotated_q["final_chain_of_thought"] = [
        convert_chain(c) for c in annotated_q.get("final_chain_of_thought", [])
    ]
    for step in annotated_q.get("annotated_program", []):
        step["function"] = convert(step.get("function", ""), "function")
        for key in ("input_values", "output_values"):
            value = step.get(key, "")
            step[key] = value if is_bounding_box_text(value) else convert(value, "other")
    return annotated_q
