"""Dataset assembly, copied from ``explainable_spatial_vqa_tpu/train/datasets.py``:
the step seq2seq baseline's per-step (image, src, tgt) records
(:func:`flatten_steps`), ``ChainArrays`` for chained inference
(:func:`chain_arrays`), the thesis
executor's per-step training records (:func:`executor_step_arrays`), its
per-question chain records for scheduled sampling
(:func:`executor_chain_step_arrays`), the parsers they need, and the
prototype step models' targets derived from the step records
(:func:`multihead_typed_targets`, :func:`selection_targets`,
:func:`yolo_grid_targets`)."""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np

from explainable_spatial_vqa_tpu_torch.core.vocab import canonicalize

logger = logging.getLogger(__name__)

__all__ = ["ChainArrays", "END", "MULTIHEAD_HEADS", "NON_SPATIAL_FUNCTIONS", "PAD",
           "SPECIALS_OFFSET", "START", "flatten_steps", "parse_boxes", "executor_step_arrays",
           "executor_chain_step_arrays", "chain_arrays", "multihead_typed_targets",
           "selection_targets", "yolo_grid_targets"]

# the step seq2seq baseline's specials: tokens shift by SPECIALS_OFFSET unless
# reference_compat (raw ids, id 0 both a token and the loss's ignore index)
PAD, START, END = 0, 1, 2
SPECIALS_OFFSET = 3

# CLEVR functions that emit a value token; every other function emits an
# object set, annotated as boxes (explainable_spatial_vqa_tpu/clevr/executor.py)
NON_SPATIAL_FUNCTIONS = frozenset({
    "count", "exist", "query_color", "query_shape", "query_material",
    "query_size", "equal_integer", "less_than", "greater_than", "equal_color",
    "equal_shape", "equal_size", "equal_material", "equal_object",
})


def _encode_tokens(text: str, offset: int) -> List[int]:
    return [int(tok) + offset for tok in text.split()]


def flatten_steps(
    annotated_questions: Sequence[Dict[str, Any]],
    max_src_len: int = 50,
    max_tgt_len: int = 20,
    reference_compat: bool = False,
    subset_fraction: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Flatten converted (id-string) annotated questions to step records.

    Returns {"image_index", "src", "tgt"} padded int32 arrays.  With specials
    (default), tgt = <START> tokens <END>; src/tgt token ids are shifted by
    SPECIALS_OFFSET.
    """
    offset = 0 if reference_compat else SPECIALS_OFFSET
    image_index: List[int] = []
    srcs: List[List[int]] = []
    tgts: List[List[int]] = []
    for q in annotated_questions:
        for step in q["annotated_program"]:
            tgt_text = step["output_values"].strip()
            if not tgt_text:
                continue
            src_text = (step["function"] + " " + step["input_values"]).strip()
            src = _encode_tokens(src_text, offset)[:max_src_len]
            tgt = _encode_tokens(tgt_text, offset)
            if not reference_compat:
                tgt = [START] + tgt + [END]
            tgt = tgt[:max_tgt_len]
            image_index.append(q["image_index"])
            srcs.append(src)
            tgts.append(tgt)

    total = len(srcs)
    if subset_fraction < 1.0:
        total = int(total * subset_fraction)
        image_index, srcs, tgts = image_index[:total], srcs[:total], tgts[:total]

    src_arr = np.zeros((total, max_src_len), np.int32)
    tgt_arr = np.zeros((total, max_tgt_len), np.int32)
    for i, (s, t) in enumerate(zip(srcs, tgts)):
        src_arr[i, : len(s)] = s
        tgt_arr[i, : len(t)] = t
    return {
        "image_index": np.asarray(image_index, np.int32),
        "src": src_arr,
        "tgt": tgt_arr,
    }


_BOX_RE = re.compile(r"\[([^\]]+)\]")


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


def parse_boxes(text: str) -> np.ndarray:
    """Parse '[x y x y] [x y x y] ...' into (K, 4) float32."""
    rows = []
    for group in _BOX_RE.findall(text or ""):
        values = [float(x) for x in group.split()]
        if len(values) == 4:
            rows.append(values)
    if not rows:
        return np.zeros((0, 4), np.float32)
    return np.asarray(rows, np.float32)


def _parse_question_steps(
    q: Dict[str, Any],
    function_vocab: Mapping[str, int],
    value_vocab: Mapping[str, int],
) -> List[Dict[str, Any]]:
    """Parse one annotated question into per-step records.

    Records are raw (function names, bbox strings) or vocab-converted (id
    strings; numerals pass through conversion verbatim).  ``valid`` marks the
    steps that survive the degenerate-step rules; every step is parsed so
    later steps' dependency positions stay right.
    """
    inv_function = {v: k for k, v in function_vocab.items()}
    step_outputs: List[Tuple[str, Any]] = []  # (kind, value) per step
    parsed_steps: List[Dict[str, Any]] = []
    for step in q["annotated_program"]:
        function = step["function"]
        converted = False
        unresolved = False
        if function not in function_vocab and function.strip().isdigit():
            fid = int(function)
            if fid in inv_function:
                function = inv_function[fid]
                converted = True
            else:
                # a converted record whose id this vocab does not know: keep
                # its position but never train on it
                unresolved = True
        base = function.split("[")[0]
        is_box = base not in NON_SPATIAL_FUNCTIONS
        out_text = step["output_values"].strip()

        # dependencies from the recorded ground-truth outputs
        dep_boxes: List[np.ndarray] = []
        dep_tokens: List[int] = []
        for dep in step.get("inputs", []):
            if dep >= len(step_outputs):
                continue
            kind, value = step_outputs[dep]
            if kind == "box":
                dep_boxes.append(value)
            elif kind == "token" and value >= 0:
                dep_tokens.append(value)

        target_boxes = np.zeros((0, 4), np.float32)
        if is_box:
            target_boxes = parse_boxes(out_text)
            step_outputs.append(("box", target_boxes))
            token_id = -1
        else:
            can = canonicalize(out_text)
            if converted and base != "count" and can.isdigit():
                token_id = int(can)
            else:
                token_id = value_vocab.get(can, -1)
            step_outputs.append(("token", token_id))

        valid = not (
            unresolved
            or (is_box and len(target_boxes) == 0 and out_text == "")
            or (not is_box and token_id < 0)
        )
        parsed_steps.append({
            "function": function,
            "function_id": function_vocab.get(function, 0),
            "is_box": is_box,
            "inputs": list(step.get("inputs", [])),
            "dep_boxes": dep_boxes,
            "dep_tokens": dep_tokens,
            "target_boxes": target_boxes,
            "token_id": token_id,
            "valid": valid,
        })
    return parsed_steps


def executor_step_arrays(
    annotated_questions: Sequence[Dict[str, Any]],
    function_vocab: Mapping[str, int],
    value_vocab: Mapping[str, int],
    max_input_boxes: int = 10,
    max_output_boxes: int = 10,
    subset_fraction: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Thesis-executor training records, one per valid step:

    - ``text`` (3,) int: the function id, then up to 2 value tokens from
      non-spatial dependency outputs, 0-padded, with ``text_mask``;
    - ``input_boxes`` (max_input_boxes, 4) with ``input_box_mask``: the
      dependencies' boxes, concatenated and truncated;
    - ``target_boxes`` (max_output_boxes, 4) with ``target_box_mask`` for
      spatial steps, ``token_target`` for non-spatial ones, ``is_box_branch``;
    - ``image_index``.
    """
    records: Dict[str, List[Any]] = {
        "image_index": [], "text": [], "text_mask": [], "input_boxes": [],
        "input_box_mask": [], "target_boxes": [], "target_box_mask": [],
        "token_target": [], "is_box_branch": [],
    }
    for q in annotated_questions:
        for parsed in _parse_question_steps(q, function_vocab, value_vocab):
            if not parsed["valid"]:
                continue
            dep_tokens = parsed["dep_tokens"][:2]
            text = [parsed["function_id"]] + dep_tokens + [0] * (2 - len(dep_tokens))
            text_mask = [True] * (1 + len(dep_tokens)) + [False] * (2 - len(dep_tokens))

            dep_boxes = parsed["dep_boxes"]
            boxes_in = (np.concatenate(dep_boxes, axis=0) if dep_boxes
                        else np.zeros((0, 4), np.float32))[:max_input_boxes]
            in_pad = np.zeros((max_input_boxes, 4), np.float32)
            in_pad[:len(boxes_in)] = boxes_in

            t_pad = np.zeros((max_output_boxes, 4), np.float32)
            if parsed["is_box"]:
                target = parsed["target_boxes"][:max_output_boxes]
                t_pad[:len(target)] = target
                num_targets, token_target = len(target), 0
            else:
                num_targets, token_target = 0, parsed["token_id"]

            records["image_index"].append(q["image_index"])
            records["text"].append(text)
            records["text_mask"].append(text_mask)
            records["input_boxes"].append(in_pad)
            records["input_box_mask"].append(np.arange(max_input_boxes) < len(boxes_in))
            records["target_boxes"].append(t_pad)
            records["target_box_mask"].append(np.arange(max_output_boxes) < num_targets)
            records["token_target"].append(token_target)
            records["is_box_branch"].append(parsed["is_box"])

    total = len(records["image_index"])
    total_steps = sum(len(q["annotated_program"]) for q in annotated_questions)
    if total_steps and total < total_steps // 2:
        # more than half the steps failed the parse rules: almost always a
        # vocab that does not match the annotated h5
        logger.warning(
            "executor_step_arrays: only %d of %d annotated steps are usable "
            "— check that the vocab JSONs match the annotated h5", total, total_steps)
    if subset_fraction < 1.0:
        total = int(total * subset_fraction)
    dtypes = {"image_index": np.int32, "text": np.int32, "text_mask": bool,
              "input_boxes": np.float32, "input_box_mask": bool, "target_boxes": np.float32,
              "target_box_mask": bool, "token_target": np.int32, "is_box_branch": bool}
    return {k: np.asarray(v[:total], dtypes[k]) for k, v in records.items()}


def executor_chain_step_arrays(
    annotated_questions: Sequence[Dict[str, Any]],
    function_vocab: Mapping[str, int],
    value_vocab: Mapping[str, int],
    max_steps: int = 28,
    max_output_boxes: int = 10,
    subset_fraction: float = 1.0,
) -> Dict[str, np.ndarray]:
    """Chain-structured executor training arrays, one row per QUESTION.

    Unlike :func:`executor_step_arrays` (flat teacher-forced step records),
    each question's program stays laid out over step positions, so training
    can thread dependencies through caches as chained inference does: the
    substrate of chain-level scheduled sampling (``train.scheduled``).

    Per question: ``functions`` (S,), ``deps`` (S, 2) int64 (-1 = none),
    ``num_steps``, per-step targets ``target_boxes`` (S, Q, 4) /
    ``target_box_mask`` (S, Q) / ``token_target`` (S,) / ``is_box_branch``
    (S,), and ``step_valid`` (S,) masking degenerate steps out of the loss
    (they still occupy positions so dependency indices stay aligned).
    Questions with more than ``max_steps`` steps, or none, are skipped.
    """
    records: Dict[str, List[Any]] = {k: [] for k in (
        "image_index", "functions", "deps", "num_steps", "target_boxes",
        "target_box_mask", "token_target", "is_box_branch", "step_valid",
    )}
    skipped_long = 0
    skipped_empty = 0
    for q in annotated_questions:
        parsed = _parse_question_steps(q, function_vocab, value_vocab)
        s = len(parsed)
        if s == 0 or s > max_steps:
            skipped_long += int(s > max_steps)
            skipped_empty += int(s == 0)
            continue
        functions = np.zeros(max_steps, np.int32)
        deps = np.full((max_steps, 2), -1, np.int64)
        t_boxes = np.zeros((max_steps, max_output_boxes, 4), np.float32)
        t_mask = np.zeros((max_steps, max_output_boxes), bool)
        token_target = np.zeros(max_steps, np.int32)
        is_box = np.zeros(max_steps, bool)
        valid = np.zeros(max_steps, bool)
        for k, p in enumerate(parsed):
            functions[k] = p["function_id"]
            for d, dep in enumerate(p["inputs"][:2]):
                if 0 <= dep < k:  # backwards-only, like the flat parser
                    deps[k, d] = dep
            boxes = p["target_boxes"][:max_output_boxes]
            t_boxes[k, :len(boxes)] = boxes
            t_mask[k, :len(boxes)] = True
            token_target[k] = max(p["token_id"], 0)
            is_box[k] = p["is_box"]
            valid[k] = p["valid"]
        records["image_index"].append(q["image_index"])
        records["functions"].append(functions)
        records["deps"].append(deps)
        records["num_steps"].append(s)
        records["target_boxes"].append(t_boxes)
        records["target_box_mask"].append(t_mask)
        records["token_target"].append(token_target)
        records["is_box_branch"].append(is_box)
        records["step_valid"].append(valid)
    if skipped_long or skipped_empty:
        logger.warning(
            "executor_chain_step_arrays: skipped %d questions longer than max_steps=%d and %d "
            "with zero parsed steps", skipped_long, max_steps, skipped_empty)
    total = len(records["image_index"])
    if subset_fraction < 1.0:
        total = int(total * subset_fraction)
    dtypes = {"image_index": np.int32, "num_steps": np.int32}
    return {k: np.asarray(v[:total], dtypes.get(k)) for k, v in records.items()}


def chain_arrays(
    annotated_questions: Sequence[Dict[str, Any]],
    function_vocab: Mapping[str, int],
    max_steps: int = 28,
) -> ChainArrays:
    """Raw annotated questions -> chain-execution metadata, from
    ``annotated_program``'s own functions and inputs.  Programs deeper than
    ``max_steps`` are cut and counted in ``truncated``."""
    n = len(annotated_questions)
    functions = np.zeros((n, max_steps), np.int32)
    deps = np.full((n, max_steps, 2), -1, np.int64)
    num_steps = np.zeros(n, np.int32)
    image_index = np.zeros(n, np.int32)
    answers: List[str] = []
    inv = {v: k for k, v in function_vocab.items()}
    truncated = 0
    for i, q in enumerate(annotated_questions):
        truncated += int(len(q["annotated_program"]) > max_steps)
        program = q["annotated_program"][:max_steps]
        num_steps[i] = len(program)
        image_index[i] = q["image_index"]
        answers.append(str(q.get("answer", "")))
        for s, step in enumerate(program):
            fn = step["function"]
            if fn not in function_vocab and fn.strip().isdigit() and int(fn) in inv:
                functions[i, s] = int(fn)  # vocab-converted record: already an id
            else:
                functions[i, s] = function_vocab.get(fn, 0)
            for d, dep in enumerate(step.get("inputs", [])[:2]):
                deps[i, s, d] = dep
    if truncated:
        logger.warning(
            "chain_arrays: %d questions exceed max_steps=%d and were TRUNCATED: their final "
            "step is a mid-chain value, so their answers will score wrong; raise max_steps to "
            "cover them", truncated, max_steps)
    return ChainArrays(image_index, functions, deps, num_steps, answers, truncated=truncated)


# ---------------------------------------------------------------------------
# The prototype step models' targets, from executor_step_arrays' records
# ---------------------------------------------------------------------------

MULTIHEAD_HEADS = (
    "bbox", "integer", "boolean", "size", "color", "shape", "material", "vocab"
)

_BOOLEAN_BASES = {
    "exist", "equal_color", "equal_shape", "equal_size", "equal_material",
    "equal_integer", "less_than", "greater_than",
}
_ATTR_HEAD = {
    "query_size": ("size", ("large", "small")),
    "query_color": ("color", ("gray", "red", "blue", "green", "brown",
                              "purple", "cyan", "yellow")),
    "query_shape": ("shape", ("cube", "sphere", "cylinder")),
    "query_material": ("material", ("rubber", "metal")),
}


def multihead_typed_targets(
    arrays: Dict[str, np.ndarray],
    function_vocab: Mapping[str, int],
    value_vocab: Mapping[str, int],
) -> Dict[str, np.ndarray]:
    """Each record's head and class within it for the 8-head step model:
    head_id (N,) int32, an index into :data:`MULTIHEAD_HEADS`, by the
    function's output type, and typed_target (N,) int32 (0 for the bbox
    head)."""
    inv_f = {v: k for k, v in function_vocab.items()}
    inv_v = {v: k for k, v in value_vocab.items()}
    fids = arrays["text"][:, 0]
    n = len(fids)
    head_id = np.zeros(n, np.int32)
    typed = np.zeros(n, np.int32)
    for i in range(n):
        if arrays["is_box_branch"][i]:
            head_id[i] = MULTIHEAD_HEADS.index("bbox")
            continue
        base = inv_f.get(int(fids[i]), "").split("[")[0]
        value = canonicalize(str(inv_v.get(int(arrays["token_target"][i]), "")))
        if base == "count":
            head_id[i] = MULTIHEAD_HEADS.index("integer")
            try:
                typed[i] = min(max(int(value), 0), 10)
            except ValueError:
                typed[i] = 0
        elif base in _BOOLEAN_BASES:
            head_id[i] = MULTIHEAD_HEADS.index("boolean")
            typed[i] = 1 if value == "true" else 0
        elif base in _ATTR_HEAD:
            name, classes = _ATTR_HEAD[base]
            head_id[i] = MULTIHEAD_HEADS.index(name)
            typed[i] = classes.index(value) if value in classes else 0
        else:
            head_id[i] = MULTIHEAD_HEADS.index("vocab")
            typed[i] = int(arrays["token_target"][i])
    return {"head_id": head_id, "typed_target": typed}


def selection_targets(arrays: Dict[str, np.ndarray], tol: float = 1e-4) -> np.ndarray:
    """Per-input-box membership labels of the box-selection predictor: an
    input box is selected iff it (nearly) equals some output box."""
    inp = arrays["input_boxes"]  # (N, S, 4)
    out = arrays["target_boxes"]  # (N, T, 4)
    diff = np.abs(inp[:, :, None, :] - out[:, None, :, :]).max(-1)  # (N, S, T)
    match = (diff < tol) & arrays["target_box_mask"][:, None, :]
    return (match.any(-1) & arrays["input_box_mask"]).astype(np.float32)


def yolo_grid_targets(boxes: np.ndarray, mask: np.ndarray, grid: int = 7) -> np.ndarray:
    """(N, grid, grid, 5) YOLO targets from normalized xyxy box sets: each
    valid box writes (cx_off, cy_off, w, h, 1) into its center cell."""
    n = boxes.shape[0]
    target = np.zeros((n, grid, grid, 5), np.float32)
    for i in range(n):
        for b, valid in zip(boxes[i], mask[i]):
            if not valid:
                continue
            cx = (b[0] + b[2]) * 0.5
            cy = (b[1] + b[3]) * 0.5
            col = min(int(cx * grid), grid - 1)
            row = min(int(cy * grid), grid - 1)
            target[i, row, col] = (
                cx * grid - col, cy * grid - row, b[2] - b[0], b[3] - b[1], 1.0
            )
    return target
