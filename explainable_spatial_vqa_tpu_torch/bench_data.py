"""CLEVR-shaped synthetic data at full width, made from a seed with numpy.

:func:`synth_questions` is a numpy-only copy of ``bench.py:83-180``: programs
drawn from CLEVR's structural question families (filter chains, relate and
same_* hops, two-branch attribute and number comparisons joined by a
2-input node), with depths up to 27 steps.  Given the same seed this draws
the same features, questions, depths and dependencies as
``bench.synth_questions``.  Function ids come from a fixed table,
:data:`FUNCTION_IDS` (1-based), where the bench numbers names in order of
first appearance in the process; the names behind the ids agree.

The training and evaluation sets are built on those programs:
:func:`synth_generator_batch` (questions and postfix programs, the questions
h5's layout), :func:`synth_executor_steps` (one record per program step,
``executor_step_arrays``' layout, with random image features) and
:func:`synth_annotated` (raw annotated questions, the annotated h5's layout,
which ``chain_arrays`` and ``executor_chain_step_arrays`` parse).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, GeneratorConfig
from explainable_spatial_vqa_tpu_torch.train.datasets import NON_SPATIAL_FUNCTIONS, ChainArrays

__all__ = ["synth_questions", "FUNCTION_IDS", "PROGRAM_TOKENS", "VALUE_TOKENS", "postfix_ids",
           "synth_generator_batch", "synth_executor_steps", "synth_annotated"]

_ATTRS = ("size", "color", "material", "shape")
FUNCTION_IDS: Dict[str, int] = {
    name: i + 1 for i, name in enumerate(
        ["scene", "unique", "relate", "exist", "count", "greater_than", "less_than",
         "equal_integer"]
        + [f"{kind}_{a}" for kind in ("filter", "same", "query", "equal") for a in _ATTRS])
}

# CLEVR's attribute values, by attribute
_VALUES = {"size": ("large", "small"),
           "color": ("gray", "red", "blue", "green", "brown", "purple", "cyan", "yellow"),
           "material": ("rubber", "metal"), "shape": ("cube", "sphere", "cylinder")}
# the executor's value vocabulary (canonical: yes/no are true/false)
VALUE_TOKENS: Tuple[str, ...] = (("true", "false") + tuple(str(i) for i in range(11))
                                 + tuple(v for a in _ATTRS for v in _VALUES[a]))

# the generator's program vocabulary: specials, then the function names
PROGRAM_TOKENS: Tuple[str, ...] = ("<NULL>", "<START>", "<END>") + tuple(sorted(FUNCTION_IDS))

Node = Tuple[str, int, int]


def _clevr_branch(rng: np.random.RandomState, allow_hops: bool = True) -> List[Node]:
    """scene -> 1-3 filters, optionally extended by a relate or same_* hop
    (unique -> hop -> 1-2 more filters)."""
    nodes = [("scene", -1, -1)]
    for _ in range(rng.randint(1, 4)):
        nodes.append((f"filter_{_ATTRS[rng.randint(4)]}", len(nodes) - 1, -1))
    hops = 0
    if allow_hops:
        hops = int(rng.rand() < 0.6) + int(rng.rand() < 0.25)
    for _ in range(hops):
        hop = "relate" if rng.rand() < 0.7 else f"same_{_ATTRS[rng.randint(4)]}"
        nodes.append(("unique", len(nodes) - 1, -1))
        nodes.append((hop, len(nodes) - 1, -1))
        for _ in range(rng.randint(1, 3)):
            nodes.append((f"filter_{_ATTRS[rng.randint(4)]}", len(nodes) - 1, -1))
    return nodes


def _clevr_program(rng: np.random.RandomState) -> List[Node]:
    """One program as [(fn, dep0, dep1)] from the query / exist / count /
    compare-attribute / compare-number family mix."""
    fam = rng.choice(
        ["query", "exist", "count", "compare_attr", "compare_num"],
        p=[0.35, 0.15, 0.15, 0.20, 0.15],
    )
    if fam in ("query", "exist", "count"):
        nodes = _clevr_branch(rng)
        if fam == "query":
            nodes.append(("unique", len(nodes) - 1, -1))
            nodes.append((f"query_{_ATTRS[rng.randint(4)]}", len(nodes) - 1, -1))
        else:
            nodes.append((fam, len(nodes) - 1, -1))
        return nodes
    b1 = _clevr_branch(rng)
    b2 = _clevr_branch(rng)
    nodes = list(b1)
    off = len(nodes)
    nodes += [(fn, d0 + off if d0 >= 0 else -1, d1 + off if d1 >= 0 else -1)
              for fn, d0, d1 in b2]
    if fam == "compare_num":
        nodes.append(("count", len(b1) - 1, -1))
        c1 = len(nodes) - 1
        nodes.append(("count", off + len(b2) - 1, -1))
        c2 = len(nodes) - 1
        cmp_fn = ["greater_than", "less_than", "equal_integer"][rng.randint(3)]
        nodes.append((cmp_fn, c1, c2))
    else:
        attr = _ATTRS[rng.randint(4)]
        nodes.append(("unique", len(b1) - 1, -1))
        nodes.append((f"query_{attr}", len(nodes) - 1, -1))
        q1 = len(nodes) - 1
        nodes.append(("unique", off + len(b2) - 1, -1))
        nodes.append((f"query_{attr}", len(nodes) - 1, -1))
        q2 = len(nodes) - 1
        nodes.append((f"equal_{attr}", q1, q2))
    return nodes


def synth_questions(n: int, exe_cfg: ExecutorConfig, max_steps: int = 27, seed: int = 0):
    """(features (M, P, C) float32, questions (N, 46) int32, ChainArrays) with
    M = max(1, n // 10) images."""
    rng = np.random.RandomState(seed)
    num_images = max(1, n // 10)
    features = rng.rand(num_images, exe_cfg.num_image_tokens, exe_cfg.image_feature_dim).astype(
        np.float32)
    questions = rng.randint(4, 96, (n, 46)).astype(np.int32)
    functions = np.zeros((n, max_steps), np.int32)
    deps = np.full((n, max_steps, 2), -1, np.int64)
    num_steps = np.zeros(n, np.int32)
    for i in range(n):
        nodes = _clevr_program(rng)
        while len(nodes) > max_steps:
            nodes = _clevr_program(rng)
        num_steps[i] = len(nodes)
        for k, (fn, d0, d1) in enumerate(nodes):
            functions[i, k] = FUNCTION_IDS[fn]
            deps[i, k, 0] = d0
            deps[i, k, 1] = d1
    image_index = rng.randint(0, num_images, n).astype(np.int32)
    return features, questions, ChainArrays(image_index, functions, deps, num_steps, [""] * n)


def postfix_ids(chains: ChainArrays, length: int, start: bool = False) -> np.ndarray:
    """Each chain's program as the generator spells one, in
    :data:`PROGRAM_TOKENS` ids: <START> if ``start``, the nodes in postfix
    order (children first, then the node), <END>, then <NULL> padding, cut
    at ``length``."""
    token_ids = {t: i for i, t in enumerate(PROGRAM_TOKENS)}
    names = {i: name for name, i in FUNCTION_IDS.items()}
    out = np.zeros((len(chains.num_steps), length), np.int64)
    for i, steps in enumerate(chains.num_steps):
        order: List[int] = []

        def visit(step: int) -> None:
            for dep in chains.deps[i, step]:
                if dep >= 0:
                    visit(dep)
            order.append(step)

        visit(steps - 1)
        ids = ([token_ids["<START>"]] if start else []) + [
            token_ids[names[chains.functions[i, s]]] for s in order] + [token_ids["<END>"]]
        out[i, :min(len(ids), length)] = ids[:length]
    return out


def synth_generator_batch(n: int, cfg: GeneratorConfig, seed: int = 0):
    """(questions (n, 46) int32, programs (n, program_len) int32, image_index
    (n,)): random question tokens beside ``synth_questions``' programs, each
    <START> + postfix + <END> within ``program_len`` (programs of at most
    ``program_len - 2`` steps), as the questions h5 holds them."""
    _features, questions, chains = synth_questions(
        n, ExecutorConfig(num_image_tokens=1, image_feature_dim=1),
        max_steps=cfg.program_len - 2, seed=seed)
    programs = postfix_ids(chains, cfg.program_len, start=True).astype(np.int32)
    return questions, programs, chains.image_index


def _random_boxes(rng: np.random.RandomState, k: int) -> np.ndarray:
    """(k, 4) boxes x0 < x1, y0 < y1 inside [0, 1], sides 0.05-0.25."""
    lo = rng.uniform(0.0, 0.75, (k, 2))
    return np.concatenate([lo, lo + rng.uniform(0.05, 0.25, (k, 2))], 1).astype(np.float32)


def synth_executor_steps(n: int, cfg: ExecutorConfig, seed: int = 0):
    """(arrays, features): ``n`` executor step records in
    ``executor_step_arrays``' layout and image features (M, P, C) float32,
    M = max(1, n // 100).

    The steps are ``synth_questions``' program steps in order, so the share
    of spatial steps is CLEVR-shaped.  Each spatial step's targets are 1-10
    random boxes (1 after ``unique``); each non-spatial step's target is a
    random value token.  A step's input boxes are its dependencies' target
    boxes (concatenated, cut at ``max_input_boxes``) and its text the
    function id and up to two dependency tokens; masks are contiguous from
    slot 0.
    """
    rng = np.random.RandomState(seed)
    num_images = max(1, n // 100)
    features = rng.rand(num_images, cfg.num_image_tokens, cfg.image_feature_dim).astype(
        np.float32)
    # every program has at least 3 steps, so n // 3 + 1 programs hold n steps
    _f, _q, chains = synth_questions(n // 3 + 1, ExecutorConfig(num_image_tokens=1,
                                                                image_feature_dim=1),
                                     seed=seed + 1)
    names = {i: name for name, i in FUNCTION_IDS.items()}
    s_in, s_out = cfg.max_input_boxes, cfg.num_queries
    records = {
        "image_index": np.zeros(n, np.int32), "text": np.zeros((n, 3), np.int32),
        "text_mask": np.zeros((n, 3), bool), "input_boxes": np.zeros((n, s_in, 4), np.float32),
        "input_box_mask": np.zeros((n, s_in), bool),
        "target_boxes": np.zeros((n, s_out, 4), np.float32),
        "target_box_mask": np.zeros((n, s_out), bool), "token_target": np.zeros(n, np.int32),
        "is_box_branch": np.zeros(n, bool),
    }
    row = 0
    for q in range(len(chains.num_steps)):
        image = rng.randint(num_images)
        outputs: List[Tuple[str, object]] = []  # each step's ("box", boxes) or ("token", id)
        for k in range(chains.num_steps[q]):
            if row == n:
                return records, features
            name = names[chains.functions[q, k]]
            deps = [d for d in chains.deps[q, k] if d >= 0]
            dep_boxes = [outputs[d][1] for d in deps if outputs[d][0] == "box"]
            dep_tokens = [outputs[d][1] for d in deps if outputs[d][0] == "token"][:2]
            records["image_index"][row] = image
            records["text"][row, :1 + len(dep_tokens)] = [chains.functions[q, k]] + dep_tokens
            records["text_mask"][row, :1 + len(dep_tokens)] = True
            inputs = (np.concatenate(dep_boxes) if dep_boxes else np.zeros((0, 4)))[:s_in]
            records["input_boxes"][row, :len(inputs)] = inputs
            records["input_box_mask"][row, :len(inputs)] = True
            if name in NON_SPATIAL_FUNCTIONS:
                token = int(rng.randint(1, cfg.token_classes))
                records["token_target"][row] = token
                outputs.append(("token", token))
            else:
                boxes = _random_boxes(rng, 1 if name == "unique" else rng.randint(1, s_out + 1))
                records["target_boxes"][row, :len(boxes)] = boxes
                records["target_box_mask"][row, :len(boxes)] = True
                records["is_box_branch"][row] = True
                outputs.append(("box", boxes))
            row += 1
    return records, features


def _box_text(boxes: np.ndarray) -> str:
    return " ".join(f"[{x0:.4f} {y0:.4f} {x1:.4f} {y1:.4f}]" for x0, y0, x1, y1 in boxes)


def synth_annotated(n: int, cfg: ExecutorConfig, seed: int = 0, max_steps: int = 27):
    """(records, features, function vocab, value vocab): ``n`` raw annotated
    questions on ``synth_questions``' programs and image features, in the
    layout ``_parse_question_steps`` reads: each question's
    ``annotated_program`` lists steps with ``function`` (a name of
    :data:`FUNCTION_IDS`, the function vocabulary), ``inputs`` (dependency
    steps) and ``output_values``.

    A spatial step outputs 1-10 boxes as '[x0 y0 x1 y1] ...' text: ``scene``
    3-10 random boxes, a filter a random non-empty subset of its input's,
    ``unique`` one of its input's, ``relate`` and ``same_*`` 1-10 new ones.
    A value step outputs a CLEVR value: ``count`` its input's box count,
    ``exist`` yes, ``query_*`` a random value of the attribute, the
    comparisons the truth of their inputs' values.  The answer is the last
    step's value; the value vocabulary is :data:`VALUE_TOKENS`."""
    features, _questions, chains = synth_questions(n, cfg, max_steps=max_steps, seed=seed)
    rng = np.random.RandomState(seed + 1)
    names = {i: name for name, i in FUNCTION_IDS.items()}
    records: List[Dict[str, Any]] = []
    for q in range(n):
        outputs: List[Any] = []  # each step's boxes or value string
        steps = []
        for k in range(chains.num_steps[q]):
            name = names[chains.functions[q, k]]
            inputs = [int(d) for d in chains.deps[q, k] if d >= 0]
            dep = [outputs[d] for d in inputs]
            if name == "scene":
                value: Any = _random_boxes(rng, rng.randint(3, 11))
            elif name.startswith("filter_"):
                keep = rng.rand(len(dep[0])) < 0.6
                keep[rng.randint(len(keep))] = True
                value = dep[0][keep]
            elif name == "unique":
                value = dep[0][rng.randint(len(dep[0]))][None]
            elif name == "relate" or name.startswith("same_"):
                value = _random_boxes(rng, rng.randint(1, 11))
            elif name == "count":
                value = str(len(dep[0]))
            elif name == "exist":
                value = "yes"
            elif name.startswith("query_"):
                options = _VALUES[name.split("_")[1]]
                value = options[rng.randint(len(options))]
            elif name.startswith("equal_"):
                value = "yes" if dep[0] == dep[1] else "no"
            else:  # greater_than, less_than
                a, b = int(dep[0]), int(dep[1])
                value = "yes" if (a > b if name == "greater_than" else a < b) else "no"
            outputs.append(value)
            steps.append({"function": name, "inputs": inputs,
                          "output_values": value if isinstance(value, str) else _box_text(value)})
        records.append({"image_index": int(chains.image_index[q]), "answer": outputs[-1],
                        "annotated_program": steps})
    return records, features, dict(FUNCTION_IDS), {v: i for i, v in enumerate(VALUE_TOKENS)}
