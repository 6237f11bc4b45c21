"""CLEVR-shaped synthetic questions, a numpy-only copy of ``bench.py:83-180``.

Programs are drawn from CLEVR's structural question families (filter chains,
relate and same_* hops, two-branch attribute and number comparisons joined
by a 2-input node), with depths up to 27 steps.  Given the same seed this
draws the same features, questions, depths and dependencies as
``bench.synth_questions``.  Function ids come from a fixed table,
:data:`FUNCTION_IDS` (1-based), where the bench numbers names in order of
first appearance in the process; the names behind the ids agree.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.train.datasets import ChainArrays

__all__ = ["synth_questions", "FUNCTION_IDS"]

_ATTRS = ("size", "color", "material", "shape")
FUNCTION_IDS: Dict[str, int] = {
    name: i + 1 for i, name in enumerate(
        ["scene", "unique", "relate", "exist", "count", "greater_than", "less_than",
         "equal_integer"]
        + [f"{kind}_{a}" for kind in ("filter", "same", "query", "equal") for a in _ATTRS])
}

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
