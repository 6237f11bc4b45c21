"""Synthetic CLEVR-compatible data, copied from
``explainable_spatial_vqa_tpu/clevr/synthetic.py``: every draw comes from the
caller's ``np.random.RandomState`` in the same order, so one seed gives the
same scenes, questions and feature maps in both packages.

- scenes: random objects with CLEVR attribute palettes, consistent
  pixel/3d coordinates (so the bbox geometry applies) and positional
  relationships (left/right by x, front/behind by depth-proxy y);
- programs: well-typed template programs over the scene vocabulary, ending in
  a non-spatial function (CLEVR convention), executed symbolically for
  answers;
- questions: deterministic template text per program (so question -> program
  is learnable);
- features: synthetic "image features" that paint per-object attribute
  channels into the spatial grid with anti-aliased bbox coverage plus a
  bilinear center splat: an executor trained on these must learn
  grounding, not memorize;
- CoGenT-conditioned scenes and corpora (condition A or B palettes).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from explainable_spatial_vqa_tpu_torch.clevr.bboxes import scene_bounding_boxes
from explainable_spatial_vqa_tpu_torch.clevr.executor import INVALID, execute_program
from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene

__all__ = [
    "random_scene",
    "random_scene_cogent",
    "random_question",
    "synthesize_dataset",
    "synthesize_cogent_dataset",
    "scene_feature_map",
    "color_channel",
    "ATTRIBUTE_VALUES",
]

ATTRIBUTE_VALUES: Dict[str, Tuple[str, ...]] = {
    "color": ("gray", "red", "blue", "green", "brown", "purple", "cyan", "yellow"),
    "shape": ("cube", "sphere", "cylinder"),
    "size": ("large", "small"),
    "material": ("rubber", "metal"),
}

_RELATIONS = ("left", "right", "front", "behind")


def random_scene(rng: np.random.RandomState, image_index: int,
                 num_objects: Optional[int] = None,
                 palette_size: int = 4) -> Dict[str, Any]:
    """A raw CLEVR-format scene dict with consistent geometry.

    Colors are drawn from a random per-scene subset of ``palette_size``
    of the 8 CLEVR colors (the full palette across scenes): uniform-8
    scenes average only ~0.6 same-color partners per object, starving
    same_color of nonempty outputs; real ~10-object CLEVR scenes repeat
    colors routinely.  Pass ``palette_size=8`` for the legacy distribution."""
    n = int(num_objects if num_objects is not None else rng.randint(3, 8))
    palette = [ATTRIBUTE_VALUES["color"][i] for i in sorted(
        rng.choice(8, size=min(palette_size, 8), replace=False))]
    objects = []
    for _ in range(n):
        x = float(rng.uniform(80, 400))
        y = float(rng.uniform(80, 260))
        depth = float(rng.uniform(8, 14))
        size = ATTRIBUTE_VALUES["size"][rng.randint(2)]
        objects.append({
            "color": palette[rng.randint(len(palette))],
            "shape": ATTRIBUTE_VALUES["shape"][rng.randint(3)],
            "size": size,
            "material": ATTRIBUTE_VALUES["material"][rng.randint(2)],
            "pixel_coords": [x, y, depth],
            "3d_coords": [
                float(rng.uniform(-3, 3)),
                float(rng.uniform(-3, 3)),
                0.7 if size == "large" else 0.35,
            ],
            "rotation": float(rng.uniform(0, 360)),
        })

    xs = np.array([o["pixel_coords"][0] for o in objects])
    ys = np.array([o["pixel_coords"][1] for o in objects])
    relationships = {
        "left": [[int(j) for j in np.flatnonzero(xs < xs[i]) if j != i] for i in range(n)],
        "right": [[int(j) for j in np.flatnonzero(xs > xs[i]) if j != i] for i in range(n)],
        "front": [[int(j) for j in np.flatnonzero(ys > ys[i]) if j != i] for i in range(n)],
        "behind": [[int(j) for j in np.flatnonzero(ys < ys[i]) if j != i] for i in range(n)],
    }
    return {
        "image_index": image_index,
        "image_filename": f"SYN_val_{image_index:06d}.png",
        "split": "val",
        "objects": objects,
        "relationships": relationships,
        "directions": {
            "right": [1.0, 0.0, 0.0],
            "behind": [0.0, 1.0, 0.0],
            "above": [0.0, 0.0, 1.0],
        },
    }


def _node(fn: str, inputs: Sequence[int] = (), values: Sequence[str] = ()) -> Dict[str, Any]:
    return {"function": fn, "inputs": list(inputs), "value_inputs": list(values)}


_QUESTION_TEMPLATES = {
    "count": "how many {f} are there",
    "exist": "are there any {f}",
    "query_color": "what color is the {f}",
    "query_shape": "what shape is the {f}",
    "query_size": "what size is the {f}",
    "query_material": "what material is the {f}",
}


_RELATE_WORDS = {
    "left": "left of", "right": "right of",
    "front": "in front of", "behind": "behind",
}


def _filters(
    rng: np.random.RandomState, program: List[Dict[str, Any]], root: int,
    lo: int = 1, hi: int = 2, exclude_attr: Optional[str] = None,
) -> "Tuple[int, List[str]]":
    parts: List[str] = []
    prev = root
    attrs = [a for a in ATTRIBUTE_VALUES if a != exclude_attr]
    for _ in range(rng.randint(lo, hi + 1)):
        attr = attrs[rng.randint(len(attrs))]
        value = ATTRIBUTE_VALUES[attr][rng.randint(len(ATTRIBUTE_VALUES[attr]))]
        program.append(_node(f"filter_{attr}", [prev], [value]))
        prev = len(program) - 1
        parts.append(value)
    return prev, parts


def _distinguishing_filters(
    rng: np.random.RandomState, objs: List[Dict[str, Any]],
    candidates: Sequence[int], target: int,
    program: List[Dict[str, Any]], prev: int,
    exclude_attr: Optional[str] = None,
) -> "Optional[Tuple[int, List[str]]]":
    """Scene-aware filter chain narrowing ``candidates`` to exactly
    ``{target}``: attributes in random order, each filter taking the
    target's value and appended only if it discriminates.  Guarantees a
    later ``unique`` is valid — blind rejection-sampled filters made hop
    questions ~4x less likely to survive than the nominal hop_prob.
    ``exclude_attr`` keeps a queried/compared attribute
    out of the chain so the answer never appears in the question text.
    Returns (last node index, value parts) or None — rolling back its own
    appended nodes — when the candidate set cannot be narrowed to the
    target (identical twins within the excluded-attribute projection)."""
    attrs = [a for a in ATTRIBUTE_VALUES if a != exclude_attr]
    rng.shuffle(attrs)
    parts: List[str] = []
    cand = set(candidates)
    rollback = len(program)
    for attr in attrs:
        if len(cand) == 1:
            break
        val = objs[target][attr]
        narrowed = {i for i in cand if objs[i][attr] == val}
        if len(narrowed) == len(cand):
            continue  # non-discriminating filter: keep the program short
        program.append(_node(f"filter_{attr}", [prev], [val]))
        prev = len(program) - 1
        parts.append(val)
        cand = narrowed
    if len(cand) != 1:
        del program[rollback:]
        return None
    return prev, parts


def _the(pre: str, post: str) -> str:
    """Singular noun phrase for a uniquified set: 'the [pre] thing [post]'."""
    head = f"the {pre} thing" if pre else "the thing"
    return f"{head} {post}" if post else head


def _hop_branch(
    rng: np.random.RandomState, program: List[Dict[str, Any]], scene: Scene,
    chain_prob: float = 0.0, want_unique: bool = False,
    same_bias: float = 0.7, exclude_attr: Optional[str] = None,
) -> "Optional[Tuple[int, str]]":
    """Scene-aware relational branch: a guaranteed-unique base chain, then
    1 (or, with probability ``chain_prob``, 2) hops of ``unique ->
    relate[dir] | same_<attr> -> filters`` — CLEVR's "the X left of the Y"
    / "other things with the same color as the Y" families, chainable to
    "... left of the Y behind the Z".  Hop outputs are sampled with a bias
    toward nonempty sets and ``same_bias`` toward same_* over relate (four
    same_<attr> rows split that mass in thesis Table 4.3 p.28).  With
    ``want_unique`` the final set is narrowed to a singleton (for query_*/
    equal_* terminals).  Returns (last node index, PLURAL noun phrase) or
    None after rolling the program back (caller falls back / resamples)."""
    objs = scene.objects
    start = len(program)
    target = int(rng.randint(len(objs)))
    base = _distinguishing_filters(
        rng, objs, range(len(objs)), target, program, 0, exclude_attr)
    if base is None:
        del program[start:]
        return None
    prev, parts = base
    pre, post = " ".join(parts), ""
    cur = target
    hops = 1 + (1 if rng.uniform() < chain_prob else 0)
    h = 0
    while h < hops:
        program.append(_node("unique", [prev]))
        prev = len(program) - 1
        head = _the(pre, post)
        options = [("relate", rel, scene.relationships[rel].get(cur, []))
                   for rel in _RELATIONS]
        options += [(f"same_{attr}", attr, scene.same_attr[attr].get(cur, []))
                    for attr in ATTRIBUTE_VALUES
                    if attr != exclude_attr]
        pool = [o for o in options if o[2]] or options
        sames = [o for o in pool if o[0].startswith("same_")]
        rels = [o for o in pool if o[0] == "relate"]
        if sames and (not rels or rng.uniform() < same_bias):
            fn, param, out = sames[rng.randint(len(sames))]
        else:
            fn, param, out = rels[rng.randint(len(rels))]
        if fn == "relate":
            program.append(_node("relate", [prev], [param]))
            post = f"{_RELATE_WORDS[param]} {head}"
        else:
            program.append(_node(fn, [prev]))
            post = f"with the same {param} as {head}"
        prev = len(program) - 1
        last = h + 1 >= hops
        narrowed = None
        member = -1
        if (not last or want_unique) and out:
            # the set feeds another unique: narrow it to one member
            member = int(out[rng.randint(len(out))])
            narrowed = _distinguishing_filters(
                rng, objs, out, member, program, prev, exclude_attr)
        if narrowed is not None:
            prev, parts = narrowed
            pre = " ".join(parts)
            cur = member
            h += 1
            continue
        # could not (or did not need to) narrow to a singleton
        if want_unique:
            del program[start:]
            return None
        hops = h + 1  # demote: this hop is the last, with a plural result
        # plural terminal set: 0-1 filters; value from a member half the
        # time (nonempty-biased) and blind otherwise (keeps exist "no" /
        # count 0 answers in distribution)
        pre = ""
        if rng.uniform() < 0.6:
            attrs2 = [a for a in ATTRIBUTE_VALUES if a != exclude_attr]
            attr2 = attrs2[rng.randint(len(attrs2))]
            if out and rng.uniform() < 0.5:
                val = objs[int(out[rng.randint(len(out))])][attr2]
            else:
                vals = ATTRIBUTE_VALUES[attr2]
                val = vals[rng.randint(len(vals))]
            program.append(_node(f"filter_{attr2}", [prev], [val]))
            prev = len(program) - 1
            pre = val
        h += 1
    return prev, (f"{pre} things {post}" if pre else f"things {post}")


def _filter_branch(
    rng: np.random.RandomState, program: List[Dict[str, Any]],
    scene: Optional[Scene] = None, hop_prob: float = 0.0,
    chain_prob: float = 0.0, want_unique: bool = False,
    exclude_attr: Optional[str] = None,
) -> "Tuple[int, str]":
    """Append a branch rooted at the scene node (index 0): with probability
    ``hop_prob`` a scene-aware relational hop chain (:func:`_hop_branch`),
    otherwise a plain blind filter chain; ``want_unique`` makes the branch's
    final set a guaranteed singleton (scene-aware) for query_*/equal_*
    terminals.  Returns (last node index, complete plural noun phrase)."""
    if scene is not None and rng.uniform() < hop_prob:
        res = _hop_branch(rng, program, scene, chain_prob=chain_prob,
                          want_unique=want_unique, exclude_attr=exclude_attr)
        if res is not None:
            return res
    if want_unique and scene is not None:
        objs = scene.objects
        start = len(program)
        res = _distinguishing_filters(
            rng, objs, range(len(objs)), int(rng.randint(len(objs))),
            program, 0, exclude_attr)
        if res is not None:
            prev, parts = res
            return prev, (" ".join(parts) + " things").strip()
        del program[start:]
    prev, parts = _filters(rng, program, 0, exclude_attr=exclude_attr)
    return prev, " ".join(parts) + " things"


def random_question(
    rng: np.random.RandomState, scene: Scene, question_index: int,
    hop_prob: float = 0.0, max_nodes: int = 12, chain_prob: float = 0.0,
) -> Optional[Dict[str, Any]]:
    """A well-typed template question over ``scene`` with a valid answer.

    Templates: [scene] -> 1-2 filters -> {count | exist | unique -> query_*},
    plus the two-branch DAG families [scene] -> branch x2 ->
    {count x2 -> greater/less/equal_integer | unique+query x2 -> equal_* |
    union/intersect -> count/exist} (CLEVR's compare_number /
    compare_attribute / single_or "either X or Y" / single_and "both X and
    Y" question types — union and intersect are the two set-typed 2-input
    functions of thesis Table 4.3).  With
    ``hop_prob`` > 0 branches may extend through relate / same_* joins
    (see :func:`_filter_branch`) — scene-aware, so the hop's ``unique`` is
    valid by construction and accepted questions carry relate/same_* mass
    at the nominal rate (blind sampling accepted hops ~4x below nominal,
    starving exactly the functions thesis Table 4.3 p.28 found hardest) —
    and ``chain_prob`` extends an accepted hop with a second one ("the X
    left of the Y behind the Z").  query_*/equal_*
    terminals use scene-aware guaranteed-unique branches with the queried
    attribute EXCLUDED from filters and same_* hops (no answer leakage).
    Returns None when the sampled program is INVALID on the scene (e.g.
    unique over a non-singleton set) or exceeds ``max_nodes`` — the caller
    resamples.
    """
    program: List[Dict[str, Any]] = [_node("scene")]
    terminal = ["count", "exist", "query", "compare_num", "compare_attr",
                "setop"][rng.randint(6)]

    if terminal == "setop":
        op = ("union", "intersect")[rng.randint(2)]
        if op == "intersect" and rng.uniform() < 0.7:
            # member-anchored branches: both filters take attribute values
            # from one sampled object, so the intersection provably contains
            # it — blind intersect branches are usually near-disjoint,
            # starving the intersect row of GT boxes
            objs = scene.objects
            m = objs[rng.randint(len(objs))]
            attrs = list(ATTRIBUTE_VALUES)
            rng.shuffle(attrs)
            program.append(_node(f"filter_{attrs[0]}", [0], [m[attrs[0]]]))
            i1, t1 = len(program) - 1, f"{m[attrs[0]]} things"
            program.append(_node(f"filter_{attrs[1]}", [0], [m[attrs[1]]]))
            i2, t2 = len(program) - 1, f"{m[attrs[1]]} things"
        else:
            i1, t1 = _filter_branch(rng, program, scene, hop_prob=hop_prob,
                                    chain_prob=chain_prob / 2)
            i2, t2 = _filter_branch(rng, program, scene, hop_prob=hop_prob,
                                    chain_prob=chain_prob / 2)
        program.append(_node(op, [i1, i2]))
        final = ("count", "exist")[rng.randint(2)]
        program.append(_node(final, [len(program) - 1]))
        joiner = "or" if op == "union" else "and"
        question = (
            f"how many things are {t1} {joiner} {t2}"
            if final == "count"
            else f"are there any things that are {t1} {joiner} {t2}"
        )
    elif terminal in ("compare_num", "compare_attr"):
        # compare_attr halves the per-branch hop rate (its branches already
        # carry unique+query nodes; full-rate double hops blow max_nodes)
        cmp_attr: Optional[str] = None
        bh = hop_prob
        if terminal == "compare_attr":
            cmp_attr = list(ATTRIBUTE_VALUES)[rng.randint(4)]
            bh = hop_prob / 2
        bc = chain_prob / 2 if terminal == "compare_num" else 0.0
        i1, t1 = _filter_branch(
            rng, program, scene, hop_prob=bh, chain_prob=bc,
            want_unique=terminal == "compare_attr", exclude_attr=cmp_attr)
        i2, t2 = _filter_branch(
            rng, program, scene, hop_prob=bh, chain_prob=bc,
            want_unique=terminal == "compare_attr", exclude_attr=cmp_attr)
        if terminal == "compare_num":
            program.append(_node("count", [i1]))
            c1 = len(program) - 1
            program.append(_node("count", [i2]))
            c2 = len(program) - 1
            op = ["greater_than", "less_than", "equal_integer"][rng.randint(3)]
            program.append(_node(op, [c1, c2]))
            question = {
                "greater_than": f"are there more {t1} than {t2}",
                "less_than": f"are there fewer {t1} than {t2}",
                "equal_integer": (
                    f"are there the same number of {t1} as {t2}"
                ),
            }[op]
        else:
            attr = cmp_attr
            program.append(_node("unique", [i1]))
            program.append(_node(f"query_{attr}", [len(program) - 1]))
            q1 = len(program) - 1
            program.append(_node("unique", [i2]))
            program.append(_node(f"query_{attr}", [len(program) - 1]))
            q2 = len(program) - 1
            program.append(_node(f"equal_{attr}", [q1, q2]))
            question = (
                f"does the {t1} have the same {attr} as the {t2}"
            )
    else:
        attr = None
        if terminal == "query":
            attr = list(ATTRIBUTE_VALUES)[rng.randint(4)]
        prev, phrase = _filter_branch(
            rng, program, scene, hop_prob=hop_prob, chain_prob=chain_prob,
            want_unique=terminal == "query", exclude_attr=attr)
        if terminal == "query":
            program.append(_node("unique", [prev]))
            program.append(_node(f"query_{attr}", [len(program) - 1]))
            template = _QUESTION_TEMPLATES[f"query_{attr}"]
        else:
            program.append(_node(terminal, [prev]))
            template = _QUESTION_TEMPLATES[terminal]
        question = template.format(f=phrase)

    if len(program) > max_nodes:
        return None
    outputs = execute_program(scene, program)
    if len(outputs) < len(program) or outputs[-1] == INVALID:
        return None
    answer = outputs[-1]
    if isinstance(answer, bool):
        answer = "yes" if answer else "no"
    answer = str(answer)

    return {
        "image_index": scene.image_index,
        "question_index": question_index,
        "question": question + "?",
        "answer": answer,
        "program": program,
        "question_family_index": 0,
        "split": "val",
        "image_filename": scene.raw["image_filename"],
    }


def synthesize_dataset(
    num_scenes: int, questions_per_scene: int, seed: int = 0,
    hop_prob: float = 0.0, chain_prob: float = 0.0, max_nodes: int = 12,
    palette_size: int = 4,
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Returns (raw scenes, question records with programs + answers).

    ``palette_size=8`` restores the legacy uniform color DISTRIBUTION
    (older corpora), though not the exact legacy RNG stream — the palette
    draw itself advances the generator, so scene geometry differs draw-for-
    draw from corpora generated before the palette change."""
    rng = np.random.RandomState(seed)
    scenes_raw = [random_scene(rng, i, palette_size=palette_size)
                  for i in range(num_scenes)]
    questions: List[Dict[str, Any]] = []
    for raw in scenes_raw:
        scene = Scene.from_raw(raw)
        made = 0
        attempts = 0
        while made < questions_per_scene and attempts < questions_per_scene * 40:
            attempts += 1
            q = random_question(rng, scene, len(questions), hop_prob=hop_prob,
                                chain_prob=chain_prob, max_nodes=max_nodes)
            if q is not None:
                questions.append(q)
                made += 1
    return scenes_raw, questions


# Per-shape color->channel permutations for the ENTANGLED feature mode:
# channel = (stride * color + offset) % 8, stride coprime to 8 so each map is
# a bijection.  Chosen so that for cubes AND cylinders the CoGenT condition-B
# color set lands on channels never active with that shape under condition-A
# training — the zero-shot A->B color-decoding failure is then
# information-theoretically forced, which is exactly the phenomenon the
# CoGenT protocol (thesis §4.2.2, Table 4.6 p.37) exists to measure.
_ENTANGLE_STRIDE = {"cube": 1, "sphere": 3, "cylinder": 5}
_ENTANGLE_OFFSET = {"cube": 0, "sphere": 2, "cylinder": 5}


def color_channel(color: str, shape: str, entangled: bool = False) -> int:
    """Feature channel carrying ``color`` for an object of ``shape``.

    Plain mode: the color one-hot channel (disentangled — color readout
    never needs shape, so CoGenT A->B shows no gap).
    Entangled mode: a per-shape permutation — decoding color REQUIRES
    shape-conditioned grounding, the synthetic analogue of real CLEVR pixels
    where an unseen (shape, color) combination looks unlike anything in
    condition-A training."""
    c = ATTRIBUTE_VALUES["color"].index(color)
    if not entangled:
        return c
    return (_ENTANGLE_STRIDE[shape] * c + _ENTANGLE_OFFSET[shape]) % 8


def _coverage_1d(lo: float, hi: float, grid: int) -> np.ndarray:
    """Fraction of each unit cell [i, i+1) covered by the interval
    [lo, hi) in cell coordinates (anti-aliased rectangle edge)."""
    i = np.arange(grid, dtype=np.float32)
    return np.clip(np.minimum(hi, i + 1.0) - np.maximum(lo, i), 0.0, 1.0)


def scene_feature_map(
    scene_raw: Dict[str, Any], grid: int = 14, channels: int = 64,
    entangled: bool = False,
) -> np.ndarray:
    """Deterministic (channels, grid, grid) feature map encoding the scene.

    Each object paints its attribute channels (color 0-7, shape 8-10,
    size 11-12, material 13-14, objectness 15) with the FRACTIONAL coverage
    of each grid cell by its bbox (anti-aliased rectangle, merged across
    objects by max), and bilinearly splats its box center into channel 16.
    Anti-aliased edges keep sub-cell corner positions recoverable (binary
    cell-snapped painting quantized corners to 1/grid — at CLEVR box sizes
    of ~1-2 cells that made IoU 0.5 structurally unreachable) and the
    center splat separates overlapping same-attribute instances, the two
    cues real ResNet features carry at pixel resolution.  A model reading
    these features must still learn grounding — nothing identifies the
    image beyond its object layout.

    ``entangled=True`` routes color through :func:`color_channel`'s per-shape
    permutation (shape/size/material channels unchanged) so color decoding is
    shape-conditioned — required for the CoGenT transfer gap to exist.
    """
    assert channels >= 17
    feat = np.zeros((channels, grid, grid), np.float32)
    boxes = scene_bounding_boxes(scene_raw, decimals=None)
    for obj, box in zip(scene_raw["objects"], boxes):
        x0, y0, x1, y1 = (np.asarray(box, np.float32) * grid).tolist()
        cover = np.outer(_coverage_1d(y0, y1, grid),
                         _coverage_1d(x0, x1, grid))
        chans = [
            color_channel(obj["color"], obj["shape"], entangled),
            8 + ATTRIBUTE_VALUES["shape"].index(obj["shape"]),
            11 + ATTRIBUTE_VALUES["size"].index(obj["size"]),
            13 + ATTRIBUTE_VALUES["material"].index(obj["material"]),
            15,
        ]
        for c in chans:
            np.maximum(feat[c], cover, out=feat[c])
        # bilinear center splat: cell-center coordinates of the box center
        cx = np.clip((x0 + x1) / 2.0 - 0.5, 0.0, grid - 1.0)
        cy = np.clip((y0 + y1) / 2.0 - 0.5, 0.0, grid - 1.0)
        ix, iy = int(cx), int(cy)
        fx, fy = cx - ix, cy - iy
        for dy, wy in ((0, 1.0 - fy), (1, fy)):
            for dx, wx in ((0, 1.0 - fx), (1, fx)):
                if wy * wx and iy + dy < grid and ix + dx < grid:
                    feat[16, iy + dy, ix + dx] = max(
                        feat[16, iy + dy, ix + dx], wy * wx)
    return feat


def random_scene_cogent(
    rng: np.random.RandomState, image_index: int, condition: str,
    num_objects: Optional[int] = None,
) -> Dict[str, Any]:
    """CoGenT-conditioned scene: condition 'A' restricts cubes to
    gray/blue/brown/yellow and cylinders to red/green/purple/cyan; 'B' swaps
    the two palettes; spheres take any color (thesis §4.2.2 / evalsuite.cogent
    palettes)."""
    from explainable_spatial_vqa_tpu_torch.evalsuite.cogent import (
        COGENT_A_PALETTE,
        COGENT_B_PALETTE,
    )

    palette = COGENT_A_PALETTE if condition == "A" else COGENT_B_PALETTE
    scene = random_scene(rng, image_index, num_objects)
    for obj in scene["objects"]:
        allowed = sorted(palette[obj["shape"]])
        obj["color"] = allowed[rng.randint(len(allowed))]
    return scene


def synthesize_cogent_dataset(
    num_scenes: int, questions_per_scene: int, condition: str, seed: int = 0,
    image_index_base: int = 0, hop_prob: float = 0.0,
    chain_prob: float = 0.0, max_nodes: int = 12,
) -> Tuple[List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Condition-restricted corpus for the CoGenT A->B protocol."""
    rng = np.random.RandomState(seed)
    scenes_raw = [
        random_scene_cogent(rng, image_index_base + i, condition)
        for i in range(num_scenes)
    ]
    questions: List[Dict[str, Any]] = []
    for raw in scenes_raw:
        scene = Scene.from_raw(raw)
        made = attempts = 0
        while made < questions_per_scene and attempts < questions_per_scene * 40:
            attempts += 1
            q = random_question(rng, scene, len(questions), hop_prob=hop_prob,
                                chain_prob=chain_prob, max_nodes=max_nodes)
            if q is not None:
                questions.append(q)
                made += 1
    return scenes_raw, questions
