"""Per-step annotation, the offline ground-truth factory, copied from
``explainable_spatial_vqa_tpu/clevr/annotate.py`` (the v3 annotation, the
input-step-grounded "full" annotation of the step seq2seq baseline in both
its styles, the single-string annotation of the chain-of-thought IQAP, the
structured annotation and the corpus sweep).

For every question, the symbolic executor runs the program step by step and
records, per step:

- ``function``: fused ``name[value,...]`` token,
- ``input_values``: the ``output_values`` of the steps it consumes (chained),
- ``output_values``: bbox strings for spatial functions / value tokens for
  non-spatial functions,
- plus a question-level ``final_chain_of_thought`` of ``"fn input_idx..."``
  strings used to drive chained inference.

The reference re-executes the whole program prefix at every step, so
*every* step positioned after the first INVALID (or erroring) step observes
a missing output, annotated as ``str(None)`` for non-spatial and empty for
spatial steps.  That is reproduced with incremental execution plus
positional poisoning, and the corpus sweep can fan out across processes.
"""

from __future__ import annotations

import multiprocessing as mp
from typing import Any, Dict, List, Optional, Sequence, Tuple

from explainable_spatial_vqa_tpu_torch.clevr.bboxes import format_bbox, scene_bounding_boxes
from explainable_spatial_vqa_tpu_torch.clevr.executor import (
    INVALID,
    NON_SPATIAL_FUNCTIONS,
    SPATIAL_FUNCTIONS,
    Executor,
)
from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene

__all__ = ["annotate_question", "annotate_question_full", "annotate_question_string",
           "annotate_question_structured", "annotate_questions", "step_relevant_objects"]


def step_relevant_objects(function: str, output: Any) -> List[int]:
    """Objects a step grounds to (preprocess_continousv3.py:396-406)."""
    if function == "scene":
        # For 'scene' the reference re-lists all objects; output already is that list.
        return list(output) if isinstance(output, list) else []
    if (
        function.startswith("filter_")
        or function in ("relate", "union", "intersect")
        or function.startswith("same_")
    ):
        return output if isinstance(output, list) else []
    if function == "unique":
        return [output] if isinstance(output, int) else []
    return []


def _execute_with_poisoning(
    scene: Scene, program: Sequence[Dict[str, Any]]
) -> Tuple[List[Any], List[List[int]]]:
    """Run the program once; after the first INVALID or error, every later
    step's output is None and its relevant-object set empty (positional, not
    dependency-based — matching the reference's re-run-the-prefix behavior).

    Runs the native C++ engine (:mod:`.native`) when it is built and loaded,
    and the Python executor when it is not, or when the engine raises or
    returns nothing, as the JAX package does; both give the same outputs
    (tests/test_torch_native.py).
    """
    from explainable_spatial_vqa_tpu_torch.clevr import native as native_engine

    if native_engine.native_available():
        try:
            outputs = native_engine.execute_native(scene, program)
        except Exception:
            outputs = None
        if outputs is not None:
            node_outputs: List[Any] = list(outputs)
            relevant: List[List[int]] = [
                step_relevant_objects(step.get("function") or step.get("type"), value)
                for step, value in zip(program, outputs)
            ]
            while len(node_outputs) < len(program):
                node_outputs.append(None)
                relevant.append([])
            return node_outputs, relevant
    return _execute_python(scene, program)


def _execute_python(
    scene: Scene, program: Sequence[Dict[str, Any]]
) -> Tuple[List[Any], List[List[int]]]:
    """:func:`_execute_with_poisoning` on the Python executor."""
    executor = Executor(scene)
    node_outputs: List[Any] = []
    relevant: List[List[int]] = []
    poisoned = False
    for idx, step in enumerate(program):
        function = step.get("function")
        if function is None or poisoned:
            node_outputs.append(None)
            relevant.append([])
            continue
        try:
            inputs = [node_outputs[i] for i in step.get("inputs", [])]
            output = executor.apply(function, inputs, step.get("value_inputs", []))
        except Exception:
            node_outputs.append(None)
            relevant.append([])
            poisoned = True
            continue
        node_outputs.append(output)
        relevant.append(step_relevant_objects(function, output))
        if output == INVALID:
            # The step itself keeps its INVALID output; all later steps see a
            # truncated prefix in the reference and read None.
            poisoned = True
    return node_outputs, relevant


def annotate_question(
    question: Dict[str, Any],
    scene: Scene,
    boxes: Optional[Any] = None,
) -> Dict[str, Any]:
    """Annotate one question.  ``boxes`` optionally precomputes the scene's
    (num_objects, 4) bbox array (4-decimal mode) to share across questions."""
    program = question["program"]
    if boxes is None:
        boxes = scene_bounding_boxes(scene.raw, decimals=4)
    node_outputs, relevant = _execute_with_poisoning(scene, program)

    annotated_program: List[Dict[str, Any]] = []
    chain_list: List[str] = []
    for i, step in enumerate(program):
        annotated_step = {k: v for k, v in step.items() if k != "value_inputs"}
        function_name = annotated_step.get("function", "")
        values = step.get("value_inputs") or []
        combined = f"{function_name}[{','.join(map(str, values))}]" if values else function_name
        annotated_step["function"] = combined

        # Chain inputs through the output_values of consumed steps.
        input_values = [
            annotated_program[inp]["output_values"]
            if inp < len(annotated_program)
            else str(node_outputs[inp])
            for inp in step.get("inputs", [])
        ]
        annotated_step["input_values"] = " ".join(input_values).strip()

        chain_list.append(
            (f"{combined} " + " ".join(map(str, step.get("inputs", [])))).strip()
        )

        base = combined.split("[")[0]
        if base in NON_SPATIAL_FUNCTIONS:
            text = str(node_outputs[i])
            if text.startswith("[") and text.endswith("]"):
                text = text[1:-1]
            annotated_step["output_values"] = text.strip()
        elif base in SPATIAL_FUNCTIONS:
            num_objects = len(scene.objects)
            annotated_step["output_values"] = " ".join(
                format_bbox(boxes[obj_idx])
                for obj_idx in relevant[i]
                if obj_idx is not None and 0 <= obj_idx < num_objects
            ).strip()
        else:
            annotated_step["output_values"] = ""
        annotated_program.append(annotated_step)

    annotated = {
        k: v
        for k, v in question.items()
        if k not in ("program", "image_filename", "split", "question_family_index")
    }
    annotated["annotated_program"] = annotated_program
    annotated["final_chain_of_thought"] = chain_list
    return annotated


def annotate_question_full(
    question: Dict[str, Any],
    scene: Scene,
    boxes: Optional[Any] = None,
    style: str = "repr1",
) -> Dict[str, Any]:
    """Input-step-grounded annotation variants.

    ``style="repr1"``: the ``full_annotation`` variant consumed by the
    step-executor trainer — 1-decimal boxes rendered with ``str(float)``
    (``[0.1 0.2 0.3 0.4]``)
    (the reference's preprocess_scenes/preprocess_full_annotation.py:232-353).
    ``style="fixed4"``: the ``continous`` v1 variant — 4-decimal fixed-width
    boxes (``[0.1234 ...]``), same record structure
    (preprocess_continous.py annotate, diff vs v3 = input-step grounding).

    Both build ``input_values`` from the *input steps'* relevant objects
    (spatial) or node outputs (non-spatial) rather than chaining
    output_values as v3 does.
    """
    program = question["program"]
    if boxes is None:
        boxes = scene_bounding_boxes(scene.raw, decimals=1 if style == "repr1" else 4)
    node_outputs, relevant = _execute_with_poisoning(scene, program)
    num_objects = len(scene.objects)

    if style == "repr1":
        def fmt(box):
            return "[%s %s %s %s]" % tuple(map(repr, map(float, box)))
    else:
        def fmt(box):
            return "[%.4f %.4f %.4f %.4f]" % tuple(map(float, box))

    def bbox_strs(obj_indices: Sequence[Any]) -> List[str]:
        return [
            fmt(boxes[obj_idx])
            for obj_idx in obj_indices
            if obj_idx is not None and 0 <= obj_idx < num_objects
        ]

    annotated_program: List[Dict[str, Any]] = []
    chain_list: List[str] = []
    for i, step in enumerate(program):
        annotated_step = {k: v for k, v in step.items() if k != "value_inputs"}
        function_name = annotated_step.get("function", "")
        values = step.get("value_inputs") or []
        combined = f"{function_name}[{','.join(map(str, values))}]" if values else function_name
        annotated_step["function"] = combined

        chain_list.append(
            (f"{combined} " + " ".join(map(str, step.get("inputs", [])))).strip()
        )

        base = combined.split("[")[0]
        if base in NON_SPATIAL_FUNCTIONS:
            cleaned = []
            for inp in step.get("inputs", []):
                text = str(node_outputs[inp])
                if text.startswith("[") and text.endswith("]"):
                    text = text[1:-1]
                cleaned.append(text)
            annotated_step["input_values"] = " ".join(cleaned).strip()
        else:
            all_boxes: List[str] = []
            for inp in step.get("inputs", []):
                if inp < len(relevant):
                    all_boxes.extend(bbox_strs(relevant[inp]))
            annotated_step["input_values"] = " ".join(all_boxes).strip()

        if base in NON_SPATIAL_FUNCTIONS:
            text = str(node_outputs[i])
            if text.startswith("[") and text.endswith("]"):
                text = text[1:-1]
            annotated_step["output_values"] = text.strip()
        elif base in SPATIAL_FUNCTIONS:
            annotated_step["output_values"] = " ".join(bbox_strs(relevant[i])).strip()
        else:
            annotated_step["output_values"] = ""
        annotated_program.append(annotated_step)

    annotated = {
        k: v
        for k, v in question.items()
        if k not in ("program", "image_filename", "split", "question_family_index")
    }
    annotated["annotated_program"] = annotated_program
    annotated["final_chain_of_thought"] = chain_list
    return annotated


_STRING_COMPARE_FUNCTIONS = frozenset({
    "count", "exist", "greater_than", "less_than", "equal_color", "equal_shape",
    "equal_size", "equal_material", "equal_integer", "equal_object",
})


def annotate_question_string(
    question: Dict[str, Any],
    scene: Scene,
    boxes: Optional[Any] = None,
) -> Dict[str, Any]:
    """Single-string annotation of the chain-of-thought IQAP: one flat
    ``annotated_program_string`` per question, steps joined by ' | ', each
    ``fn[args]:(x,y,x,y) ; ...`` with the boxes' coordinates as
    ``repr(round(c, 3))`` (so 0.1 prints as ``0.1``) or ``:none``.

    A query or compare step is attributed to the union of its input steps'
    *attributed* objects; a poisoned step renders as a bare ``fn[]:none``,
    even when the function has side inputs.
    """
    program = question["program"]
    if boxes is None:
        boxes = scene_bounding_boxes(scene.raw, decimals=None)
    node_outputs, relevant = _execute_with_poisoning(scene, program)
    num_objects = len(scene.objects)

    attributed: List[List[int]] = []
    for i, step in enumerate(program):
        function = step.get("function", "")
        if function in _STRING_COMPARE_FUNCTIONS or function.startswith("query_"):
            union: List[int] = []
            for dep in step.get("inputs", []):
                if 0 <= dep < len(attributed):
                    union.extend(attributed[dep])
            attributed.append(sorted(set(union)))
        else:
            attributed.append(list(relevant[i]))

    steps_str: List[str] = []
    for i, step in enumerate(program):
        function = step.get("function", "")
        values = step.get("value_inputs") or []
        if node_outputs[i] is None:  # poisoned: the side inputs are dropped
            steps_str.append(f"{function}[]:none")
            continue
        label = f"{function}[{','.join(map(str, values))}]"
        objs = [o for o in attributed[i] if 0 <= o < num_objects]
        if not objs:
            steps_str.append(f"{label}:none")
            continue
        rendered = " ; ".join(
            "(%s,%s,%s,%s)" % tuple(repr(round(float(c), 3)) for c in boxes[o])
            for o in objs
        )
        steps_str.append(f"{label}:{rendered}")

    annotated = dict(question)
    annotated["annotated_program_string"] = " | ".join(steps_str)
    return annotated


# ---------------------------------------------------------------------------
# Corpus sweep (parallel)
# ---------------------------------------------------------------------------

_WORKER_SCENES: Dict[int, Scene] = {}
_WORKER_BOXES: Dict[int, Any] = {}


def _init_worker(scenes: Dict[int, Scene]) -> None:
    global _WORKER_SCENES, _WORKER_BOXES
    _WORKER_SCENES = scenes
    _WORKER_BOXES = {}


def _annotate_one(question: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    image_index = question["image_index"]
    scene = _WORKER_SCENES.get(image_index)
    if scene is None:
        return None
    boxes = _WORKER_BOXES.get(image_index)
    if boxes is None:
        boxes = scene_bounding_boxes(scene.raw, decimals=4)
        _WORKER_BOXES[image_index] = boxes
    return annotate_question(question, scene, boxes)


def annotate_questions(
    questions: Sequence[Dict[str, Any]],
    scenes: Dict[int, Scene],
    num_workers: int = 0,
) -> List[Dict[str, Any]]:
    """Annotate a question corpus; ``num_workers>1`` fans out across
    processes (the reference's serial sweep over 700k questions is
    hours-scale).  The workers are spawned, not forked: the caller may hold
    threads (PyTorch's), and a forked child inherits their locks."""
    if num_workers <= 1:
        _init_worker(scenes)
        out = [_annotate_one(q) for q in questions]
        return [q for q in out if q is not None]

    ctx = mp.get_context("spawn")
    with ctx.Pool(num_workers, initializer=_init_worker, initargs=(scenes,)) as pool:
        out = pool.map(_annotate_one, questions, chunksize=256)
    return [q for q in out if q is not None]


def annotate_question_structured(
    question: Dict[str, Any],
    scene: Scene,
    boxes: Optional[Any] = None,
) -> Dict[str, Any]:
    """Structured (non-string) annotation
    (preprocess_scenes/preprocess_one_annotation.py:255-397 of the CLEVR
    reference): input and output values stay Python objects, spatial values
    as ``[{'bbox': (x, y, x, y)}]`` with 1-decimal boxes and non-spatial
    values raw; each step carries a cumulative ``chain_of_thought`` of
    function tokens; a synthetic terminal ``end`` step holds the question's
    answer.
    """
    program = question["program"]
    if boxes is None:
        boxes = scene_bounding_boxes(scene.raw, decimals=1)
    node_outputs, relevant = _execute_with_poisoning(scene, program)
    num_objects = len(scene.objects)

    def bbox_dicts(obj_indices: Sequence[Any]) -> List[Dict[str, Any]]:
        return [
            {"bbox": tuple(float(c) for c in boxes[obj_idx])}
            for obj_idx in obj_indices
            if obj_idx is not None and 0 <= obj_idx < num_objects
        ]

    annotated_program: List[Dict[str, Any]] = []
    chain_list: List[str] = []
    for i, step in enumerate(program):
        annotated_step = dict(step)
        function_name = annotated_step.get("function", "")
        values = step.get("value_inputs") or []
        combined = f"{function_name}[{','.join(map(str, values))}]" if values else function_name
        annotated_step["function"] = combined

        chain_list.append(combined)
        annotated_step["chain_of_thought"] = list(chain_list)

        base = combined.split("[")[0]
        if base in NON_SPATIAL_FUNCTIONS:
            annotated_step["input_values"] = [node_outputs[inp] for inp in step.get("inputs", [])]
            annotated_step["output_values"] = node_outputs[i]
        elif base in SPATIAL_FUNCTIONS:
            gathered: List[Dict[str, Any]] = []
            for inp in step.get("inputs", []):
                if inp < len(relevant):
                    gathered.extend(bbox_dicts(relevant[inp]))
            annotated_step["input_values"] = gathered
            annotated_step["output_values"] = bbox_dicts(relevant[i])
        else:
            annotated_step["input_values"] = []
            annotated_step["output_values"] = []
        annotated_program.append(annotated_step)

    if annotated_program:
        annotated_program.append({
            "inputs": [len(annotated_program) - 1],
            "function": "end",
            "value_inputs": [],
            "chain_of_thought": list(chain_list) + ["end"],
            "input_values": annotated_program[-1].get("output_values", []),
            "output_values": question.get("answer"),
        })

    annotated = dict(question)
    annotated["annotated_program"] = annotated_program
    return annotated
