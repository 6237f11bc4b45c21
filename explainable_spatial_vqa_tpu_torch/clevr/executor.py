"""Symbolic CLEVR program executor, copied from
``explainable_spatial_vqa_tpu/clevr/executor.py``.

Evaluates functional programs over :class:`~explainable_spatial_vqa_tpu_torch.clevr.
scenes.Scene` graphs.  Node values are object-index lists (spatial sets),
single object indices (after ``unique``), attribute strings, ints, or bools;
an impossible step yields the ``INVALID`` sentinel and execution
short-circuits.  The same 28 functions as the CLEVR reference executor, with
its set semantics (union/intersect results sorted), its ``unique``
invalidation rule and its boolean/int comparisons.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

from explainable_spatial_vqa_tpu_torch.clevr.scenes import ATTRIBUTES, Scene

__all__ = ["INVALID", "Executor", "execute_program", "FUNCTION_CATALOG",
           "SPATIAL_FUNCTIONS", "NON_SPATIAL_FUNCTIONS"]

INVALID = "__INVALID__"

# Output-type classification used by the annotation pipeline
# (preprocess_continousv3.py:344-352): spatial functions emit object sets
# (annotated as bounding boxes); non-spatial functions emit value tokens.
SPATIAL_FUNCTIONS = frozenset({
    "scene", "filter_color", "filter_shape", "filter_material", "filter_size",
    "filter_objectcategory", "relate", "union", "intersect", "unique",
    "same_color", "same_shape", "same_size", "same_material",
})
NON_SPATIAL_FUNCTIONS = frozenset({
    "count", "exist", "query_color", "query_shape", "query_material",
    "query_size", "equal_integer", "less_than", "greater_than", "equal_color",
    "equal_shape", "equal_size", "equal_material", "equal_object",
})


class Executor:
    """Executes CLEVR programs against a single scene."""

    def __init__(self, scene: Scene):
        self.scene = scene

    # -- spatial primitives -------------------------------------------------

    def _scene(self, inputs: Sequence[Any], side: Sequence[str]) -> List[int]:
        return list(range(len(self.scene.objects)))

    def _filter(self, attribute: str, inputs: Sequence[Any], side: Sequence[str]) -> Any:
        (candidates,), (value,) = inputs, side
        objects = self.scene.objects
        return [i for i in candidates if objects[i][attribute] == value]

    def _unique(self, inputs: Sequence[Any], side: Sequence[str]) -> Any:
        (candidates,) = inputs
        if len(candidates) != 1:
            return INVALID
        return candidates[0]

    def _relate(self, inputs: Sequence[Any], side: Sequence[str]) -> List[int]:
        (subject,), (relation,) = inputs, side
        return list(self.scene.relationships.get(relation, {}).get(subject, []))

    def _union(self, inputs: Sequence[Any], side: Sequence[str]) -> List[int]:
        a, b = inputs
        return sorted(set(a) | set(b))

    def _intersect(self, inputs: Sequence[Any], side: Sequence[str]) -> List[int]:
        a, b = inputs
        return sorted(set(a) & set(b))

    def _same(self, attribute: str, inputs: Sequence[Any], side: Sequence[str]) -> List[int]:
        (subject,) = inputs
        return list(self.scene.same_attr[attribute].get(subject, []))

    # -- value primitives ---------------------------------------------------

    def _count(self, inputs: Sequence[Any], side: Sequence[str]) -> int:
        return len(inputs[0])

    def _exist(self, inputs: Sequence[Any], side: Sequence[str]) -> bool:
        return len(inputs[0]) > 0

    def _query(self, attribute: str, inputs: Sequence[Any], side: Sequence[str]) -> Any:
        value = self.scene.objects[inputs[0]][attribute]
        if isinstance(value, list):
            if len(value) != 1:
                return INVALID
            return value[0]
        return value

    def _equal(self, inputs: Sequence[Any], side: Sequence[str]) -> bool:
        return inputs[0] == inputs[1]

    def _less(self, inputs: Sequence[Any], side: Sequence[str]) -> bool:
        return inputs[0] < inputs[1]

    def _greater(self, inputs: Sequence[Any], side: Sequence[str]) -> bool:
        return inputs[0] > inputs[1]

    # -- dispatch -----------------------------------------------------------

    def apply(self, function: str, inputs: Sequence[Any], side_inputs: Sequence[str]) -> Any:
        handler = FUNCTION_CATALOG.get(function)
        if handler is None:
            raise ValueError(f"Unknown function type: {function}")
        return handler(self, inputs, side_inputs)

    def run(self, program: Sequence[Dict[str, Any]]) -> List[Any]:
        """Execute a node list; returns per-node outputs, short-circuiting on
        the first INVALID (matching answer_question,
        preprocess_continousv3.py:158-176)."""
        outputs: List[Any] = []
        for node in program:
            function = node.get("type") or node.get("function")
            inputs = [outputs[i] for i in node.get("inputs", [])]
            side = node.get("side_inputs") or node.get("value_inputs") or []
            value = self.apply(function, inputs, side)
            outputs.append(value)
            if value == INVALID:
                break
        return outputs


def _make_catalog() -> Dict[str, Callable[..., Any]]:
    catalog: Dict[str, Callable[..., Any]] = {
        "scene": Executor._scene,
        "unique": Executor._unique,
        "relate": Executor._relate,
        "union": Executor._union,
        "intersect": Executor._intersect,
        "count": Executor._count,
        "exist": Executor._exist,
        "less_than": Executor._less,
        "greater_than": Executor._greater,
        "equal_integer": Executor._equal,
        "equal_object": Executor._equal,
    }
    for attr in ATTRIBUTES:
        catalog[f"filter_{attr}"] = _bind_attr(Executor._filter, attr)
        catalog[f"same_{attr}"] = _bind_attr(Executor._same, attr)
        catalog[f"query_{attr}"] = _bind_attr(Executor._query, attr)
        catalog[f"equal_{attr}"] = Executor._equal
    catalog["filter_objectcategory"] = _bind_attr(Executor._filter, "objectcategory")
    return catalog


def _bind_attr(method: Callable[..., Any], attribute: str) -> Callable[..., Any]:
    def bound(self: Executor, inputs: Sequence[Any], side: Sequence[str]) -> Any:
        return method(self, attribute, inputs, side)

    return bound


FUNCTION_CATALOG: Dict[str, Callable[..., Any]] = _make_catalog()


def execute_program(scene: Scene, program: Sequence[Dict[str, Any]]) -> List[Any]:
    """Convenience wrapper: run ``program`` on ``scene``; returns node outputs."""
    return Executor(scene).run(program)
