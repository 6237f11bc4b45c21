"""CLEVR program parsing, copied from ``explainable_spatial_vqa_tpu/core/programs.py``.

Only what the inference pipeline needs: the fused-token text of a node
(``filter_size[large]``) and the arity parsers that turn a prefix or postfix
token sequence back into the list form whose ``inputs`` index earlier nodes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

__all__ = [
    "Node",
    "arity",
    "function_token",
    "parse_function_token",
    "tree_to_list",
    "prefix_to_list",
    "postfix_to_list",
]


@dataclass
class Node:
    """One program node in tree form."""

    function: str
    value_inputs: List[str] = field(default_factory=list)
    children: List["Node"] = field(default_factory=list)


# Two-input CLEVR functions; ``scene`` is nullary; everything else is unary
# (the substring test makes every equal_* binary).
_BINARY_EXACT = {"union", "intersect", "less_than", "greater_than"}


def arity(function: str) -> int:
    """Number of program inputs consumed by ``function``."""
    if function == "scene":
        return 0
    if "equal" in function or function in _BINARY_EXACT:
        return 2
    return 1


def function_token(entry: Dict[str, Any]) -> str:
    """Serialize a node dict to its fused token text: ``filter_size[large]``."""
    values = entry.get("value_inputs") or []
    if values:
        return "%s[%s]" % (entry["function"], ",".join(values))
    return entry["function"]


def parse_function_token(token: str) -> Dict[str, Any]:
    """Inverse of :func:`function_token`."""
    if "[" not in token:
        return {"function": token, "value_inputs": []}
    name, _, value_text = token.partition("[")
    value_text = value_text.replace("]", "")
    return {"function": name, "value_inputs": value_text.split(",")}


def tree_to_list(root: Node) -> List[Dict[str, Any]]:
    """Lay a tree out as a list whose inputs always point to smaller indices:
    the root takes the last slot, children go right-to-left in reverse
    pre-order."""

    def count(node: Node) -> int:
        return 1 + sum(count(c) for c in node.children)

    out: List[Dict[str, Any]] = [None] * count(root)  # type: ignore[list-item]

    def place(node: Node, idx: int) -> int:
        out[idx] = {
            "function": node.function,
            "value_inputs": list(node.value_inputs),
            "inputs": [],
        }
        next_idx = idx - 1
        for child in reversed(node.children):
            out[idx]["inputs"].insert(0, next_idx)
            next_idx = place(child, next_idx)
        return next_idx

    place(root, len(out) - 1)
    return out


def prefix_to_list(program_prefix: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Parse a prefix serialization back to list form using arity lookup."""
    items = list(program_prefix)
    pos = 0

    def parse() -> Node:
        nonlocal pos
        entry = items[pos]
        pos += 1
        node = Node(entry["function"], list(entry["value_inputs"]))
        node.children = [parse() for _ in range(arity(entry["function"]))]
        return node

    return tree_to_list(parse())


def postfix_to_list(program_postfix: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Parse a postfix serialization back to list form using arity lookup;
    children are popped right-to-left then reversed."""
    items = list(program_postfix)

    def parse() -> Node:
        entry = items.pop()
        node = Node(entry["function"], list(entry["value_inputs"]))
        node.children = [parse() for _ in range(arity(entry["function"]))][::-1]
        return node

    return tree_to_list(parse())
