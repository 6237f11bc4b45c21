"""CLEVR program parsing, copied from ``explainable_spatial_vqa_tpu/core/programs.py``.

A program is a list of nodes ``{"function", "value_inputs", "inputs"}``
whose ``inputs`` index earlier nodes.  Here: the fused-token text of a node
(``filter_size[large]``), the prefix/postfix serializations a question's
program is encoded in, and the arity parsers that turn a prefix or postfix
token sequence back into the list form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

__all__ = [
    "Node",
    "arity",
    "function_token",
    "parse_function_token",
    "is_chain",
    "list_to_tree",
    "tree_to_list",
    "list_to_prefix",
    "list_to_postfix",
    "prefix_to_list",
    "postfix_to_list",
    "program_to_str",
    "program_tokens",
]


@dataclass
class Node:
    """One program node in tree form."""

    function: str
    value_inputs: List[str] = field(default_factory=list)
    children: List["Node"] = field(default_factory=list)

    def to_flat(self) -> Dict[str, Any]:
        return {"function": self.function, "value_inputs": list(self.value_inputs)}


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


def is_chain(program_list: Sequence[Dict[str, Any]]) -> bool:
    """True iff the program is a pure chain (every node used, all arity<=1).

    Walk from the root following single inputs; any two-input node makes it
    non-chain, and every node must be visited.
    """
    if not program_list:
        return False
    visited = [False] * len(program_list)
    cur = len(program_list) - 1
    while True:
        visited[cur] = True
        inputs = program_list[cur]["inputs"]
        if len(inputs) == 0:
            break
        if len(inputs) > 1:
            return False
        cur = inputs[0]
    return all(visited)


def list_to_tree(program_list: Sequence[Dict[str, Any]]) -> Node:
    """Build the explicit tree rooted at the last list entry."""

    def build(idx: int) -> Node:
        entry = program_list[idx]
        return Node(
            function=entry["function"],
            value_inputs=list(entry["value_inputs"]),
            children=[build(i) for i in entry["inputs"]],
        )

    return build(len(program_list) - 1)


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


def _prefix_of(node: Node, out: List[Dict[str, Any]]) -> None:
    out.append(node.to_flat())
    for child in node.children:
        _prefix_of(child, out)


def _postfix_of(node: Node, out: List[Dict[str, Any]]) -> None:
    for child in node.children:
        _postfix_of(child, out)
    out.append(node.to_flat())


def list_to_prefix(program_list: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    _prefix_of(list_to_tree(program_list), out)
    return out


def list_to_postfix(program_list: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    _postfix_of(list_to_tree(program_list), out)
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


def program_tokens(program_list: Sequence[Dict[str, Any]], mode: str = "postfix") -> List[str]:
    """Fused-token serialization of a program in the given linearization mode.

    ``mode``: 'chain' (None-equivalent -> raises), 'prefix', 'postfix', or
    'list' (raw order).  Returns the token list (no specials).
    """
    if mode == "chain":
        if not is_chain(program_list):
            raise ValueError("program is not a chain")
        entries: Sequence[Dict[str, Any]] = program_list
    elif mode == "prefix":
        entries = list_to_prefix(program_list)
    elif mode == "postfix":
        entries = list_to_postfix(program_list)
    elif mode == "list":
        entries = program_list
    else:
        raise ValueError(f"unknown mode {mode!r}")
    return [function_token(e) for e in entries]


def program_to_str(program_list: Sequence[Dict[str, Any]], mode: str = "postfix") -> str:
    """Space-joined fused-token program string."""
    return " ".join(program_tokens(program_list, mode))
