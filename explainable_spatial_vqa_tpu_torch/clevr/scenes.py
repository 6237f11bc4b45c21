"""CLEVR scene graphs, copied from ``explainable_spatial_vqa_tpu/clevr/scenes.py``.

A raw CLEVR scene record holds ``objects`` (attribute dicts with
``pixel_coords``/``3d_coords``), ``relationships`` (per relation, a list of
related-object lists indexed by subject), and camera ``directions``.  For
execution :class:`Scene` precomputes

- ``relationships[rel][subject] -> [objects]`` as a dict keyed by subject
  index, and
- ``same_<attr>[i] -> [j != i with equal attr]`` for the four attributes.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

ATTRIBUTES = ("color", "shape", "size", "material")

__all__ = ["Scene", "load_scenes", "ATTRIBUTES"]


@dataclass
class Scene:
    """A CLEVR scene with precomputed relation and same-attribute indices."""

    raw: Dict[str, Any]
    relationships: Dict[str, Dict[int, List[int]]] = field(default_factory=dict)
    same_attr: Dict[str, Dict[int, List[int]]] = field(default_factory=dict)

    @property
    def objects(self) -> List[Dict[str, Any]]:
        return self.raw["objects"]

    @property
    def image_index(self) -> int:
        return self.raw["image_index"]

    @classmethod
    def from_raw(cls, raw: Dict[str, Any]) -> "Scene":
        scene = cls(raw=raw)
        for relation, rel_list in raw.get("relationships", {}).items():
            index: Dict[int, List[int]] = {}
            for subject_idx, related in enumerate(rel_list):
                index.setdefault(subject_idx, []).extend(related)
            scene.relationships[relation] = index
        objects = raw["objects"]
        for attr in ATTRIBUTES:
            values = [obj[attr] for obj in objects]
            same: Dict[int, List[int]] = {}
            for i, vi in enumerate(values):
                same[i] = [j for j, vj in enumerate(values) if i != j and vi == vj]
            scene.same_attr[attr] = same
        return scene


def load_scenes(path: str) -> Dict[int, Scene]:
    """Load a CLEVR scenes JSON into {image_index: Scene}."""
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return {s["image_index"]: Scene.from_raw(s) for s in data["scenes"]}
