"""Bounding boxes from CLEVR scene graphs, copied from
``explainable_spatial_vqa_tpu/clevr/bboxes.py``.

CLEVR ships no ground-truth boxes; they are derived from each object's
``pixel_coords`` + ``3d_coords`` and the camera's right direction, with
shape-specific perspective corrections for cylinders and cubes, normalized to
the 480x320 render and clipped to [0, 1].  ``decimals`` selects the rounding:
4 (the canonical annotation), 1, or none.  The main entry point is
vectorized over all objects of a scene with NumPy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "approximate_bounding_box",
    "scene_bounding_boxes",
    "generate_label_map",
    "scene_class_labels",
    "format_bbox",
]

IMAGE_W, IMAGE_H = 480.0, 320.0


def scene_bounding_boxes(scene_raw: Dict[str, Any], decimals: Optional[int] = 4) -> np.ndarray:
    """Boxes ``(num_objects, 4)`` as (xmin, ymin, xmax, ymax) in [0,1].

    Vectorized over objects.  ``decimals=None`` skips rounding
    (get_bounding_boxes.py mode); 4 is the thesis-canonical v3 mode; 1 is the
    preprocess_full_annotation mode.
    """
    objects = scene_raw["objects"]
    n = len(objects)
    if n == 0:
        return np.zeros((0, 4), dtype=np.float64)

    px = np.array([o["pixel_coords"] for o in objects], dtype=np.float64)  # (n, 3)
    p3 = np.array([o["3d_coords"] for o in objects], dtype=np.float64)  # (n, 3)
    cos_t, sin_t, _ = scene_raw["directions"]["right"]

    x, y = px[:, 0], px[:, 1]
    x3d, y3d, z3d = p3[:, 0], p3[:, 1], p3[:, 2]

    # Rotate ground-plane coordinates into the camera frame.
    y1 = x3d * (-sin_t) + y3d * cos_t

    base = 6.9 * z3d * (15.0 - y1) / 2.0
    height_d = base.copy()
    height_u = base.copy()
    width_l = base.copy()
    width_r = base.copy()

    shapes = np.array([o["shape"] for o in objects])

    is_cyl = shapes == "cylinder"
    if is_cyl.any():
        d = 9.4 + y1
        h = 6.4
        s = z3d
        num = s * (h / d + 1.0)
        ratio = num / (num - s * (h - s) / d)
        hu = base * ratio
        hd = hu * (h - s + d) / (h + s + d)
        wl = base * (11.0 / (10.0 + y1))
        height_u = np.where(is_cyl, hu, height_u)
        height_d = np.where(is_cyl, hd, height_d)
        width_l = np.where(is_cyl, wl, width_l)
        width_r = np.where(is_cyl, wl, width_r)

    is_cube = shapes == "cube"
    if is_cube.any():
        hu = base * (1.3 * 10.0 / (10.0 + y1))
        for arr in (height_u, height_d, width_l, width_r):
            np.copyto(arr, hu, where=is_cube)

    xmin = np.clip((x - width_l) / IMAGE_W, 0.0, 1.0)
    xmax = np.clip((x + width_r) / IMAGE_W, 0.0, 1.0)
    ymin = np.clip((y - height_d) / IMAGE_H, 0.0, 1.0)
    ymax = np.clip((y + height_u) / IMAGE_H, 0.0, 1.0)

    boxes = np.stack([xmin, ymin, xmax, ymax], axis=1)
    if decimals is not None:
        # np.round uses banker's rounding, as does Python round() — parity holds.
        boxes = np.round(boxes, decimals)
    return boxes


def approximate_bounding_box(
    obj: Dict[str, Any], scene_raw: Dict[str, Any], decimals: Optional[int] = 4
) -> Tuple[float, float, float, float]:
    """Single-object convenience wrapper (reference call signature)."""
    objects = scene_raw["objects"]
    idx = next(
        (i for i, o in enumerate(objects) if o is obj),
        None,
    )
    if idx is None:
        idx = objects.index(obj)
    box = scene_bounding_boxes(scene_raw, decimals)[idx]
    return (float(box[0]), float(box[1]), float(box[2]), float(box[3]))


def format_bbox(box: Sequence[float]) -> str:
    """Text form used in annotation records: ``[0.1234 0.5678 0.9012 0.3456]``."""
    return "[%.4f %.4f %.4f %.4f]" % (box[0], box[1], box[2], box[3])


# ---------------------------------------------------------------------------
# 96-way attribute-combination class labels (get_bounding_boxes.py:20-45)
# ---------------------------------------------------------------------------

SIZES = ["large", "small"]
COLORS = ["gray", "red", "blue", "green", "brown", "purple", "cyan", "yellow"]
MATERIALS = ["rubber", "metal"]
SHAPES = ["cube", "sphere", "cylinder"]


def generate_label_map() -> Tuple[List[str], Dict[str, int]]:
    """All 'size color material shape' combinations, sorted; ids start at 1."""
    names = sorted(
        f"{s} {c} {m} {sh}" for s in SIZES for c in COLORS for m in MATERIALS for sh in SHAPES
    )
    return names, {name: i + 1 for i, name in enumerate(names)}


def scene_class_labels(scene_raw: Dict[str, Any], label_to_id: Dict[str, int]) -> np.ndarray:
    labels = np.zeros(len(scene_raw["objects"]), dtype=np.int32)
    for j, obj in enumerate(scene_raw["objects"]):
        name = f"{obj['size']} {obj['color']} {obj['material']} {obj['shape']}"
        labels[j] = label_to_id.get(name, 0)
    return labels


def export_scenes(
    scenes: Sequence[Dict[str, Any]], decimals: Optional[int] = None
) -> Dict[str, Any]:
    """Build the scenes-h5 arrays: padded boxes, class labels, indices, names.

    ``decimals=None`` matches get_bounding_boxes.py (no rounding before
    float32 storage).
    """
    _, label_to_id = generate_label_map()
    num_scenes = len(scenes)
    max_objects = max((len(s["objects"]) for s in scenes), default=0)
    bounding_boxes = np.zeros((num_scenes, max_objects, 4), dtype=np.float32)
    class_labels = np.zeros((num_scenes, max_objects), dtype=np.int32)
    image_index = np.zeros((num_scenes,), dtype=np.int32)
    image_filenames: List[str] = []
    for i, scene_raw in enumerate(scenes):
        image_index[i] = scene_raw["image_index"]
        image_filenames.append(scene_raw["image_filename"])
        boxes = scene_bounding_boxes(scene_raw, decimals)
        k = boxes.shape[0]
        bounding_boxes[i, :k] = boxes
        class_labels[i, :k] = scene_class_labels(scene_raw, label_to_id)
    return {
        "bounding_boxes": bounding_boxes,
        "class_labels": class_labels,
        "image_index": image_index,
        "image_filename": image_filenames,
    }
