"""Box visualization, ported from
``explainable_spatial_vqa_tpu/utils/visualize.py``: the vectorized YOLO
grid decode (:func:`decode_yolo_grid`) and box drawing on a PIL image
(:func:`draw_boxes`; PIL is imported inside the call)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["decode_yolo_grid", "draw_boxes"]


def decode_yolo_grid(prediction: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """(S, S, 5) cell-relative [x, y, w, h, conf] -> (K, 5) normalized
    [xmin, ymin, xmax, ymax, conf] for cells above threshold."""
    prediction = np.asarray(prediction)
    grid = prediction.shape[0]
    ii, jj = np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij")
    x_center = (jj + prediction[..., 0]) / grid
    y_center = (ii + prediction[..., 1]) / grid
    half_w = prediction[..., 2] / 2.0
    half_h = prediction[..., 3] / 2.0
    boxes = np.stack(
        [x_center - half_w, y_center - half_h, x_center + half_w, y_center + half_h,
         prediction[..., 4]],
        axis=-1,
    ).reshape(-1, 5)
    return boxes[boxes[:, 4] > threshold]


def draw_boxes(
    image,
    boxes: Sequence[Sequence[float]],
    color: str = "red",
    width: int = 2,
    labels: Optional[Sequence[str]] = None,
):
    """Draw normalized-coordinate boxes on a PIL image (in place; returned).

    Degenerate boxes (xmax < xmin or ymax < ymin) are skipped, matching the
    reference's guard."""
    from PIL import ImageDraw

    draw = ImageDraw.Draw(image)
    w, h = image.size
    for idx, box in enumerate(boxes):
        xmin, ymin, xmax, ymax = box[:4]
        left, top = int(xmin * w), int(ymin * h)
        right, bottom = int(xmax * w), int(ymax * h)
        if right < left or bottom < top:
            continue
        draw.rectangle([left, top, right, bottom], outline=color, width=width)
        if labels is not None and idx < len(labels):
            draw.text((left + 2, top + 2), str(labels[idx]), fill=color)
    return image
