"""The host part of feature extraction, ported from
``explainable_spatial_vqa_tpu/vision/extract.py``: the image directory's
PNGs in index order (:func:`collect_image_paths`) and the reference-exact
PIL decode and bicubic resize (:func:`_decode_resize_pil`), which the
from-pixels YOLO prototype trains on.  PIL is imported inside the call.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["collect_image_paths"]


def collect_image_paths(image_dir: str, max_images: Optional[int] = None) -> List[str]:
    """The directory's *.png sorted by their trailing index, which must run
    densely over 0..N-1."""
    entries: List[Tuple[str, int]] = []
    for fn in os.listdir(image_dir):
        if not fn.endswith(".png"):
            continue
        idx = int(os.path.splitext(fn)[0].split("_")[-1])
        entries.append((os.path.join(image_dir, fn), idx))
    entries.sort(key=lambda e: e[1])
    if not entries:
        raise ValueError("No valid images found in the input directory.")
    indices = [i for _, i in entries]
    assert len(set(indices)) == len(entries)
    assert min(indices) == 0 and max(indices) == len(entries) - 1
    if max_images is not None:
        entries = entries[:max_images]
    return [p for p, _ in entries]


def _decode_resize_pil(path: str, size: Tuple[int, int]) -> np.ndarray:
    """PIL decode to RGB and BICUBIC resize to ``size`` (H, W) on uint8,
    re-quantized to uint8 by PIL: (H, W, 3) uint8."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((size[1], size[0]), Image.BICUBIC)  # PIL takes (W, H)
    return np.asarray(img, np.uint8)
