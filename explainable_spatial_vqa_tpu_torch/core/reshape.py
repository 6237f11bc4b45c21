"""H5 layout utilities, ported from
``explainable_spatial_vqa_tpu/core/reshape.py``:

- :func:`export_scene_attributes`: per-scene (attributes, coords_3d,
  coords_pixel) arrays with a unified sorted 'category=value' vocab, ids
  from 1 (:func:`build_attribute_vocab`);
- :func:`save_questions_grouped` / :func:`flatten_question_groups` /
  :func:`read_question_groups`: the per-question h5 group layout, its
  root-level flattening, and either read back;
- :func:`stream_split_questions`: a bounded-memory splitter of question
  JSONs too large to hold in memory, by an incremental scanner over the
  questions array.

``h5py`` is imported inside the functions that need it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "build_attribute_vocab",
    "export_scene_attributes",
    "save_questions_grouped",
    "flatten_question_groups",
    "read_question_groups",
    "stream_split_questions",
]


def build_attribute_vocab(scenes: Sequence[Dict[str, Any]]) -> Dict[str, int]:
    """Unified 'category=value' vocab, sorted, ids starting at 1."""
    entries: set = set()
    for scene in scenes:
        for obj in scene["objects"]:
            for category in ("shape", "color", "material", "size"):
                entries.add(f"{category}={obj[category]}")
    return {value: i for i, value in enumerate(sorted(entries), start=1)}


def export_scene_attributes(
    scenes: Sequence[Dict[str, Any]],
) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Arrays: image_index (N,), attributes (N, max_obj, 4) as [shape, color,
    material, size] codes, coords_3d / coords_pixel (N, max_obj, 3)."""
    vocab = build_attribute_vocab(scenes)
    num_scenes = len(scenes)
    max_objects = max((len(s["objects"]) for s in scenes), default=0)
    image_index = np.zeros((num_scenes,), np.int32)
    attributes = np.zeros((num_scenes, max_objects, 4), np.int32)
    coords_3d = np.zeros((num_scenes, max_objects, 3), np.float32)
    coords_pixel = np.zeros((num_scenes, max_objects, 3), np.float32)
    for i, scene in enumerate(scenes):
        image_index[i] = scene["image_index"]
        for j, obj in enumerate(scene["objects"]):
            attributes[i, j] = [
                vocab[f"shape={obj['shape']}"],
                vocab[f"color={obj['color']}"],
                vocab[f"material={obj['material']}"],
                vocab[f"size={obj['size']}"],
            ]
            coords_3d[i, j] = obj["3d_coords"]
            coords_pixel[i, j] = obj["pixel_coords"]
    arrays = {
        "image_index": image_index,
        "attributes": attributes,
        "coords_3d": coords_3d,
        "coords_pixel": coords_pixel,
    }
    return arrays, vocab


def save_questions_grouped(questions: Sequence[Dict[str, Any]], path: str) -> None:
    """questions/question_{i}/<key> JSON-string datasets."""
    import h5py

    dt = h5py.string_dtype(encoding="utf-8")
    with h5py.File(path, "w") as f:
        group = f.create_group("questions")
        for i, question in enumerate(questions):
            sub = group.create_group(f"question_{i}")
            for key, value in question.items():
                sub.create_dataset(key, data=json.dumps(value), dtype=dt)


def flatten_question_groups(input_path: str, output_path: str) -> None:
    """Lift questions/<name> groups to the root of a new file."""
    import h5py

    with h5py.File(input_path, "r") as src, h5py.File(output_path, "w") as dst:
        if "questions" not in src:
            raise KeyError("no 'questions' group in source file")
        for key in src["questions"].keys():
            dst.copy(src["questions"][key], key)


def read_question_groups(path: str, flat: bool = False) -> List[Dict[str, Any]]:
    """Read either layout back to question dicts (ordered by index)."""
    import h5py

    out: List[Dict[str, Any]] = []
    with h5py.File(path, "r") as f:
        root = f if flat else f["questions"]
        names = sorted(root.keys(), key=lambda n: int(n.rsplit("_", 1)[1]))
        for name in names:
            group = root[name]
            record = {}
            for key in group.keys():
                blob = group[key][()]
                if isinstance(blob, bytes):
                    blob = blob.decode("utf-8")
                record[key] = json.loads(blob)
            out.append(record)
    return out


def stream_split_questions(
    input_json: str, output_dir: str, chunk_size: int = 10000,
    prefix: str = "questions_part", read_block: int = 1 << 20,
) -> List[str]:
    """Split a larger-than-RAM questions JSON into chunk files.

    The file is read in blocks, records are parsed incrementally with raw_decode, and
    the consumed prefix of the buffer is discarded — resident memory is
    O(read_block + one output chunk), independent of file size."""
    os.makedirs(output_dir, exist_ok=True)
    decoder = json.JSONDecoder()
    paths: List[str] = []
    chunk: List[Dict[str, Any]] = []

    def flush() -> None:
        nonlocal chunk
        if not chunk:
            return
        path = os.path.join(output_dir, f"{prefix}_{len(paths):04d}.json")
        with open(path, "w") as f:
            json.dump({"questions": chunk}, f)
        paths.append(path)
        chunk = []

    with open(input_json, "r") as f:
        buf = ""
        # locate the start of the questions array, reading as needed
        while True:
            idx = buf.find('"questions"')
            if idx >= 0:
                bracket = buf.find("[", idx)
                if bracket >= 0:
                    buf = buf[bracket + 1 :]
                    break
            more = f.read(read_block)
            if not more:
                raise ValueError("no 'questions' array found")
            # keep a tail in case the marker straddles a block boundary
            buf = buf[-32:] + more if idx < 0 else buf + more

        pos = 0
        done = False
        while not done:
            while True:
                while pos < len(buf) and buf[pos] in " \t\r\n,":
                    pos += 1
                if pos >= len(buf):
                    break  # need more data
                if buf[pos] == "]":
                    done = True
                    break
                try:
                    record, end = decoder.raw_decode(buf, pos)
                except json.JSONDecodeError:
                    break  # record truncated at buffer end; need more data
                chunk.append(record)
                pos = end
                if len(chunk) >= chunk_size:
                    flush()
            if done:
                break
            buf = buf[pos:]
            pos = 0
            more = f.read(read_block)
            if not more:
                done = True
            buf += more
    flush()
    return paths
