"""Shared helpers of the demos, ported from ``scripts/demo_common.py``:
the markdown section splice, the device and platform label, and the
synthetic corpus every demo builds the same way."""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.clevr import annotate as ann
from explainable_spatial_vqa_tpu_torch.clevr import synthetic as syn
from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene
from explainable_spatial_vqa_tpu_torch.core import vocab as voc
from explainable_spatial_vqa_tpu_torch.device import resolve_device

__all__ = ["REPO_ROOT", "DEFAULT_OUT", "out_path", "splice_section", "demo_device",
           "platform_label", "results_path", "feature_maps", "synthetic_corpus", "held_out"]

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = REPO_ROOT / "DEMO_TORCH.md"
_REFERENCE_DEMO = REPO_ROOT / "DEMO.md"  # the JAX package's record: never written here


def out_path(out_env: str = "DEMO_OUT") -> Path:
    """``$DEMO_OUT``, else ``DEMO_TORCH.md`` at the repository root; raises
    if it names the JAX package's ``DEMO.md``."""
    path = Path(os.environ.get(out_env) or DEFAULT_OUT)
    if path.resolve() == _REFERENCE_DEMO:
        raise ValueError(f"{path} is the JAX package's record; the port writes {DEFAULT_OUT.name} "
                         f"or $DEMO_OUT")
    return path


def splice_section(section: str, begin: str, end: str, out_env: str = "DEMO_OUT") -> str:
    """Idempotently replace the ``begin``..``end`` marker block in
    ``DEMO_TORCH.md`` (or ``$DEMO_OUT``) with ``section``, appending it if
    the markers are absent.  Returns the path written."""
    path = out_path(out_env)
    text = path.read_text() if path.exists() else ""
    if begin in text and end in text:
        pre, rest = text.split(begin, 1)
        _, post = rest.split(end, 1)
        text = pre + section + post
    else:
        text = text.rstrip() + "\n\n" + section + "\n"
    path.write_text(text)
    return str(path)


def demo_device() -> torch.device:
    """``$DEMO_DEVICE`` (default ``cuda``); raises without a card unless it
    is ``cpu``."""
    return resolve_device(os.environ.get("DEMO_DEVICE", "cuda"))


def platform_label(device: torch.device) -> str:
    """The platform as a section names it: ``cpu``, or ``cuda`` with the
    card's name and power limit as ``nvidia-smi`` gives them."""
    if device.type != "cuda":
        return device.type
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        smi = []
    index = device.index or 0
    card = smi[index] if index < len(smi) else torch.cuda.get_device_name(device)
    return f"cuda ({card})"


def results_path(name: str) -> str:
    """``results/<name>`` at the repository root (its directory made)."""
    path = REPO_ROOT / "results" / name
    path.parent.mkdir(parents=True, exist_ok=True)
    return str(path)


def feature_maps(scenes_raw: Sequence[Dict[str, Any]]) -> np.ndarray:
    """(N, 196, 64) float32 token features of the synthetic scenes."""
    return np.stack([syn.scene_feature_map(s).reshape(64, -1).T
                     for s in scenes_raw]).astype(np.float32)


def synthetic_corpus(num_scenes: int, qps: int, seed: int, **synth_kwargs
                     ) -> Tuple[List[dict], List[dict], List[dict], Dict, np.ndarray]:
    """The scripts' corpus: (raw scenes, questions, annotated questions,
    split vocab, features) from ``synthesize_dataset``."""
    scenes_raw, questions = syn.synthesize_dataset(num_scenes, qps, seed=seed, **synth_kwargs)
    scenes = {s["image_index"]: Scene.from_raw(s) for s in scenes_raw}
    annotated = ann.annotate_questions(questions, scenes)
    return scenes_raw, questions, annotated, voc.build_split_vocab(annotated), feature_maps(
        scenes_raw)


def held_out(records: Sequence[dict], num_scenes: int) -> Tuple[List[dict], List[dict]]:
    """The scripts' 80/20 scene split: (records on the first 80% of scenes,
    the rest)."""
    train = set(range(int(num_scenes * 0.8)))
    return ([r for r in records if r["image_index"] in train],
            [r for r in records if r["image_index"] not in train])
