"""Checkpoints with optimizer state, for exact resume, ported from
``explainable_spatial_vqa_tpu/train/checkpoints.py`` (orbax there,
``torch.save`` here).

Numbered step checkpoints ``step_{n}.pt`` (the newest ``max_to_keep``
stay) and one ``best.pt`` snapshot.  A save copies the payload's tensors to
the host at once and writes the file on a background thread, through a
temporary file renamed into place, so a reader never sees half a file;
:meth:`CheckpointStore.wait` waits for the writes and raises their errors.
Files are read with ``torch.load(weights_only=True)``: tensors, numbers,
strings and containers of them, nothing else.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, List, Optional

import torch

__all__ = ["CheckpointStore"]

_STEP_RE = re.compile(r"step_(\d+)\.pt")


def _to_host(obj: Any) -> Any:
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


class CheckpointStore:
    """Numbered step checkpoints and a 'best' snapshot in one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._best_path = os.path.join(self.directory, "best.pt")
        self._writer = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []

    def _write(self, path: str, payload: Any) -> None:
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def _submit(self, fn, *args) -> None:
        self._pending.append(self._writer.submit(fn, *args))

    def _steps(self) -> List[int]:
        found = (_STEP_RE.fullmatch(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _prune(self) -> None:
        for step in self._steps()[:-self.max_to_keep]:
            os.remove(os.path.join(self.directory, f"step_{step}.pt"))

    def save(self, step: int, state: Any) -> None:
        self._submit(self._write, os.path.join(self.directory, f"step_{step}.pt"), _to_host(state))
        self._submit(self._prune)

    def save_best(self, state: Any) -> None:
        self._submit(self._write, self._best_path, _to_host(state))

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None) -> Any:
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        self.wait()
        return torch.load(os.path.join(self.directory, f"step_{step}.pt"), weights_only=True)

    def restore_best(self) -> Any:
        self.wait()
        if not os.path.exists(self._best_path):
            return None
        return torch.load(self._best_path, weights_only=True)

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for future in pending:
            future.result()

    def close(self) -> None:
        self.wait()
        self._writer.shutdown()
