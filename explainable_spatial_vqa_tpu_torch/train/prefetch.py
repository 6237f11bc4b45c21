"""Host-side input prefetching, ported from
``explainable_spatial_vqa_tpu/train/prefetch.py`` with the JAX trainer's
``_put`` (one device, no mesh).

A background thread assembles each batch (gathers, transforms), turns its
arrays into tensors and moves them to the device: on a CUDA device from
pinned host memory with ``non_blocking=True``, so the copy runs while the
host goes on.  The copies are issued on the thread's current stream, the
default one, which the training step runs on too, so a step never reads a
batch before its copy ends.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch

__all__ = ["prefetch", "to_device"]

_SENTINEL = object()


def to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """numpy arrays and scalars (and tensors) of ``batch`` as tensors on
    ``device``; other values as they are."""
    out = {}
    for key, value in batch.items():
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value))
        elif isinstance(value, np.generic):  # e.g. the scheduled trainer's p_sample
            value = torch.from_numpy(np.asarray(value))
        if isinstance(value, torch.Tensor) and value.device != device:
            if device.type == "cuda" and value.device.type == "cpu":
                value = value.pin_memory().to(device, non_blocking=True)
            else:
                value = value.to(device)
        out[key] = value
    return out


def prefetch(iterable: Iterable[Dict[str, Any]], device: torch.device,
             depth: int = 2) -> Iterator[Dict[str, Any]]:
    """Yield the batches of ``iterable`` on ``device``, produced up to
    ``depth`` ahead by a daemon thread.  An exception in the producer is
    raised at the consumer; a consumer that stops early stops the producer
    at its next batch."""
    q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item: Any) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def producer() -> None:
        try:
            for item in iterable:
                if not put(to_device(item, device)):
                    return
        except BaseException as exc:  # noqa: BLE001 — raised again at the consumer
            put(exc)
            return
        put(_SENTINEL)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
