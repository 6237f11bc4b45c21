"""Tracing and profiling, ported from ``explainable_spatial_vqa_tpu/utils/profiling.py``.

- ``phase``: accumulating wall-clock phase timer with a process-wide
  registry and report (a copy).
- ``trace(log_dir)``: ``torch.profiler.profile`` over the CPU and, when CUDA
  is available, the card; on exit it writes a Chrome trace
  ``trace-<pid>-<n>.json`` into ``log_dir`` (kernels by name, host calls,
  the ``annotate`` regions).  Nothing happens when ``log_dir`` is falsy.
- ``annotate(name)``: a labelled region, ``torch.profiler.record_function``
  (seen in a trace) plus an NVTX range once CUDA is initialised (seen by
  Nsight tools).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger(__name__)

__all__ = ["phase", "phase_report", "reset_phases", "trace", "annotate"]

_PHASES: Dict[str, float] = defaultdict(float)
_COUNTS: Dict[str, int] = defaultdict(int)
_TRACES = itertools.count()


@contextlib.contextmanager
def phase(name: str, log: bool = False) -> Iterator[None]:
    """Accumulating wall-clock timer: ``with phase("annotate"): ...``."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _PHASES[name] += dt
        _COUNTS[name] += 1
        if log:
            logger.info("phase %s: %.3fs", name, dt)


def phase_report() -> str:
    lines = ["phase timings:"]
    for name in sorted(_PHASES, key=_PHASES.get, reverse=True):  # type: ignore[arg-type]
        lines.append(
            f"  {name}: {_PHASES[name]:.3f}s total / {_COUNTS[name]} calls"
            f" = {_PHASES[name] / max(_COUNTS[name], 1):.4f}s each"
        )
    return "\n".join(lines)


def reset_phases() -> None:
    _PHASES.clear()
    _COUNTS.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[Optional[str]]:
    """Profile the block and write its Chrome trace into ``log_dir``; yields
    the trace file's path (None, and no profiling, when ``log_dir`` is
    falsy).  The file is written when the block exits."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{next(_TRACES)}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
    logger.info("wrote trace %s", path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label a region inside a traced step."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield
