"""Time the CoGenT protocol through the port's CLI, part by part.

    python -m explainable_spatial_vqa_tpu_torch.bench_cogent [--log FILE] \\
        -- [cogent-protocol flags]

Runs ``cli.main.main(["cogent-protocol", *flags])`` in this process (its
report and table go to stdout as usual) under :class:`ProtocolParts`, then
prints one JSON line: the CLI's wall time (host clock, from the call to its
return), and for each part (both generator trainings, both executor
trainings, the four evaluations) its wall time, its optimizer steps and
their median time, and its K2 and K1 launches.  ``--log`` writes the
package's log records, each stamped with the seconds since the start, and
that line to FILE.  It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import logging
import statistics
import time
from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["PART_LABELS", "ProtocolParts", "part_rows", "main"]

# ``run_cogent_protocol``'s calls, in order: (function, label)
PART_LABELS = (
    ("train_generator_synthetic", "generator training on A"),
    ("train_executor_synthetic", "executor training on A"),
    ("evaluate_pipeline_synthetic", "evaluation valA_zero_shot"),
    ("evaluate_pipeline_synthetic", "evaluation valB_zero_shot"),
    ("train_generator_synthetic", "generator fine-tune on B"),
    ("train_executor_synthetic", "executor fine-tune on B"),
    ("evaluate_pipeline_synthetic", "evaluation valA_finetuned"),
    ("evaluate_pipeline_synthetic", "evaluation valB_finetuned"),
)


class ProtocolParts:
    """Records each call of the protocol's trainers and evaluation in
    ``train.synthetic_protocol`` (``run_cogent_protocol`` calls them through
    the module) while it is entered: its wall time (the card synchronized at
    the call's start and end, and nowhere else), arguments, result, K2 and
    K1 launches, and the card's time between optimizer steps (a CUDA event
    recorded at the call's start and after each step)."""

    NAMES = ("train_generator_synthetic", "train_executor_synthetic",
             "evaluate_pipeline_synthetic")

    def __init__(self):
        from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
        from explainable_spatial_vqa_tpu_torch.ops.fused_block import fused_encoder_block
        from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol

        self.sp = synthetic_protocol
        self.wrappers = (fused_encoder_block, fused_attention)
        self.calls: List[dict] = []  # name, seconds, args, kwargs, result, K2, K1, step_ms
        self.originals = {name: getattr(self.sp, name) for name in self.NAMES}
        self._events: Optional[list] = None
        self._hook = None

    def __enter__(self) -> "ProtocolParts":
        from torch.optim.optimizer import register_optimizer_step_post_hook

        self._hook = register_optimizer_step_post_hook(self._step_end)
        for name, fn in self.originals.items():
            setattr(self.sp, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc) -> None:
        self._hook.remove()
        for name, fn in self.originals.items():
            setattr(self.sp, name, fn)

    def _event(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def _step_end(self, _opt, _args, _kwargs) -> None:
        if self._events is not None:
            self._events.append(self._event())

    def _wrap(self, name, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            before = [w.launches for w in self.wrappers]
            self._events = [self._event()]
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            events, self._events = self._events, None
            k2, k1 = (w.launches - n for w, n in zip(self.wrappers, before))
            self.calls.append(dict(
                name=name, seconds=seconds, args=args, kwargs=kwargs, result=result, K2=k2, K1=k1,
                step_ms=[a.elapsed_time(b) for a, b in zip(events, events[1:])]))
            return result

        return run

    def of(self, name: str) -> List[dict]:
        return [c for c in self.calls if c["name"] == name]


def part_rows(parts: ProtocolParts) -> List[Dict]:
    """One row per part of a whole protocol run, in ``PART_LABELS``' order:
    label, seconds, optimizer steps, their median ms (None for an
    evaluation), K2 and K1 launches."""
    names = [c["name"] for c in parts.calls]
    if names != [name for name, _ in PART_LABELS]:
        raise RuntimeError(f"the protocol's calls were {names}, not {PART_LABELS}")
    return [dict(part=label, seconds=c["seconds"], steps=len(c["step_ms"]),
                 median_step_ms=statistics.median(c["step_ms"]) if c["step_ms"] else None,
                 K2=c["K2"], K1=c["K1"])
            for (_, label), c in zip(PART_LABELS, parts.calls)]


class _Elapsed(logging.Formatter):
    def __init__(self, start: float):
        super().__init__("%(elapsed)10.3f s  %(name)s: %(message)s")
        self.start = start

    def format(self, record):
        record.elapsed = record.created - self.start
        return super().format(record)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    argv = list(argv) if argv is not None else None
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log", help="write the log records and the summary line here")
    ap.add_argument("flags", nargs=argparse.REMAINDER,
                    help="-- then the flags of cogent-protocol")
    args = ap.parse_args(argv)
    flags = args.flags[1:] if args.flags[:1] == ["--"] else args.flags

    from explainable_spatial_vqa_tpu_torch.cli.main import main as cli_main
    from explainable_spatial_vqa_tpu_torch.device import resolve_device

    resolve_device("cuda")
    start = time.time()
    handler = None
    if args.log:
        handler = logging.FileHandler(args.log, mode="w")
        handler.setFormatter(_Elapsed(start))
        for name in ("explainable_spatial_vqa_tpu_torch", "esv_torch"):
            logging.getLogger(name).addHandler(handler)
    try:
        t0 = time.perf_counter()
        with ProtocolParts() as parts:
            cli_main(["cogent-protocol", *flags])
        wall = time.perf_counter() - t0
    finally:
        if handler is not None:
            for name in ("explainable_spatial_vqa_tpu_torch", "esv_torch"):
                logging.getLogger(name).removeHandler(handler)
            handler.close()
    summary = {"device": torch.cuda.get_device_name(0), "flags": flags, "cli_wall_s": wall,
               "parts": part_rows(parts)}
    line = json.dumps(summary)
    print(line, flush=True)
    if args.log:
        with open(args.log, "a") as f:
            f.write(line + "\n")
    return summary


if __name__ == "__main__":
    main()
