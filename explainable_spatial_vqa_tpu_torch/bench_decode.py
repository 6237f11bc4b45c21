"""Time the program generator's decoding at bench.py's widths.

    python -m explainable_spatial_vqa_tpu_torch.bench_decode [--questions 512]
        [--beam 4] [--repeats 5]

The ``generator`` preset (3+3 LSTM layers, hidden 512), bf16, weights and
questions drawn from seed 14 (``bench_data.synth_generator_batch``), as
``chip_smoke.py``'s evaluation phase draws them.  After a warm-up on 16
questions, ``generate`` and ``beam_generate`` at ``--beam`` are each run
``--repeats`` times on ``--questions`` questions, alternating, each run
timed on the host clock with the card synchronized before and after.
Prints one JSON line: the device, each run's ms and each median.  It needs
a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional, Sequence

import torch

__all__ = ["main"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--questions", type=int, default=512)
    ap.add_argument("--beam", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)

    from explainable_spatial_vqa_tpu_torch.bench_data import synth_generator_batch
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.device import resolve_device
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters

    dev = resolve_device("cuda")
    cfg = get_preset("generator").model
    questions, _programs, _index = synth_generator_batch(args.questions, cfg, seed=14)
    generator = init_parameters(ProgramGenerator(cfg, torch.bfloat16, device=dev), seed=14)
    q = torch.from_numpy(questions).to(dev)
    generator.beam_generate(q[:16], args.beam)  # cuBLAS set-up, the allocator's pools
    generator.generate(q[:16])

    def timed_ms(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    runs = {"generate": [], f"beam_generate_{args.beam}": []}
    for _ in range(args.repeats):
        runs["generate"].append(timed_ms(lambda: generator.generate(q)))
        runs[f"beam_generate_{args.beam}"].append(
            timed_ms(lambda: generator.beam_generate(q, args.beam)))
    summary = {"device": torch.cuda.get_device_name(dev), "questions": args.questions,
               "ms": runs, "median_ms": {k: statistics.median(v) for k, v in runs.items()}}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
