"""Component times of the serving pipeline, the counterpart of
``scripts/profile_pipeline.py``.

    python -m explainable_spatial_vqa_tpu_torch.measure.profile_pipeline [--device cuda|cpu]

At the port bench's widths and dtype (``BENCH_DTYPE``) on ``PROF_BATCH``
(128) of bench.py's questions: the generator's greedy decode, one executor
forward (empty boxes, the image raw), ``ExecutorChainRunner.run``'s chain
loop over every step position (its caches copied to the host), and the
questions/s they give together.  Each is the best of 5 calls after a
warm-up, timed between two CUDA events around the call: the generator's
decode and the chain loop are Python loops of small launches, so their
events also hold the host's launch queue where it is slower than the card.
The last line is one JSON object (the JAX script prints these numbers as
text).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from explainable_spatial_vqa_tpu_torch.bench import (
    best_seconds,
    build_pipeline,
    generate_all,
    emit_json,
)
from explainable_spatial_vqa_tpu_torch.bench_data import synth_questions
from explainable_spatial_vqa_tpu_torch.device import card_line, resolve_device
from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner

__all__ = ["KEYS", "main"]

KEYS = ("batch", "generator_ms", "executor_forward_ms", "chain_steps", "chain_ms",
        "chain_ms_per_step", "questions_per_s")


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    batch = int(os.environ.get("PROF_BATCH", "128"))
    print(card_line(dev), flush=True)

    pipe = build_pipeline(device=dev)
    cfg = pipe.exe_cfg
    features, questions, chains = synth_questions(batch, cfg)
    img = torch.from_numpy(features[chains.image_index[:batch]]).to(dev)
    q = torch.from_numpy(questions[:batch]).to(device=dev, dtype=torch.long)
    steps = chains.functions.shape[1]

    t_gen = best_seconds(lambda: generate_all(pipe, q), dev)
    print(f"generator decode (B={batch}, {pipe.gen_cfg.program_len} steps): "
          f"{t_gen * 1e3:.1f} ms", flush=True)

    boxes = torch.zeros(batch, cfg.max_input_boxes, 4, device=dev)
    box_mask = torch.ones(batch, cfg.max_input_boxes, dtype=torch.bool, device=dev)
    text = torch.zeros(batch, 3, dtype=torch.long, device=dev)
    text_mask = torch.ones(batch, 3, dtype=torch.bool, device=dev)

    def forward():
        with torch.no_grad():
            return pipe.executor(img, boxes, box_mask, text, text_mask)["token_logits"]

    t_fwd = best_seconds(forward, dev)
    print(f"executor single forward: {t_fwd * 1e3:.1f} ms", flush=True)

    runner = ExecutorChainRunner(pipe.executor, cfg, max_steps=steps, device=dev)
    t_chain = best_seconds(lambda: runner.run(img, chains), dev)
    print(f"chain loop ({steps} steps): {t_chain * 1e3:.1f} ms "
          f"({t_chain / steps * 1e3:.1f} ms/step)", flush=True)

    qps = batch / (t_gen + t_chain)
    print(f"=> pipeline {qps:.1f} q/s at B={batch}", flush=True)
    result = dict(zip(KEYS, (batch, t_gen * 1e3, t_fwd * 1e3, steps, t_chain * 1e3,
                             t_chain / steps * 1e3, qps)))
    return emit_json(result)


if __name__ == "__main__":
    main()
