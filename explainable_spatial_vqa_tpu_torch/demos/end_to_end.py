"""End-to-end demonstration on synthetic CLEVR-compatible data, ported from
``scripts/demo_end_to_end.py``.

Trains the Program Generator (question -> program) and the thesis Program
Executor (per-step grounding) on a synthetic corpus, then runs the full
InferencePipeline (generate -> parse -> chained execution -> answer) on
held-out scenes and reports the signature metrics: faithfulness quadrants and
answer accuracy by question type.

Writes the report to ``$DEMO_OUT`` only when it is set (as the JAX script
does; never to ``DEMO.md``) and prints it.  Env knobs: DEMO_DEVICE (default
cuda), DEMO_SCENES, DEMO_GEN_STEPS, DEMO_EXE_STEPS, DEMO_NOISE, DEMO_DROP,
DEMO_SINKHORN_TAU, DEMO_SINKHORN_ITERS, DEMO_MATMUL_PRECISION (``highest``
keeps float32 products, any other value lets them run in TF32), DEMO_OUT.

    python -m explainable_spatial_vqa_tpu_torch.demos.end_to_end
"""

from __future__ import annotations

import logging
import os
import time

import torch

from explainable_spatial_vqa_tpu_torch.core import vocab as voc
from explainable_spatial_vqa_tpu_torch.demos.common import (
    demo_device,
    held_out,
    out_path,
    platform_label,
    synthetic_corpus,
)
from explainable_spatial_vqa_tpu_torch.train.synthetic_protocol import (
    evaluate_pipeline_synthetic,
    train_executor_synthetic,
    train_generator_synthetic,
)


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = demo_device()
    precision = os.environ.get("DEMO_MATMUL_PRECISION")
    if precision:  # JAX's "highest" is float32; lower precisions are TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = precision != "highest"
        torch.backends.cudnn.allow_tf32 = precision != "highest"
    t0 = time.time()
    print("synthesizing corpus...")
    num_scenes = int(os.environ.get("DEMO_SCENES", "80"))
    _, questions, annotated, split_vocab, features = synthetic_corpus(num_scenes, 6, seed=3)
    clevr_vocab = voc.build_clevr_vocab([questions])
    features = torch.as_tensor(features, device=device)

    # held-out scenes for evaluation
    train_q, eval_q = held_out(questions, num_scenes)
    train_ann, _ = held_out(annotated, num_scenes)
    held = num_scenes - int(num_scenes * 0.8)

    print(f"training generator on {len(train_q)} questions...")
    generator, _gen_cfg, gen_loss = train_generator_synthetic(
        train_q, clevr_vocab, steps=int(os.environ.get("DEMO_GEN_STEPS", "400")),
        device=device)
    print(f"  final loss {gen_loss:.4f}")

    print(f"training executor on {len(train_ann)} annotated questions...")
    executor, exe_cfg, exe_loss = train_executor_synthetic(
        train_ann, split_vocab, features,
        steps=int(os.environ.get("DEMO_EXE_STEPS", "500")),
        noise=float(os.environ.get("DEMO_NOISE", "0")),
        drop=float(os.environ.get("DEMO_DROP", "0")),
        sinkhorn_tau=float(os.environ.get("DEMO_SINKHORN_TAU", "1.0")),
        sinkhorn_iters=int(os.environ.get("DEMO_SINKHORN_ITERS", "20")),
        device=device)
    print(f"  final loss {exe_loss:.4f}")

    print(f"running full pipeline on {len(eval_q)} held-out-scene questions...")
    tally, acc = evaluate_pipeline_synthetic(
        generator, executor, exe_cfg, eval_q, features, clevr_vocab, split_vocab,
        max_steps=12, device=device)

    elapsed = time.time() - t0
    lines = [
        "# End-to-end demonstration (synthetic CLEVR-compatible data)",
        "",
        "Generated by `python -m explainable_spatial_vqa_tpu_torch.demos.end_to_end` — trains "
        "the Program",
        f"Generator and the thesis Program Executor from scratch on a {num_scenes}-scene",
        "synthetic corpus (80/20 scene split), then runs the full",
        "vectorized pipeline (greedy program generation -> postfix parse ->",
        "chained grounded execution -> answer) on questions over scenes never",
        "seen in training.",
        "",
        f"- corpus: {len(questions)} questions / {num_scenes} scenes; "
        f"eval: {len(eval_q)} questions on {held} held-out scenes",
        f"- generator final TF loss: {gen_loss:.4f}",
        f"- executor final set loss: {exe_loss:.4f}",
        f"- wall time ({platform_label(device)}): {elapsed:.0f}s",
        "",
        "## Faithfulness quadrants (thesis Table 4.5 protocol)",
        "",
        "```",
        tally.report(),
        "```",
        "",
        "## Answer accuracy by question type (thesis Table 4.2 protocol)",
        "",
        "```",
    ] + [f"{k}: {v:.3f}" for k, v in acc.items()] + [
        "```",
        "",
        "Random-answer baseline is ~8% (value vocab); random programs parse",
        "to valid chains ~never.  Correct-program+correct-answer well above",
        "both demonstrates the whole stack — annotation factory, vocabularies,",
        "training losses (Hungarian set matching included), cached decoding,",
        "vectorized chained inference, and the eval suite — working together.",
    ]
    # like the JAX script, a file is written only when DEMO_OUT is set
    if os.environ.get("DEMO_OUT"):
        out_path().write_text("\n".join(lines) + "\n")
    print("\n".join(lines))


if __name__ == "__main__":
    main()
