"""Scheduled sampling composed with the flagship recipe, multi-seed, ported
from ``scripts/demo_scheduled_at_scale.py``.

Asks whether the scheduled-sampling gain of ``demos.scheduled_stats`` (160
scenes, 2000 steps, d=96) survives the headline accuracy recipe (d_model
192, 3-layer encoder, cosine lr, grounding noise, box_roi) on the
scene-aware relational corpus.  Two regimes per seed, paired (a shared
corpus, generator and evaluation set): (a) grounding noise only, the
flagship recipe as shipped; (b) the same with chain-level scheduled
sampling from scratch (p_max, ramp 50%).

Appends/refreshes the '## Scheduled sampling at scale' section of
``DEMO_TORCH.md`` (or ``$DEMO_OUT``).  Env knobs: DEMO_DEVICE (default cuda),
DEMO_SEEDS (3), DEMO_SCENES (700), DEMO_EXE_STEPS (12000), DEMO_GEN_STEPS
(2000), DEMO_EVAL_SCENES (150), DEMO_P (0.3), DEMO_NOISE (0.03), DEMO_DROP
(0.1), DEMO_DMODEL (192), DEMO_LAYERS (3), DEMO_BOX_ROI (1), DEMO_CKPT
(default ``results/scheduled_at_scale_torch_ckpt.json``), DEMO_OUT.

    python -m explainable_spatial_vqa_tpu_torch.demos.scheduled_at_scale
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.core import vocab as voc
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.demos.common import (
    demo_device,
    platform_label,
    results_path,
    splice_section,
    synthetic_corpus,
)
from explainable_spatial_vqa_tpu_torch.demos.scheduled_stats import fixed_eval_set, paired_rows
from explainable_spatial_vqa_tpu_torch.train.synthetic_protocol import (
    evaluate_pipeline_synthetic,
    train_executor_scheduled_synthetic,
    train_executor_synthetic,
    train_generator_synthetic,
)

BEGIN = "<!-- scheduled-at-scale:begin -->"
END = "<!-- scheduled-at-scale:end -->"


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = demo_device()
    t0 = time.time()
    seeds = list(range(int(os.environ.get("DEMO_SEEDS", "3"))))
    num_scenes = int(os.environ.get("DEMO_SCENES", "700"))
    exe_steps = int(os.environ.get("DEMO_EXE_STEPS", "12000"))
    gen_steps = int(os.environ.get("DEMO_GEN_STEPS", "2000"))
    eval_scenes_n = int(os.environ.get("DEMO_EVAL_SCENES", "150"))
    p = float(os.environ.get("DEMO_P", "0.3"))
    noise = float(os.environ.get("DEMO_NOISE", "0.03"))
    drop = float(os.environ.get("DEMO_DROP", "0.1"))
    d_model = int(os.environ.get("DEMO_DMODEL", "192"))
    layers = int(os.environ.get("DEMO_LAYERS", "3"))
    box_roi = bool(int(os.environ.get("DEMO_BOX_ROI", "1")))
    hop_prob, chain_prob, max_steps = 1.0, 0.8, 16
    corpus_kwargs = dict(hop_prob=hop_prob, chain_prob=chain_prob, max_nodes=max_steps)

    eval_q, eval_features = fixed_eval_set(num_scenes, eval_scenes_n, 8, **corpus_kwargs)
    print(f"fixed eval set: {len(eval_q)} questions over {eval_scenes_n} held-out scenes")

    regimes = [
        f"flagship recipe (noise {noise}/{drop}, cosine, d={d_model}, "
        f"{layers}L{', box_roi' if box_roi else ''})",
        f"+ scheduled sampling (p_max={p}, from scratch)",
    ]
    results = {r: [] for r in regimes}

    ckpt_path = os.environ.get("DEMO_CKPT") or results_path("scheduled_at_scale_torch_ckpt.json")
    done_seeds = 0
    params_sig = [num_scenes, exe_steps, gen_steps, eval_scenes_n, p, noise, drop, d_model,
                  layers, int(box_roi)]
    if os.path.exists(ckpt_path):
        with open(ckpt_path) as f:
            saved = json.load(f)
        if saved.get("params") == params_sig:
            results = {r: list(v) for r, v in zip(regimes, saved["scores"])}
            done_seeds = min(len(v) for v in results.values())
            print(f"resuming: {done_seeds} seeds loaded from {ckpt_path}")

    for seed in seeds:
        if seed < done_seeds:
            continue
        print(f"=== seed {seed} ===", flush=True)
        _, questions, annotated, split_vocab, train_features = synthetic_corpus(
            num_scenes, 6, seed, **corpus_kwargs)
        clevr_vocab = voc.build_clevr_vocab([questions + eval_q])
        features = torch.as_tensor(np.concatenate([train_features, eval_features]),
                                   device=device)
        cfg = ExecutorConfig(
            vocab_size=len(split_vocab["function"]) + 1,
            d_model=d_model, num_heads=4, encoder_layers=layers,
            box_decoder_layers=1, num_queries=8, num_image_tokens=196,
            image_feature_dim=64, max_input_boxes=8,
            token_classes=len(split_vocab["other"]) + 1, dropout=0.0,
            input_box_noise=noise, input_box_drop=drop, box_roi=box_roi,
        )

        generator, _gcfg, gen_loss = train_generator_synthetic(
            questions, clevr_vocab, steps=gen_steps, seed=seed, lr_schedule="cosine",
            device=device)
        print(f"  generator loss {gen_loss:.4f}", flush=True)

        def evaluate(executor, exe_cfg):
            _tally, acc = evaluate_pipeline_synthetic(
                generator, executor, exe_cfg, eval_q, features, clevr_vocab, split_vocab,
                max_steps=max_steps, device=device)
            return acc["overall"]

        executor, exe_cfg, _ = train_executor_synthetic(
            annotated, split_vocab, features, steps=exe_steps, seed=seed, config=cfg,
            lr_schedule="cosine", device=device)
        acc = evaluate(executor, exe_cfg)
        results[regimes[0]].append(acc)
        print(f"  [noise] {acc:.3f}", flush=True)

        executor, exe_cfg, _ = train_executor_scheduled_synthetic(
            annotated, split_vocab, features, steps=exe_steps, seed=seed, p_max=p,
            ramp_fraction=0.5, max_steps=max_steps,
            config=dataclasses.replace(cfg, scheduled_p_max=p), lr_schedule="cosine",
            device=device)
        acc = evaluate(executor, exe_cfg)
        results[regimes[1]].append(acc)
        print(f"  [noise+sched] {acc:.3f}", flush=True)

        with open(ckpt_path, "w") as f:
            json.dump({"params": params_sig, "scores": [results[r] for r in regimes]}, f)

    rows = paired_rows(regimes, results)
    elapsed = time.time() - t0
    section = "\n".join([
        BEGIN,
        "## Scheduled sampling at scale (composed with the flagship recipe)",
        "",
        f"`python -m explainable_spatial_vqa_tpu_torch.demos.scheduled_at_scale` — "
        f"{len(seeds)} seeds × 2 "
        f"regimes, {num_scenes} train scenes / {exe_steps} executor steps "
        f"per run on the scene-aware relational corpus (hop 1.0 / chain "
        f"0.8), ONE fixed {len(eval_q)}-question eval set on "
        f"{eval_scenes_n} never-trained scenes, platform {platform_label(device)}, "
        f"{elapsed:.0f}s.  Paired per-seed comparison (shared corpus, "
        "generator, eval).",
        "",
        "| training regime | overall (mean ± std) | Δ vs noise-only (paired) | per-seed |",
        "|---|---|---|---|",
        *rows,
        END,
    ])
    demo_path = splice_section(section, BEGIN, END)
    print(f"wrote section to {demo_path}")
    print(section)


if __name__ == "__main__":
    main()
