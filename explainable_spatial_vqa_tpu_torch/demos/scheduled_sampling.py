"""Scheduled-sampling ablation on the synthetic end-to-end protocol, ported
from ``scripts/demo_scheduled_sampling.py``.

Trains the thesis executor three ways on the same corpus, generator and
steps: (a) teacher-forced (the reference protocol), (b) grounding-noise
augmentation, (c) chain-level scheduled sampling (``train.scheduled``: the
model's own chained predictions mixed into dependency inputs with ramped
probability), then evaluates each with the full generate -> parse ->
chained-execute pipeline on held-out scenes, where exposure bias separates
them.

Appends/refreshes the '## Scheduled sampling' section of ``DEMO_TORCH.md``
(or ``$DEMO_OUT``).  Env knobs: DEMO_DEVICE (default cuda), DEMO_SCENES,
DEMO_GEN_STEPS, DEMO_EXE_STEPS, DEMO_P_MAX (comma list), DEMO_NOISE,
DEMO_DROP, DEMO_FT_STEPS, DEMO_FT_P.

    python -m explainable_spatial_vqa_tpu_torch.demos.scheduled_sampling
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import torch

from explainable_spatial_vqa_tpu_torch.core import vocab as voc
from explainable_spatial_vqa_tpu_torch.demos.common import (
    demo_device,
    held_out,
    platform_label,
    splice_section,
    synthetic_corpus,
)
from explainable_spatial_vqa_tpu_torch.train.synthetic_protocol import (
    evaluate_pipeline_synthetic,
    train_executor_scheduled_synthetic,
    train_executor_synthetic,
    train_generator_synthetic,
)

BEGIN = "<!-- scheduled-sampling:begin -->"
END = "<!-- scheduled-sampling:end -->"


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = demo_device()
    t0 = time.time()
    num_scenes = int(os.environ.get("DEMO_SCENES", "160"))
    exe_steps = int(os.environ.get("DEMO_EXE_STEPS", "2000"))
    p_maxes = [float(p) for p in os.environ.get("DEMO_P_MAX", "0.5").split(",")]
    noise = float(os.environ.get("DEMO_NOISE", "0.05"))
    drop = float(os.environ.get("DEMO_DROP", "0.15"))

    print("synthesizing corpus...")
    _, questions, annotated, split_vocab, features = synthetic_corpus(num_scenes, 6, seed=3)
    clevr_vocab = voc.build_clevr_vocab([questions])
    features = torch.as_tensor(features, device=device)
    train_q, eval_q = held_out(questions, num_scenes)
    train_ann, _ = held_out(annotated, num_scenes)

    print(f"training generator on {len(train_q)} questions...")
    generator, _gen_cfg, gen_loss = train_generator_synthetic(
        train_q, clevr_vocab, steps=int(os.environ.get("DEMO_GEN_STEPS", "400")),
        device=device)
    print(f"  final loss {gen_loss:.4f}")

    def evaluate(tag, executor, exe_cfg):
        _tally, acc = evaluate_pipeline_synthetic(
            generator, executor, exe_cfg, eval_q, features, clevr_vocab, split_vocab,
            max_steps=12, device=device)
        print(f"  [{tag}] overall={acc.get('overall', float('nan')):.3f} "
              + " ".join(f"{k}={v:.3f}" for k, v in acc.items() if k != "overall"))
        return acc

    def tf_executor(steps, **kwargs):
        executor, exe_cfg, _ = train_executor_synthetic(
            train_ann, split_vocab, features, steps=steps, device=device, **kwargs)
        return executor, exe_cfg

    results = {}
    print(f"[1/3] teacher-forced executor ({exe_steps} steps)...")
    results["teacher-forced (reference protocol)"] = evaluate("tf", *tf_executor(exe_steps))

    print(f"[2/3] grounding-noise executor (noise={noise}, drop={drop})...")
    results[f"grounding noise (noise={noise}, drop={drop})"] = evaluate(
        "noise", *tf_executor(exe_steps, noise=noise, drop=drop))

    for i, p_max in enumerate(p_maxes):
        print(f"[{3 + i}/{2 + len(p_maxes)}] scheduled-sampling executor (p_max={p_max})...")
        executor, exe_cfg, _ = train_executor_scheduled_synthetic(
            train_ann, split_vocab, features, steps=exe_steps, p_max=p_max, device=device)
        results[f"scheduled sampling (p_max={p_max}, chain-level)"] = evaluate(
            f"sched p={p_max}", executor, exe_cfg)

    ft_steps = int(os.environ.get("DEMO_FT_STEPS", "0"))
    if ft_steps:
        # warm start: the teacher-forced model fine-tuned (a) with more TF
        # steps (control) or (b) with chain-level scheduled sampling at a
        # constant p (TF first, then its own predictions)
        ft_p = float(os.environ.get("DEMO_FT_P", "0.3"))
        print(f"[ft] TF control (+{ft_steps} TF steps)...")
        results[f"teacher-forced (+{ft_steps} steps, control)"] = evaluate(
            "tf-long", *tf_executor(exe_steps + ft_steps))

        print(f"[ft] TF then scheduled fine-tune (+{ft_steps} @ p={ft_p})...")
        executor, exe_cfg = tf_executor(exe_steps)
        executor, exe_cfg, _ = train_executor_scheduled_synthetic(
            train_ann, split_vocab, features, steps=ft_steps, p_max=ft_p, ramp_fraction=0.2,
            config=dataclasses.replace(exe_cfg, scheduled_p_max=ft_p), init_variables=executor,
            device=device)
        results[f"TF then scheduled fine-tune (+{ft_steps} @ p={ft_p})"] = evaluate(
            "tf+sched", executor, exe_cfg)

    elapsed = time.time() - t0
    keys = sorted({k for acc in results.values() for k in acc})
    keys = ["overall"] + [k for k in keys if k != "overall"]
    header = "| training regime | " + " | ".join(keys) + " |"
    sep = "|---" * (len(keys) + 1) + "|"
    rows = ["| " + tag + " | " + " | ".join(f"{acc.get(k, float('nan')):.3f}" for k in keys)
            + " |" for tag, acc in results.items()]
    section = "\n".join([
        BEGIN,
        "## Scheduled sampling: closing the exposure-bias gap "
        "(chained accuracy, held-out scenes)",
        "",
        f"`python -m explainable_spatial_vqa_tpu_torch.demos.scheduled_sampling` — {num_scenes} "
        f"scenes, {exe_steps} executor steps per regime, identical generator "
        f"(TF loss {gen_loss:.4f}), platform {platform_label(device)}, {elapsed:.0f}s.",
        "The executor is trained teacher-forced (the reference's protocol), "
        "with stateless grounding noise, and with chain-level scheduled "
        "sampling (`train/scheduled.py`: dependency inputs drawn from the "
        "model's OWN chained predictions with ramped probability — the "
        "distribution it actually faces at inference).",
        "",
        header,
        sep,
        *rows,
        END,
    ])
    demo_path = splice_section(section, BEGIN, END)
    print(f"wrote section to {demo_path}")


if __name__ == "__main__":
    main()
