"""Multi-seed scheduled-sampling ablation with paired statistics, ported from
``scripts/demo_scheduled_stats.py``.

Runs several seeds per regime against ONE fixed held-out evaluation set and
reports mean ± std plus PAIRED per-seed differences against the
teacher-forced control (each seed shares its corpus, generator and
initialisation across regimes, so the difference isolates the training
regime).  Regimes: (a) teacher-forced (reference protocol), (b)
grounding-noise augmentation, (c) chain-level scheduled sampling from
scratch, (d) TF first, then a scheduled fine-tune.

Appends/refreshes the '## Scheduled sampling' section of ``DEMO_TORCH.md``
(or ``$DEMO_OUT``).  Env knobs: DEMO_DEVICE (default cuda), DEMO_SEEDS,
DEMO_SCENES, DEMO_EXE_STEPS, DEMO_GEN_STEPS, DEMO_EVAL_SCENES, DEMO_EVAL_QPS,
DEMO_P, DEMO_NOISE, DEMO_DROP, DEMO_FT_FRAC, DEMO_CKPT, DEMO_OUT.  Each
finished seed is kept in ``$DEMO_CKPT`` (default
``results/scheduled_stats_torch_partial.json``, where the JAX script uses
/tmp) and the statistics go to ``scheduled_stats_torch.json`` beside it.

    python -m explainable_spatial_vqa_tpu_torch.demos.scheduled_stats
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.clevr import synthetic as syn
from explainable_spatial_vqa_tpu_torch.core import vocab as voc
from explainable_spatial_vqa_tpu_torch.demos.common import (
    demo_device,
    feature_maps,
    platform_label,
    results_path,
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


def fixed_eval_set(num_scenes: int, eval_scenes: int, qps: int, **synth_kwargs):
    """The one evaluation set every seed and regime shares: seed 999's
    corpus, its image indices shifted above every training set's."""
    eval_scenes_raw, eval_q = syn.synthesize_dataset(eval_scenes, qps, seed=999, **synth_kwargs)
    for record in eval_scenes_raw + eval_q:
        record["image_index"] += num_scenes
    return eval_q, feature_maps(eval_scenes_raw)


def paired_rows(regimes, results) -> list:
    """One table row per regime: mean ± std over seeds and the paired
    difference against the first regime."""
    base = np.asarray(results[regimes[0]])
    rows = []
    for r in regimes:
        a = np.asarray(results[r])
        d = a - base
        if r == regimes[0]:
            delta = "—"
        else:
            se = d.std(ddof=1) / np.sqrt(len(d)) if len(d) > 1 else np.nan
            t = d.mean() / se if se and se > 0 else float("nan")
            delta = (f"{d.mean():+.3f} ± {d.std(ddof=1):.3f} "
                     f"(t={t:.2f}, {int(np.sum(d > 0))}/{len(d)} seeds up)")
        per_seed = " ".join(f"{v:.3f}" for v in a)
        rows.append(f"| {r} | {a.mean():.3f} ± {a.std(ddof=1):.3f} | {delta} | {per_seed} |")
    return rows


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = demo_device()
    t0 = time.time()
    seeds = list(range(int(os.environ.get("DEMO_SEEDS", "5"))))
    num_scenes = int(os.environ.get("DEMO_SCENES", "160"))
    exe_steps = int(os.environ.get("DEMO_EXE_STEPS", "2000"))
    gen_steps = int(os.environ.get("DEMO_GEN_STEPS", "400"))
    eval_scenes_n = int(os.environ.get("DEMO_EVAL_SCENES", "100"))
    eval_qps = int(os.environ.get("DEMO_EVAL_QPS", "10"))
    p = float(os.environ.get("DEMO_P", "0.3"))
    noise = float(os.environ.get("DEMO_NOISE", "0.05"))
    drop = float(os.environ.get("DEMO_DROP", "0.15"))
    ft_frac = float(os.environ.get("DEMO_FT_FRAC", "0.2"))

    eval_q, eval_features = fixed_eval_set(num_scenes, eval_scenes_n, eval_qps)
    print(f"fixed eval set: {len(eval_q)} questions over {eval_scenes_n} held-out scenes")

    regimes = [
        "teacher-forced (reference protocol)",
        f"grounding noise ({noise}/{drop})",
        f"scheduled sampling (p_max={p}, from scratch)",
        f"TF then scheduled fine-tune (last {ft_frac:.0%} @ p={p})",
    ]
    results = {r: [] for r in regimes}  # regime -> [overall per seed]

    # each finished seed's four scores, so that an interrupted run resumes
    ckpt_path = os.environ.get("DEMO_CKPT") or results_path("scheduled_stats_torch_partial.json")
    params = [num_scenes, exe_steps, gen_steps, eval_scenes_n, eval_qps, p, noise, drop, ft_frac]
    done_seeds = 0
    if os.path.exists(ckpt_path):
        with open(ckpt_path) as f:
            saved = json.load(f)
        if saved.get("regimes") == regimes and saved.get("params") == params:
            results = {r: list(v) for r, v in zip(regimes, saved["scores"])}
            done_seeds = min(len(v) for v in results.values())
            print(f"resuming: {done_seeds} seeds loaded from {ckpt_path}")

    for seed in seeds:
        if seed < done_seeds:
            continue
        print(f"=== seed {seed} ===")
        _, questions, annotated, split_vocab, train_features = synthetic_corpus(
            num_scenes, 6, seed)
        clevr_vocab = voc.build_clevr_vocab([questions + eval_q])
        features = torch.as_tensor(np.concatenate([train_features, eval_features]),
                                   device=device)

        generator, _gcfg, gen_loss = train_generator_synthetic(
            questions, clevr_vocab, steps=gen_steps, seed=seed, device=device)
        print(f"  generator loss {gen_loss:.4f}")

        def evaluate(executor, exe_cfg):
            _tally, acc = evaluate_pipeline_synthetic(
                generator, executor, exe_cfg, eval_q, features, clevr_vocab, split_vocab,
                max_steps=12, device=device)
            return acc["overall"]

        def record(i, tag, executor, exe_cfg):
            acc = evaluate(executor, exe_cfg)
            results[regimes[i]].append(acc)
            print(f"  [{tag}] {acc:.3f}")

        def tf(steps, **kwargs):
            executor, exe_cfg, _ = train_executor_synthetic(
                annotated, split_vocab, features, steps=steps, seed=seed, device=device, **kwargs)
            return executor, exe_cfg

        record(0, "tf", *tf(exe_steps))  # (a) the TF control
        record(1, "noise", *tf(exe_steps, noise=noise, drop=drop))  # (b) grounding noise
        executor, exe_cfg, _ = train_executor_scheduled_synthetic(  # (c) scheduled from scratch
            annotated, split_vocab, features, steps=exe_steps, seed=seed, p_max=p, device=device)
        record(2, "sched", executor, exe_cfg)
        # (d) a TF warm start, then a scheduled fine-tune at constant p
        ft_steps = int(exe_steps * ft_frac)
        executor, exe_cfg = tf(exe_steps - ft_steps)
        executor, exe_cfg, _ = train_executor_scheduled_synthetic(
            annotated, split_vocab, features, steps=ft_steps, seed=seed, p_max=p,
            ramp_fraction=0.25, config=dataclasses.replace(exe_cfg, scheduled_p_max=p),
            init_variables=executor, device=device)
        record(3, "tf+sched", executor, exe_cfg)

        with open(ckpt_path, "w") as f:
            json.dump({"regimes": regimes, "params": params,
                       "scores": [results[r] for r in regimes]}, f)

    stats = {}
    tf_scores = np.asarray(results[regimes[0]])
    for r in regimes:
        a = np.asarray(results[r])
        stats[r] = {"per_seed": a.tolist(), "mean": float(a.mean()),
                    "std": float(a.std(ddof=1)), "delta_vs_tf": (a - tf_scores).tolist()}
    rows = paired_rows(regimes, results)

    elapsed = time.time() - t0
    section = "\n".join([
        BEGIN,
        "## Scheduled sampling: multi-seed paired ablation "
        "(chained accuracy, fixed held-out eval)",
        "",
        f"`python -m explainable_spatial_vqa_tpu_torch.demos.scheduled_stats` — {len(seeds)} "
        f"seeds × {len(regimes)} regimes, {num_scenes} train scenes / {exe_steps} "
        f"executor steps per run, ONE fixed {len(eval_q)}-question eval set on "
        f"{eval_scenes_n} never-trained scenes, platform {platform_label(device)}, "
        f"{elapsed:.0f}s.  Each seed shares its corpus/generator across "
        "regimes, so Δ vs TF is a paired per-seed comparison "
        "(±: sample std over seeds; t: paired mean/SE).",
        "",
        "| training regime | overall (mean ± std) | Δ vs TF (paired) | per-seed |",
        "|---|---|---|---|",
        *rows,
        END,
    ])
    demo_path = splice_section(section, BEGIN, END)
    with open(os.path.join(os.path.dirname(ckpt_path), "scheduled_stats_torch.json"), "w") as f:
        json.dump(stats, f, indent=2)
    print(f"wrote section to {demo_path}")
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
