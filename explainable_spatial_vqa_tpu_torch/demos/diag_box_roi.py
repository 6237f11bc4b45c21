"""Diagnostic: does ROI content injection fix attribute-at-box readout?
Ported from ``scripts/diag_box_roi.py``.

Trains the protocol executor twice on the SAME corpus and seed, with
``ExecutorConfig.box_roi`` off and on (coverage-pooled image content added to
each input-box token), and reports GT-fed per-function token accuracy and box
P/R side by side (``evaluate_executor_steps``: step readout isolated from
chain error propagation).  :func:`run_diagnostic` is the entry point the
three diagnostics share.

Appends/refreshes the '## Box-ROI readout diagnostic' section of
``DEMO_TORCH.md`` (or ``$DEMO_OUT``).  Env knobs: DIAG_SCENES (400), DIAG_QPS
(8), DIAG_STEPS (4000), DIAG_SEED (7), DIAG_DMODEL (0 = the protocol's d=96),
DEMO_DEVICE (default cuda), DEMO_OUT.

    python -m explainable_spatial_vqa_tpu_torch.demos.diag_box_roi
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Sequence, Tuple

import torch

from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.demos.common import (
    demo_device,
    held_out,
    platform_label,
    splice_section,
    synthetic_corpus,
)
from explainable_spatial_vqa_tpu_torch.evalsuite.detection import DetectionTally
from explainable_spatial_vqa_tpu_torch.evalsuite.executor_eval import evaluate_executor_steps
from explainable_spatial_vqa_tpu_torch.train import datasets as ds
from explainable_spatial_vqa_tpu_torch.train.synthetic_protocol import train_executor_synthetic

BEGIN = "<!-- box-roi-diag:begin -->"
END = "<!-- box-roi-diag:end -->"


def _eval_tally(model, cfg, eval_ann, vocabs, features, batch=256,
                device="cuda") -> DetectionTally:
    """GT-fed per-step tally of ``model`` on ``eval_ann``'s steps, in batches
    of ``batch`` (``features`` is the per-image cache, numpy or a tensor)."""
    arrays = ds.executor_step_arrays(
        eval_ann, vocabs["function"], vocabs["other"],
        max_input_boxes=cfg.max_input_boxes, max_output_boxes=cfg.num_queries,
    )
    n = len(arrays["text"])
    names = {v: k for k, v in vocabs["function"].items()}

    def batches():
        for lo in range(0, n, batch):
            sl = slice(lo, min(lo + batch, n))
            out = {k: v[sl] for k, v in arrays.items()}
            out["image"] = features[torch.as_tensor(arrays["image_index"][sl]).long()]
            yield out

    return evaluate_executor_steps(model, batches(), names, device=device)


def comparison_lines(results: Dict[str, DetectionTally], first: str, second: str,
                     token_header: str, box_header: str) -> List[str]:
    """The token-accuracy and box-P/R tables of two arms, side by side."""
    tok_fns = sorted(set(results[first].token_accuracy())
                     | set(results[second].token_accuracy()))
    box_fns = sorted(set(results[first].precision_recall())
                     | set(results[second].precision_recall()))
    nan = {"precision": float("nan"), "recall": float("nan")}
    lines = ["### Token accuracy by function", "", token_header, "|---|---|---|---|"]
    for fn in tok_fns:
        a = results[first].token_accuracy().get(fn, float("nan"))
        b = results[second].token_accuracy().get(fn, float("nan"))
        n = results[first].token_total.get(fn, 0)
        lines.append(f"| {fn} | {a:.3f} | {b:.3f} | {n} |")
    lines += ["", "### Box P/R @ IoU 0.5 (conf 0.5, uncalibrated)", "", box_header,
              "|---|---|---|---|---|---|"]
    for fn in box_fns:
        a = results[first].precision_recall().get(fn, nan)
        b = results[second].precision_recall().get(fn, nan)
        n = results[first].box_gt.get(fn, 0)
        lines.append(f"| {fn} | {a['precision']:.3f} | {a['recall']:.3f} "
                     f"| {b['precision']:.3f} | {b['recall']:.3f} | {n} |")
    return lines


def run_diagnostic(module: str, title: str, begin: str, end: str,
                   arms: Sequence[Tuple[str, dict]], synth_kwargs: dict, corpus_label: str,
                   corpus_note: str, executor_note: str, token_header: str,
                   box_header: str) -> None:
    """The diagnostics' shared body: the corpus, one executor per
    ``(tag, flags)`` arm on the same corpus and seed (cosine lr, grounding
    noise 0.03/0.1; the protocol's executor, or a 3-layer one at
    ``DIAG_DMODEL``, with ``flags``), each tallied GT-fed on the held-out
    scenes, and the section."""
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = demo_device()
    t0 = time.time()
    num_scenes = int(os.environ.get("DIAG_SCENES", "400"))
    qps = int(os.environ.get("DIAG_QPS", "8"))
    steps = int(os.environ.get("DIAG_STEPS", "4000"))
    seed = int(os.environ.get("DIAG_SEED", "7"))
    d_model = int(os.environ.get("DIAG_DMODEL", "0"))

    print(f"synthesizing {corpus_label}corpus ({num_scenes} scenes x {qps})...")
    _, _, annotated, vocabs, features = synthetic_corpus(num_scenes, qps, seed, **synth_kwargs)
    features = torch.as_tensor(features, device=device)
    train_ann, eval_ann = held_out(annotated, num_scenes)
    print(f"{len(train_ann)} train / {len(eval_ann)} eval questions")

    results = {}
    for tag, flags in arms:
        print(f"training executor ({tag}, {steps} steps)...")
        config = None
        if d_model:
            config = ExecutorConfig(
                vocab_size=len(vocabs["function"]) + 1, d_model=d_model,
                num_heads=4, encoder_layers=3, box_decoder_layers=1,
                num_queries=8, num_image_tokens=196, image_feature_dim=64,
                max_input_boxes=8, token_classes=len(vocabs["other"]) + 1,
                dropout=0.0, input_box_noise=0.03, input_box_drop=0.1, **flags)
        train_flags = dict(flags)
        if not flags.get("roi_sim"):
            train_flags.pop("roi_sim_heads", None)  # the heads count only with roi_sim on
        model, cfg, loss = train_executor_synthetic(
            train_ann, vocabs, features, steps=steps, seed=seed, noise=0.03, drop=0.1,
            lr_schedule="cosine", config=config, device=device, **train_flags)
        print(f"  final loss {loss:.4f}")
        results[tag] = _eval_tally(model, cfg, eval_ann, vocabs, features, device=device)

    first, second = (tag for tag, _ in arms)
    elapsed = time.time() - t0
    lines = [
        begin,
        title,
        "",
        f"`python -m explainable_spatial_vqa_tpu_torch.demos.{module}` — {num_scenes} scenes × "
        f"{qps} questions{corpus_note}, {steps} steps each arm (same corpus/seed={seed}, "
        f"protocol executor{f' d={d_model}/3L' if d_model else ''}{executor_note}, cosine lr, "
        f"grounding noise 0.03/0.1), GT-fed per-step eval on held-out scenes, platform "
        f"{platform_label(device)}, {elapsed:.0f}s.",
        "",
    ] + comparison_lines(results, first, second, token_header, box_header) + [end]
    section = "\n".join(lines)
    demo_path = splice_section(section, begin, end)
    print(f"wrote section to {demo_path}")
    print(section)


def main() -> None:
    run_diagnostic(
        "diag_box_roi", "## Box-ROI readout diagnostic (GT-fed steps, off vs on)", BEGIN, END,
        arms=(("base", dict(box_roi=False)), ("roi", dict(box_roi=True))),
        synth_kwargs=dict(hop_prob=0.3), corpus_label="", corpus_note="", executor_note="",
        token_header="| function | base | box_roi | n |",
        box_header="| function | base P | base R | roi P | roi R | gt boxes |",
    )


if __name__ == "__main__":
    main()
