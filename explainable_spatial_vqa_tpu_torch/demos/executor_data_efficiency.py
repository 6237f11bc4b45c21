"""Executor data-efficiency sweep (thesis §4.2.3 / Fig 4.4b protocol),
ported from ``scripts/demo_executor_data_efficiency.py``.

The generator saturates with a few hundred programs (Fig 4.4a,
``demos.data_efficiency``), but the executor is data-hungry (Fig 4.4b).  This
demo reproduces the executor half: a fixed evaluation set on held-out
scenes, a fixed training recipe (protocol executor + box_roi, grounding
noise, cosine lr), and the number of training QUESTIONS swept over ~3
decades.  Evaluation runs the chained executor on GT program structure (the
generator held perfect) and reports final-answer accuracy and per-step token
accuracy.

Appends/refreshes the '## Executor data efficiency' section of
``DEMO_TORCH.md`` (or ``$DEMO_OUT``).  Env knobs: DEMO_DEVICE (default cuda),
DEMO_SCENES (1400), DEMO_QPS (6), DEMO_SIZES (comma list of train-question
counts; "70,700,5600"), DEMO_EXE_STEPS (8000), DEMO_SEED (0), DEMO_BOX_ROI
(1).  Finished points are kept in ``results/dataeff_rows_torch_<steps>.json``
with the protocol's signature; a second launch skips them.

    python -m explainable_spatial_vqa_tpu_torch.demos.executor_data_efficiency
"""

from __future__ import annotations

import json
import logging
import os
import time

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.core.vocab import canonicalize
from explainable_spatial_vqa_tpu_torch.demos.accuracy_table import _chains, _filter_chains
from explainable_spatial_vqa_tpu_torch.demos.common import (
    demo_device,
    held_out,
    platform_label,
    results_path,
    splice_section,
    synthetic_corpus,
)
from explainable_spatial_vqa_tpu_torch.evalsuite.accuracy import answer_accuracy_by_type
from explainable_spatial_vqa_tpu_torch.evalsuite.executor_eval import tally_predicted_chains
from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
from explainable_spatial_vqa_tpu_torch.train.synthetic_protocol import train_executor_synthetic

BEGIN = "<!-- executor-data-efficiency:begin -->"
END = "<!-- executor-data-efficiency:end -->"


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    device = demo_device()
    t0 = time.time()
    num_scenes = int(os.environ.get("DEMO_SCENES", "1400"))
    qps = int(os.environ.get("DEMO_QPS", "6"))
    sizes = [int(s) for s in os.environ.get("DEMO_SIZES", "70,700,5600").split(",")]
    exe_steps = int(os.environ.get("DEMO_EXE_STEPS", "8000"))
    seed = int(os.environ.get("DEMO_SEED", "0"))
    box_roi = bool(int(os.environ.get("DEMO_BOX_ROI", "1")))
    hop_prob, chain_prob, max_steps = 1.0, 0.8, 16

    print(f"synthesizing corpus ({num_scenes} scenes x {qps})...")
    _, questions, annotated, split_vocab, features = synthetic_corpus(
        num_scenes, qps, seed, hop_prob=hop_prob, chain_prob=chain_prob, max_nodes=max_steps)
    features = torch.as_tensor(features, device=device)

    # the fixed held-out eval set (the last 20% of scenes), the same for every size
    train_ann_pool, eval_ann = held_out(annotated, num_scenes)
    _, eval_q = held_out(questions, num_scenes)
    eval_ann = _filter_chains(eval_ann, split_vocab, max_steps)
    keep_keys = {(a["image_index"], a["question_index"]) for a in eval_ann}
    eval_q = [q for q in eval_q if (q["image_index"], q["question_index"]) in keep_keys]
    chains = _chains(eval_ann, split_vocab, max_steps, 8)
    gt_value_ids = np.asarray([split_vocab["other"].get(canonicalize(a["answer"]), -2)
                               for a in eval_ann])
    final_functions = [q["program"][-1]["function"] for q in eval_q]
    images = features[torch.as_tensor(chains.image_index, device=device).long()]

    # finished points, resumed by a later launch with the same protocol
    rows_path = results_path(f"dataeff_rows_torch_{exe_steps}.json")
    params_sig = {
        "scenes": num_scenes, "qps": qps, "seed": seed, "box_roi": box_roi,
        "hop_prob": hop_prob, "chain_prob": chain_prob,
        "max_steps": max_steps, "exe_steps": exe_steps,
    }

    def load_rows():
        if not os.path.exists(rows_path):
            return []
        with open(rows_path) as f:
            data = json.load(f)
        if data["sig"] != params_sig:
            raise SystemExit(
                f"refusing to resume: {rows_path} was written under a different protocol\n"
                f"  stored:  {data['sig']}\n  current: {params_sig}\n"
                f"Move/delete the file to start a fresh sweep.")
        return [(int(n), acc, float(tok), float(loss)) for n, acc, tok, loss in data["rows"]]

    def save_rows(rows):
        with open(rows_path, "w") as f:
            json.dump({"sig": params_sig, "rows": rows}, f)

    def write_section(rows, partial):
        # spliced after every point, rows in ascending-n order
        elapsed = time.time() - t0
        type_keys = ["overall"] + sorted(
            {k for _, acc, _, _ in rows for k in acc if k != "overall"})
        done = clamped_sizes & {n for n, *_ in rows}
        note = (f"  PARTIAL — {len(done)}/{len(clamped_sizes)} points "
                f"done, sweep in progress." if partial else "")
        lines = [
            BEGIN,
            "## Executor data efficiency (thesis §4.2.3 / Fig 4.4b protocol)",
            "",
            f"`python -m explainable_spatial_vqa_tpu_torch.demos.executor_data_efficiency` — "
            f"executor trained on N questions (fixed {exe_steps}-step recipe, "
            f"cosine lr, grounding noise 0.03/0.1"
            f"{', box_roi' if box_roi else ''}), evaluated on a FIXED "
            f"{len(eval_ann)}-question held-out-scene set with GT program "
            f"structure (generator held perfect — the executor curve in "
            f"isolation, as Fig 4.4b).  Platform {platform_label(device)}, "
            f"{elapsed:.0f}s.{note}",
            "",
            "| train questions | " + " | ".join(type_keys)
            + " | step-token acc | final train loss |",
            "|---|" + "---|" * (len(type_keys) + 2),
        ]
        for n_train, acc, tok_overall, loss in sorted(rows):
            lines.append(f"| {n_train} | "
                         + " | ".join(f"{acc.get(k, float('nan')):.3f}" for k in type_keys)
                         + f" | {tok_overall:.3f} | {loss:.2f} |")
        lines += ["", END]
        section = "\n".join(lines)
        demo_path = splice_section(section, BEGIN, END)
        print(f"wrote section to {demo_path}")
        print(section, flush=True)

    # pending sizes are the CLAMPED requested sizes, so that a narrower
    # DEMO_SIZES never marks an incomplete sweep complete
    clamped_sizes = {min(s, len(train_ann_pool)) for s in sizes}

    rows = load_rows()
    if rows:
        print(f"resuming: {sorted(n for n, *_ in rows)} already done "
              f"({rows_path}; delete it to force a full rerun)")
    ran_any = False
    for n_train in sorted(clamped_sizes, reverse=True):
        if any(n == n_train for n, *_ in rows):
            continue
        # a per-size generator: the subset for a given N is the same in any order
        rng = np.random.RandomState(seed + 1 + n_train)
        pick = rng.choice(len(train_ann_pool), n_train, replace=False)
        subset = [train_ann_pool[i] for i in sorted(pick)]
        print(f"training executor on {n_train} questions "
              f"({exe_steps} steps, box_roi={box_roi})...", flush=True)
        executor, exe_cfg, loss = train_executor_synthetic(
            subset, split_vocab, features, steps=exe_steps, seed=seed,
            noise=0.03, drop=0.1, lr_schedule="cosine", box_roi=box_roi, device=device)
        runner = ExecutorChainRunner(executor.eval(), exe_cfg, max_steps=max_steps,
                                     device=device)
        out = runner.run_sorted(images, chains, batch=128)
        pred = np.where(out["final_is_token"], out["final_tokens"], -1)
        acc = answer_accuracy_by_type(pred, gt_value_ids, final_functions)
        det = tally_predicted_chains(out, eval_ann, split_vocab["function"],
                                     split_vocab["other"], conf_threshold=0.5,
                                     max_steps=max_steps)
        tok_overall = sum(det.token_correct.values()) / max(1, sum(det.token_total.values()))
        rows.append((n_train, acc, tok_overall, float(loss)))
        print(f"  answer acc {acc['overall']:.3f}, step-token acc {tok_overall:.3f}, "
              f"final loss {loss:.4f}", flush=True)
        ran_any = True
        save_rows(rows)
        write_section(rows, partial=bool(clamped_sizes - {n for n, *_ in rows}))
    if not ran_any:
        print("all requested points already complete — nothing to do")


if __name__ == "__main__":
    main()
