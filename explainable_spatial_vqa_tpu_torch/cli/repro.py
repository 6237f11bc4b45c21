"""``repro-clevr``, ported from ``explainable_spatial_vqa_tpu/cli/repro.py``:
point it at a CLEVR v1.0 / CoGenT download root and it runs the whole chain

    extract-features -> vocab -> questions -> annotate (v3)
    -> train generator -> train executor -> tally

through the port's own subcommands, in-process (``--device`` passed to each
where the JAX package passes ``--platform``), and writes ``REPORT.md`` in the
thesis table formats: Table 4.2 (answer accuracy by question type), 4.3/4.4
(per-function box P/R and token accuracy on predicted chains), 4.5
(faithfulness quadrants) and, when a CoGenT condition-B root is given, Table
4.6 (A->B zero-shot and fine-tuned-on-B accuracies).  The last line of its
stdout is a JSON map of the report, the artifacts and the checkpoints.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import logging
import os
import shutil

logger = logging.getLogger("esv_torch.cli")

__all__ = ["cmd_repro_clevr", "add_repro_parser"]


def _sub(argv, device=None):
    """Run one CLI subcommand in-process, capturing its stdout."""
    from explainable_spatial_vqa_tpu_torch.cli.main import main

    if device:
        argv = ["--device", device] + argv
    logger.info("repro-clevr: %s", " ".join(argv))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    out = buf.getvalue()
    if out.strip():
        print(out, end="" if out.endswith("\n") else "\n")
    return out


def _find(root: str, *candidates: str) -> str | None:
    for c in candidates:
        p = os.path.join(root, c)
        if os.path.exists(p):
            return p
    return None


def _prepare_split(root, split, work, vocab, device, torch_weights, resize,
                   feature_batch):
    """questions h5 + features h5 + scenes path for one split; returns dict
    of artifact paths (None where the split lacks that input)."""
    q_json = _find(root, f"questions/CLEVR_{split}_questions.json",
                   f"CLEVR_{split}_questions.json")
    scenes = _find(root, f"scenes/CLEVR_{split}_scenes.json",
                   f"CLEVR_{split}_scenes.json")
    img_dir = _find(root, f"images/{split}", "images")
    art = {"questions_json": q_json, "scenes": scenes}
    if q_json:
        art["questions_h5"] = os.path.join(work, f"{split}_questions.h5")
        _sub(["preprocess-questions", "--input_questions_json", q_json,
              "--input_vocab_json", vocab,
              "--output_h5_file", art["questions_h5"]], device)
    if img_dir:
        art["features_h5"] = os.path.join(work, f"{split}_features.h5")
        argv = ["extract-features", "--input_image_dir", img_dir,
                "--output_h5_file", art["features_h5"],
                "--batch_size", str(feature_batch), "--resize", resize]
        if torch_weights:
            argv += ["--torch-weights", torch_weights]
        _sub(argv, device)
    if q_json and scenes:
        art["annotated_h5"] = os.path.join(work, f"annotated_{split}.h5")
        art["split_vocab"] = os.path.join(work, f"vocab3_{split}.json")
        _sub(["annotate", "--mode", "v3", "--scenes", scenes,
              "--questions", q_json, "--output_h5", art["annotated_h5"],
              "--vocab_output", art["split_vocab"],
              "--workers", str(os.cpu_count() or 1)], device)
    return art


def _tally(art_eval, vocab, split_vocab, gen_ckpt, exe_ckpt, device, limit,
           executor_preset="executor", conf_args=("--calibrate_conf",)):
    argv = ["tally", "--questions_h5", art_eval["questions_h5"],
            "--features_h5", art_eval["features_h5"],
            "--vocab_json", vocab, "--split_vocab_json", split_vocab,
            "--generator_checkpoint", gen_ckpt,
            "--executor_checkpoint", exe_ckpt, *conf_args,
            "--executor_preset", executor_preset]
    if art_eval.get("annotated_h5"):
        argv += ["--annotated_h5", art_eval["annotated_h5"]]
    if limit:
        argv += ["--limit", str(limit)]
    return _sub(argv, device)


def cmd_repro_clevr(args: argparse.Namespace) -> None:
    # fail fast on a bad --executor_preset: it is first used at step 6, after
    # the feature extraction and the generator's training
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.device import resolve_device

    resolve_device(args.device)  # before any stage: without a card, only with cpu
    try:
        exe_preset = get_preset(args.executor_preset).model
    except KeyError as e:
        raise SystemExit(str(e)) from None
    if not hasattr(exe_preset, "box_roi"):
        raise SystemExit(
            f"--executor_preset {args.executor_preset!r} is not an "
            "executor-family preset")

    work = args.workdir
    os.makedirs(work, exist_ok=True)
    device = args.device
    report: list[str] = ["# CLEVR reproduction report", ""]

    # 1. three-way vocab (reference order: val, test, train — build_vocab.py)
    vocab = os.path.join(work, "vocab.json")
    q_jsons = [p for split in ("val", "test", "train")
               for p in [_find(args.clevr_root,
                               f"questions/CLEVR_{split}_questions.json",
                               f"CLEVR_{split}_questions.json")] if p]
    if not q_jsons:
        raise SystemExit(f"no CLEVR question JSONs under {args.clevr_root}")
    _sub(["build-vocab", "--inputs", *q_jsons, "--output", vocab], device)

    # 2-4. per-split questions h5 / features h5 / v3 annotations
    train = _prepare_split(args.clevr_root, "train", work, vocab, device,
                           args.torch_weights, args.resize, args.feature_batch)
    val = _prepare_split(args.clevr_root, "val", work, vocab, device,
                         args.torch_weights, args.resize, args.feature_batch)
    val_substituted = []
    for key in ("questions_h5", "features_h5"):
        if key not in train:
            raise SystemExit(f"train split is missing {key} inputs")
        if key not in val:
            val_substituted.append(key)
            val[key] = train[key]
    if val_substituted:
        logger.warning(
            "repro-clevr: val split lacks %s — substituting TRAIN-split "
            "artifacts; the 'val' tables below are train-set (memorized) "
            "numbers, not a held-out evaluation", "/".join(val_substituted))
    if "annotated_h5" not in train:
        raise SystemExit("train split needs scenes+questions for annotation")
    split_vocab = train["split_vocab"]

    # 5. train the Program Generator (thesis Table 4.1 hyperparams preset)
    gen_ckpt = os.path.join(work, "ckpt_generator")
    _sub(["train", "--preset", "generator",
          "--questions_h5", train["questions_h5"],
          "--checkpoint_dir", gen_ckpt,
          "--history_json", os.path.join(work, "generator_history.json"),
          "--epochs", str(args.gen_epochs)]
         + (["--batch_size", str(args.batch_size)] if args.batch_size else []),
         device)
    gen_eval = _sub(["eval-generator", "--questions_h5", val["questions_h5"],
                     "--checkpoint_dir", gen_ckpt, "--vocab_json", vocab]
                    + (["--limit", str(args.eval_limit)] if args.eval_limit else []),
                    device)
    report += ["## Program generator (thesis §4.1.3.2: 99.7% program acc)",
               "```", gen_eval.strip(), "```", ""]

    # 6. train the Program Executor on per-step annotations
    exe_ckpt = os.path.join(work, "ckpt_executor")
    _sub(["train", "--preset", args.executor_preset,
          "--annotated_h5", train["annotated_h5"],
          "--features_h5", train["features_h5"],
          "--split_vocab_json", split_vocab,
          "--checkpoint_dir", exe_ckpt,
          "--history_json", os.path.join(work, "executor_history.json"),
          "--epochs", str(args.exe_epochs)]
         + (["--batch_size", str(args.batch_size)] if args.batch_size else []),
         device)

    # 7. faithfulness + per-type + per-function tables on val
    conf_args = ("--calibrate_conf",)
    if getattr(args, "per_fn_conf", False):
        # per-function operating points (DESIGN.md §14), fitted on the
        # held-in TRAIN split's chains and applied OUT-OF-SAMPLE to every
        # val tally of this model (incl. the zero-shot CoGenT-B cell)
        thr_json = os.path.join(work, "conf_thresholds.json")
        _tally(train, vocab, split_vocab, gen_ckpt, exe_ckpt, device,
               args.eval_limit, args.executor_preset,
               conf_args=("--calibrate_conf_per_function",
                          "--save_conf_thresholds", thr_json))
        conf_args = ("--conf_thresholds", thr_json)
    tally_out = _tally(val, vocab, split_vocab, gen_ckpt, exe_ckpt, device,
                       args.eval_limit, args.executor_preset,
                       conf_args=conf_args)
    val_label = ("val split" if not val_substituted else
                 "TRAIN split substituted for missing val "
                 + "/".join(val_substituted) + " — not held-out")
    if getattr(args, "per_fn_conf", False):
        val_label += "; per-function conf thresholds fitted on train chains"
    report += [f"## Tables 4.2 / 4.3 / 4.4 / 4.5 ({val_label})",
               "answer accuracy by type; per-function box P/R @IoU0.5 and "
               "token accuracy on predicted chains; CPCA/CPIA/IPCA/IPIA "
               "quadrants:", "```", tally_out.strip(), "```", ""]

    # 8. Table 4.6 — CoGenT A->B, when a condition-B root is supplied
    if args.cogent_b_root:
        condb = os.path.join(work, "condB")
        os.makedirs(condb, exist_ok=True)
        val_b = _prepare_split(args.cogent_b_root, "val", condb,
                               vocab, device, args.torch_weights,
                               args.resize, args.feature_batch)
        if "questions_h5" not in val_b or "features_h5" not in val_b:
            raise SystemExit(
                f"condition-B val split under {args.cogent_b_root} lacks "
                "questions/images needed for the zero-shot valB cell")
        zero_a = tally_out
        # same model as zero_a -> same conf gating scheme, so the A->B gap
        # is measured at matched operating points
        zero_b = _tally(val_b, vocab, split_vocab, gen_ckpt, exe_ckpt,
                        device, args.eval_limit, args.executor_preset,
                        conf_args=conf_args)
        # fine-tune on a condition-B train subset (thesis: 3k img / 30k q),
        # resuming from the condition-A checkpoints (the trainer restores the latest);
        # same --batch_size as the condition-A runs so the four Table 4.6
        # cells train with consistent hyperparameters
        train_b = _prepare_split(args.cogent_b_root, "train", condb,
                                 vocab, device, args.torch_weights,
                                 args.resize, args.feature_batch)
        missing = [k for k in ("questions_h5", "features_h5", "annotated_h5")
                   if k not in train_b]
        if missing:
            raise SystemExit(
                f"condition-B train split under {args.cogent_b_root} lacks "
                f"{'/'.join(missing)} inputs (questions+scenes+images are "
                "all required to fine-tune); rerun without --cogent_b_root "
                "or complete the download")
        bs = ["--batch_size", str(args.batch_size)] if args.batch_size else []
        ft_gen = os.path.join(work, "ckpt_generator_ftB")
        ft_exe = os.path.join(work, "ckpt_executor_ftB")
        shutil.copytree(gen_ckpt, ft_gen, dirs_exist_ok=True)
        shutil.copytree(exe_ckpt, ft_exe, dirs_exist_ok=True)
        _sub(["train", "--preset", "generator",
              "--questions_h5", train_b["questions_h5"],
              "--checkpoint_dir", ft_gen,
              "--history_json", os.path.join(work, "generator_ftB_history.json"),
              "--epochs", str(args.gen_epochs + args.ft_epochs)] + bs, device)
        _sub(["train", "--preset", args.executor_preset,
              "--annotated_h5", train_b["annotated_h5"],
              "--features_h5", train_b["features_h5"],
              "--split_vocab_json", split_vocab,
              "--checkpoint_dir", ft_exe,
              "--history_json", os.path.join(work, "executor_ftB_history.json"),
              "--epochs", str(args.exe_epochs + args.ft_epochs)] + bs, device)
        ft_a = _tally(val, vocab, split_vocab, ft_gen, ft_exe, device,
                      args.eval_limit, args.executor_preset)
        ft_b = _tally(val_b, vocab, split_vocab, ft_gen, ft_exe, device,
                      args.eval_limit, args.executor_preset)
        report += ["## Table 4.6 (CoGenT A->B)", ""]
        for label, out in [("train A, eval valA (zero-shot)", zero_a),
                           ("train A, eval valB (zero-shot)", zero_b),
                           ("fine-tune B, eval valA", ft_a),
                           ("fine-tune B, eval valB", ft_b)]:
            report += [f"### {label}", "```", out.strip(), "```", ""]
    else:
        report += ["## Table 4.6 (CoGenT A->B)",
                   "skipped — pass --cogent_b_root pointing at a CoGenT "
                   "condition-B download to run the four-cell protocol "
                   "(synthetic-data protocol: `cogent-protocol`).", ""]

    report_path = os.path.join(work, "REPORT.md")
    with open(report_path, "w") as f:
        f.write("\n".join(report))
    logger.info("repro-clevr: wrote %s", report_path)
    print(json.dumps({"report": report_path,
                      "artifacts": {"train": train, "val": val},
                      "checkpoints": [gen_ckpt, exe_ckpt]}))


def add_repro_parser(sub) -> None:
    p = sub.add_parser(
        "repro-clevr",
        help="one-command dress rehearsal: CLEVR root -> features/vocab/"
             "annotations -> train generator+executor -> thesis tables")
    p.add_argument("--clevr_root", required=True,
                   help="CLEVR v1.0 (or CoGenT condition-A) download root")
    p.add_argument("--workdir", required=True)
    p.add_argument("--torch-weights", "--torch_weights", dest="torch_weights",
                   default=None,
                   help="torchvision resnet101 .pth (numeric feature parity)")
    p.add_argument("--resize", choices=["device", "pil"], default="pil",
                   help="pil bit-matches the reference preprocessing")
    p.add_argument("--feature_batch", type=int, default=64)
    p.add_argument("--per_fn_conf", action="store_true",
                   help="fit per-function confidence operating points on "
                        "the train split's chains and apply them "
                        "out-of-sample to the val tallies (DESIGN.md "
                        "section 14; default: one F1-calibrated global "
                        "threshold per tally)")
    p.add_argument("--gen_epochs", type=int, default=20)
    p.add_argument("--exe_epochs", type=int, default=100)
    p.add_argument("--executor_preset", default="executor",
                   help="executor-family preset for training + tally "
                        "(executor_roi recommended: the round-3 diagnosis "
                        "shows plain positional cross-attention leaves "
                        "query_color at chance; executor_roi_sim adds the "
                        "content-similarity channel for same_*)")
    p.add_argument("--ft_epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--eval_limit", type=int, default=0)
    p.add_argument("--cogent_b_root", default=None,
                   help="CoGenT condition-B root: adds the Table 4.6 cells")
    p.set_defaults(fn=cmd_repro_clevr)
