"""Thesis-shaped accuracy and per-function P/R tables on synthetic data,
ported from ``scripts/demo_accuracy_table.py``.

One run produces every table format the thesis reports:

- Table 4.2: answer accuracy by question type (full generate -> parse ->
  chain pipeline on held-out scenes),
- Tables 4.3/4.4: per-function box P/R @ IoU 0.5 and token accuracy on the
  executor's PREDICTED chains (GT program structure, the model's own
  dependency outputs), with F1-max confidence calibration,
- Table 4.5: faithfulness quadrants,
- program EM from the generator.

Appends/refreshes the '## Accuracy tables' section of ``DEMO_TORCH.md`` (or
``$DEMO_OUT``; idempotent markers).  Env knobs as in the JAX script:
DEMO_DEVICE (default cuda, in place of DEMO_PLATFORM), DEMO_SCENES, DEMO_QPS,
DEMO_HOP_PROB, DEMO_CHAIN_PROB, DEMO_PALETTE, DEMO_GEN_STEPS, DEMO_EXE_STEPS,
DEMO_NOISE, DEMO_DROP, DEMO_SEED, DEMO_LR_SCHEDULE, DEMO_DMODEL, DEMO_LAYERS,
DEMO_BOX_ROI, DEMO_ROI_SIM, DEMO_SIM_HEADS, DEMO_COUNT_EMBED, DEMO_PER_FN_CONF,
DEMO_CONF_FIT, DEMO_CONF_FIT_N, DEMO_OUT.  At ``DEMO_DMODEL=512`` (4 heads of
128) the chain runs launch K2 in the fusion encoder and K1 in the box decoder.

The trained weights are kept after each training phase in
``results/acc_ckpt_torch_<DEMO_OUT basename>.pkl`` (the port's state dicts as
numpy arrays, with the run's protocol signature), so a run that fails in
evaluation resumes with 0 training steps.

    python -m explainable_spatial_vqa_tpu_torch.demos.accuracy_table
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Any, Dict

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.core import vocab as voc
from explainable_spatial_vqa_tpu_torch.core.artifacts import encode_questions
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig
from explainable_spatial_vqa_tpu_torch.core.vocab import canonicalize, invert_vocab
from explainable_spatial_vqa_tpu_torch.demos.common import (
    demo_device,
    held_out,
    platform_label,
    results_path,
    splice_section,
    synthetic_corpus,
)
from explainable_spatial_vqa_tpu_torch.evalsuite.accuracy import answer_accuracy_by_type
from explainable_spatial_vqa_tpu_torch.evalsuite.executor_eval import (
    build_conf_threshold_vector,
    calibrate_chain_conf_threshold,
    calibrate_chain_conf_thresholds_per_function,
    tally_predicted_chains,
)
from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
from explainable_spatial_vqa_tpu_torch.infer.pipeline import InferencePipeline
from explainable_spatial_vqa_tpu_torch.train.datasets import (
    ChainArrays,
    _parse_question_steps,
    executor_chain_step_arrays,
)
from explainable_spatial_vqa_tpu_torch.train.synthetic_protocol import (
    train_executor_synthetic,
    train_generator_synthetic,
)

BEGIN = "<!-- accuracy-tables:begin -->"
END = "<!-- accuracy-tables:end -->"


def ckpt_path() -> str:
    """The run's checkpoint under results/, keyed by the DEMO_OUT basename
    (as the JAX script keys its own) so that concurrent runs do not collide."""
    out = os.environ.get("DEMO_OUT", "")
    tag = os.path.splitext(os.path.basename(out))[0] if out else "default"
    return results_path(f"acc_ckpt_torch_{tag}.pkl")


def _load_ckpt(path: str, sig: dict) -> dict:
    """The checkpoint if its protocol signature matches, else a fresh one."""
    if not os.path.exists(path):
        return {"sig": sig}
    try:
        with open(path, "rb") as f:
            ck = pickle.load(f)
    except Exception as e:  # a truncated file from a mid-write kill
        print(f"checkpoint {path} unreadable ({e}) — starting fresh")
        return {"sig": sig}
    if ck.get("sig") != sig:
        print(f"checkpoint {path} protocol-signature mismatch — ignoring")
        return {"sig": sig}
    return ck


def _save_ckpt(path: str, ck: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(ck, f)
    os.replace(tmp, path)  # atomic: a mid-write kill cannot corrupt it


def _state(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def _tensors(state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in state.items()}


def _filter_chains(annotated, split_vocab, max_steps):
    """The chain arrays' own skip rule (``_parse_question_steps``), so
    that tally rows align."""
    return [a for a in annotated
            if 0 < len(_parse_question_steps(a, split_vocab["function"], split_vocab["other"]))
            <= max_steps]


def _chains(annotated, split_vocab, max_steps, num_queries) -> ChainArrays:
    arrays = executor_chain_step_arrays(
        annotated, split_vocab["function"], split_vocab["other"],
        max_steps=max_steps, max_output_boxes=num_queries)
    return ChainArrays(image_index=arrays["image_index"], functions=arrays["functions"],
                       deps=arrays["deps"], num_steps=arrays["num_steps"], answers=[])


def run() -> Dict[str, Any]:
    """Train (or resume), evaluate and splice the section; returns the
    trained executor with its config, the evaluation chains with their
    records and image tokens, and the section."""
    device = demo_device()
    t0 = time.time()
    num_scenes = int(os.environ.get("DEMO_SCENES", "800"))
    qps = int(os.environ.get("DEMO_QPS", "6"))
    hop_prob = float(os.environ.get("DEMO_HOP_PROB", "1.0"))
    chain_prob = float(os.environ.get("DEMO_CHAIN_PROB", "0.8"))
    palette = int(os.environ.get("DEMO_PALETTE", "4"))
    gen_steps = int(os.environ.get("DEMO_GEN_STEPS", "1000"))
    exe_steps = int(os.environ.get("DEMO_EXE_STEPS", "12000"))
    noise = float(os.environ.get("DEMO_NOISE", "0.03"))
    drop = float(os.environ.get("DEMO_DROP", "0.1"))
    seed = int(os.environ.get("DEMO_SEED", "3"))
    lr_schedule = os.environ.get("DEMO_LR_SCHEDULE", "constant")
    d_model = int(os.environ.get("DEMO_DMODEL", "0"))  # 0 = protocol default
    layers = int(os.environ.get("DEMO_LAYERS", "2"))  # encoder layers
    box_roi = bool(int(os.environ.get("DEMO_BOX_ROI", "1")))
    roi_sim = bool(int(os.environ.get("DEMO_ROI_SIM", "0")))
    sim_heads = int(os.environ.get("DEMO_SIM_HEADS", "1"))
    count_embed = bool(int(os.environ.get("DEMO_COUNT_EMBED", "0")))
    per_fn_conf = bool(int(os.environ.get("DEMO_PER_FN_CONF", "0")))
    # the confidence-threshold calibration split: "eval" (fit on the eval
    # questions themselves) or "train" (held-in TRAIN-scene chains: every
    # reported number out of sample)
    conf_fit = os.environ.get("DEMO_CONF_FIT", "eval")
    if conf_fit not in ("eval", "train"):
        raise ValueError(f"DEMO_CONF_FIT must be 'eval' or 'train', not {conf_fit!r}")
    conf_fit_n = int(os.environ.get("DEMO_CONF_FIT_N", "1500"))
    max_steps = 16  # chained hops reach 16 nodes (max_nodes below)

    print(f"synthesizing corpus ({num_scenes} scenes x {qps}, "
          f"hop_prob={hop_prob}, chain_prob={chain_prob})...")
    _, questions, annotated, split_vocab, features = synthetic_corpus(
        num_scenes, qps, seed, hop_prob=hop_prob, chain_prob=chain_prob, max_nodes=max_steps,
        palette_size=palette)
    clevr_vocab = voc.build_clevr_vocab([questions])
    train_q, eval_q = held_out(questions, num_scenes)
    train_ann, eval_ann = held_out(annotated, num_scenes)
    features_dev = torch.as_tensor(features, device=device)

    sig = dict(scenes=num_scenes, qps=qps, hop_prob=hop_prob, chain_prob=chain_prob,
               palette=palette, gen_steps=gen_steps, exe_steps=exe_steps, noise=noise, drop=drop,
               seed=seed, lr_schedule=lr_schedule, d_model=d_model, layers=layers,
               box_roi=box_roi, roi_sim=roi_sim, sim_heads=sim_heads, count_embed=count_embed)
    path = ckpt_path()
    ck = _load_ckpt(path, sig)

    if "gen" in ck:
        print("resuming TRAINED generator from checkpoint (0 steps)...")
        generator, _gcfg, _ = train_generator_synthetic(
            train_q, clevr_vocab, steps=0, seed=seed, lr_schedule=lr_schedule,
            init_variables=_tensors(ck["gen"]["vars"]), device=device)
        gen_loss = float(ck["gen"]["loss"])
    else:
        print(f"training generator on {len(train_q)} questions...")
        generator, _gcfg, gen_loss = train_generator_synthetic(
            train_q, clevr_vocab, steps=gen_steps, seed=seed, lr_schedule=lr_schedule,
            device=device)
        ck["gen"] = {"vars": _state(generator), "loss": gen_loss}
        _save_ckpt(path, ck)
    print(f"  final loss {gen_loss:.4f}")

    exe_config = None
    if d_model or layers != 2:
        exe_config = ExecutorConfig(
            vocab_size=len(split_vocab["function"]) + 1,
            d_model=d_model or 96, num_heads=4, encoder_layers=layers,
            box_decoder_layers=1, num_queries=8, num_image_tokens=196,
            image_feature_dim=64, max_input_boxes=8,
            token_classes=len(split_vocab["other"]) + 1, dropout=0.0,
            input_box_noise=noise, input_box_drop=drop, box_roi=box_roi,
            roi_sim=roi_sim, roi_sim_heads=sim_heads, count_embed=count_embed,
        )
    exe_kwargs = dict(seed=seed, noise=noise, drop=drop, lr_schedule=lr_schedule,
                      config=exe_config, box_roi=box_roi, roi_sim=roi_sim,
                      roi_sim_heads=sim_heads if roi_sim else None, count_embed=count_embed,
                      device=device)
    if "exe" in ck:
        print("resuming TRAINED executor from checkpoint (0 steps)...")
        executor, exe_cfg, _ = train_executor_synthetic(
            train_ann, split_vocab, features_dev, steps=0,
            init_variables=_tensors(ck["exe"]["vars"]), **exe_kwargs)
        exe_loss = float(ck["exe"]["loss"])
    else:
        print(f"training executor on {len(train_ann)} annotated questions "
              f"({exe_steps} steps, noise={noise}, drop={drop}, "
              f"lr_schedule={lr_schedule}"
              + (f", d_model={d_model}" if d_model else "") + ")...")
        executor, exe_cfg, exe_loss = train_executor_synthetic(
            train_ann, split_vocab, features_dev, steps=exe_steps, **exe_kwargs)
        ck["exe"] = {"vars": _state(executor), "loss": exe_loss}
        _save_ckpt(path, ck)
    print(f"  final loss {exe_loss:.4f}")
    generator.eval()
    executor.eval()

    # ---- Table 4.2 + 4.5: full pipeline on held-out scenes ----
    enc_eval = encode_questions(eval_q, clevr_vocab)
    program_inv = invert_vocab(clevr_vocab["program_token_to_idx"])
    answer_inv = invert_vocab(clevr_vocab["answer_token_to_idx"])
    runner = ExecutorChainRunner(executor, exe_cfg, max_steps=max_steps, device=device)
    pipeline = InferencePipeline(generator, runner, program_inv, split_vocab["function"],
                                 device=device)
    gt_value_ids = np.asarray([
        split_vocab["other"].get(canonicalize(answer_inv.get(int(a), "")), -2)
        for a in enc_eval.answers
    ])
    result = pipeline.run(enc_eval.questions, features_dev, enc_eval.image_idxs,
                          gt_answers=gt_value_ids, gt_programs=enc_eval.programs)
    final_functions = [q["program"][-1]["function"] for q in eval_q]
    pred = np.where(result.answer_valid, result.answers, -1)
    acc = answer_accuracy_by_type(pred, gt_value_ids, final_functions)
    print("by-type accuracy:", {k: round(v, 3) for k, v in acc.items()})

    # ---- Tables 4.3/4.4: per-function P/R on PREDICTED chains ----
    eval_ann = _filter_chains(eval_ann, split_vocab, max_steps)
    chains = _chains(eval_ann, split_vocab, max_steps, exe_cfg.num_queries)
    img = features_dev[torch.as_tensor(chains.image_index, device=device).long()]
    run_out = runner.run_sorted(img, chains, batch=128)

    # the calibration set: the eval chains themselves, or a subsample of
    # held-in TRAIN-scene chains run through the same runner
    if conf_fit == "train":
        calib_ann = _filter_chains(train_ann, split_vocab, max_steps)
        if len(calib_ann) > conf_fit_n:
            rng = np.random.default_rng(seed + 1)
            idx = rng.choice(len(calib_ann), size=conf_fit_n, replace=False)
            calib_ann = [calib_ann[i] for i in sorted(idx)]
        cal_chains = _chains(calib_ann, split_vocab, max_steps, exe_cfg.num_queries)
        cal_img = features_dev[torch.as_tensor(cal_chains.image_index, device=device).long()]
        calib_run_out = runner.run_sorted(cal_img, cal_chains, batch=128)
        print(f"conf thresholds fit on {len(calib_ann)} TRAIN-scene chains")
    else:
        calib_ann, calib_run_out = eval_ann, run_out

    # the baseline protocol always runs (a global F1 threshold on default-
    # propagation chains), so per_fn_conf runs stay paired with it
    thr, f1 = calibrate_chain_conf_threshold(
        calib_run_out, calib_ann, split_vocab["function"], split_vocab["other"],
        max_steps=max_steps)
    print(f"calibrated conf threshold {thr:.2f} (calib-split F1 {f1:.3f})")
    thr_label = f"{thr:.2f}" + (" train-fit" if conf_fit == "train" else "")
    det = tally_predicted_chains(
        run_out, eval_ann, split_vocab["function"], split_vocab["other"],
        conf_threshold=thr, max_steps=max_steps)

    det_pf = acc_pf = result_pf = thr_map = None
    if per_fn_conf:
        # per-FUNCTION operating points: run both the annotated chains and
        # the answer pipeline again with the per-function propagation gate
        thr_map, _f1_map = calibrate_chain_conf_thresholds_per_function(
            calib_run_out, calib_ann, split_vocab["function"], split_vocab["other"],
            max_steps=max_steps)
        print("per-function conf thresholds:",
              {k: round(v, 2) for k, v in sorted(thr_map.items())})
        vec = build_conf_threshold_vector(split_vocab["function"], thr_map)
        runner_pf = ExecutorChainRunner(executor, exe_cfg, max_steps=max_steps,
                                        conf_thresholds=vec, device=device)
        run_out_pf = runner_pf.run_sorted(img, chains, batch=128)
        det_pf = tally_predicted_chains(
            run_out_pf, eval_ann, split_vocab["function"], split_vocab["other"],
            conf_threshold=thr_map, max_steps=max_steps)
        pipeline_pf = InferencePipeline(generator, runner_pf, program_inv,
                                        split_vocab["function"], device=device)
        result_pf = pipeline_pf.run(enc_eval.questions, features_dev, enc_eval.image_idxs,
                                    gt_answers=gt_value_ids, gt_programs=enc_eval.programs)
        pred_pf = np.where(result_pf.answer_valid, result_pf.answers, -1)
        acc_pf = answer_accuracy_by_type(pred_pf, gt_value_ids, final_functions)
        print("by-type accuracy (per-function conf):",
              {k: round(v, 3) for k, v in acc_pf.items()})

    elapsed = time.time() - t0
    type_keys = ["overall"] + sorted(k for k in acc if k != "overall")
    pr = det.precision_recall()
    tok = det.token_accuracy()
    section = "\n".join([
        BEGIN,
        "## Accuracy tables (thesis Tables 4.2-4.5 formats, synthetic data)",
        "",
        f"`python -m explainable_spatial_vqa_tpu_torch.demos.accuracy_table` — {num_scenes} "
        f"scenes × {qps} questions (hop_prob={hop_prob}, chain_prob={chain_prob}: "
        "scene-aware relate/same_* joins), "
        f"{exe_steps} executor steps (grounding noise {noise}/{drop}"
        + (f", lr_schedule={lr_schedule}" if lr_schedule != "constant" else "")
        + (f", d_model={d_model}" if d_model else "")
        + (f", {layers}L encoder" if layers != 2 else "")
        + (f", palette={palette}" if palette != 4 else "")
        + (", box_roi" if box_roi else "")
        + ((f", roi_sim(K={sim_heads})" if sim_heads != 1 else ", roi_sim")
           if roi_sim else "")
        + (", count_embed" if count_embed else "")
        + (", conf thresholds fit on train-scene chains (out-of-sample)"
           if conf_fit == "train" else "")
        + f"), {len(eval_q)} eval questions on held-out scenes, platform "
        f"{platform_label(device)}, {elapsed:.0f}s.",
        "",
        "### Answer accuracy by question type (Table 4.2 format; "
        "reference: 70.3 overall on real CLEVR)",
        "",
        "| " + " | ".join(type_keys) + " |",
        "|" + "---|" * len(type_keys),
        "| " + " | ".join(f"{acc.get(k, float('nan')):.3f}" for k in type_keys) + " |",
        "",
        "Program EM {:.3f} (correct-program fraction of the faithfulness "
        "tally)".format(sum(v for k, v in result.tally.as_fractions().items()
                            if k.startswith("correct_program"))),
        "",
        "### Per-function box P/R @ IoU 0.5 on predicted chains "
        f"(Table 4.3 format; conf threshold {thr_label} F1-calibrated)",
        "",
        "| function | precision | recall | gt boxes |",
        "|---|---|---|---|",
        *(f"| {fn} | {v['precision']:.3f} | {v['recall']:.3f} | {det.box_gt[fn]} |"
          for fn, v in sorted(pr.items())),
        "",
        "### Token accuracy by function on predicted chains (Table 4.4 format)",
        "",
        "| function | accuracy |",
        "|---|---|",
        *(f"| {fn} | {v:.3f} |" for fn, v in sorted(tok.items())),
        "",
        "### Faithfulness quadrants (Table 4.5 protocol)",
        "",
        "```",
        result.tally.report(),
        "```",
    ] + ([] if det_pf is None else [
        "",
        "### With per-function confidence operating points "
        "(same model, per-function F1 thresholds gate tally AND in-chain propagation)",
        "",
        "| " + " | ".join(type_keys) + " |",
        "|" + "---|" * len(type_keys),
        "| " + " | ".join(f"{acc_pf.get(k, float('nan')):.3f}" for k in type_keys) + " |",
        "",
        "| function | precision | recall | gt boxes | thr |",
        "|---|---|---|---|---|",
        *(f"| {fn} | {v['precision']:.3f} | {v['recall']:.3f} | {det_pf.box_gt[fn]} "
          f"| {thr_map.get(fn, thr_map['__global__']):.2f} |"
          for fn, v in sorted(det_pf.precision_recall().items())),
        "",
        "| function | token accuracy |",
        "|---|---|",
        *(f"| {fn} | {v:.3f} |" for fn, v in sorted(det_pf.token_accuracy().items())),
        "",
        "```",
        result_pf.tally.report(),
        "```",
    ]) + [END])

    demo_path = splice_section(section, BEGIN, END)
    print(f"wrote section to {demo_path}")
    print(section)
    return dict(executor=executor, exe_cfg=exe_cfg, split_vocab=split_vocab, chains=chains,
                eval_annotated=eval_ann, image_tokens=img, max_steps=max_steps, section=section)


def main() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    run()


if __name__ == "__main__":
    main()
