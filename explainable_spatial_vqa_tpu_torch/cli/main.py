"""CLI of the port, ported from ``explainable_spatial_vqa_tpu/cli/main.py``
with its flags, defaults, log lines, printed reports and JSON payloads:

  build-vocab     the CLEVR three-way vocab over question JSONs
  preprocess-questions
                  question JSON -> questions h5 (encoded questions,
                  programs, answers)
  extract-features
                  PNGs -> features h5: ResNet-101 stage 3 on the device,
                  after the JAX package's antialiased cubic resize
                  (``vision/extract.py``); ``--torch-weights`` loads a
                  torchvision resnet101 state dict
  export-scenes   scene JSON -> scenes h5 (boxes and class labels, or with
                  ``--layout attributes`` attribute codes and coordinates)
  annotate        per-step annotations of questions over their scenes
                  (``v3`` split vocab, ``full`` joint vocab, ``string``)
  train           every training family of the JAX package (``generator``,
                  the five ``executor*`` presets, ``executor_scheduled``,
                  the baselines ``iqap``, ``lstm_iqap`` and
                  ``step_seq2seq``, the chain-of-thought ``iqap_cot``,
                  which reads ``DataConfig``'s ``mapped_sequences_h5`` and
                  ``string_vocab_json`` as JAX's CLI does (no flag), and the
                  eight ``prototype_step`` presets; ``--image_dir`` for
                  ``yolo_bb``)
  presets         the preset names
  eval-generator  greedy program accuracy, teacher-forced and best-beam
  tally           faithfulness quadrants and answer accuracy by type; with
                  ``--annotated_h5`` the per-step box P/R and token accuracy
                  on predicted chains, with confidence calibration
  cogent-protocol the four-cell CoGenT A->B protocol on synthetic corpora
                  (train on A, evaluate valA/valB, fine-tune on a B subset,
                  evaluate again)
  eval-iqap       the Transformer IQAP baseline's answers and greedy
                  programs in one forward: accuracy summary and per-question
                  records
  infer-chain     chained inference of the step seq2seq baseline over
                  annotated questions in the joint vocabulary
  stats           dataset invariants of an annotated h5, as JSON
  visualize       one scene's boxes drawn over its image
  inspect         an h5 file's datasets, shapes, types and first rows
  repro-clevr     the whole chain from a CLEVR download root to REPORT.md
                  (``cli/repro.py``)

A global ``--device`` (default ``cuda``) places the models and stands for
the JAX CLI's ``--platform``; without a card the model commands and
``extract-features`` raise unless it is ``cpu``.  The global ``--multihost``
(with ``--coordinator_address``, ``--num_processes`` and ``--process_id``,
or the environment ``torchrun`` sets) joins the process group before the
command runs (``parallel.multihost.initialize``): ``train`` then trains data
parallel, and ``tally`` and ``infer-chain`` with ``--data_parallel`` serve
their chains data parallel over the processes (one process warns and serves
unsharded, as JAX does on one device).  Only rank 0 writes the output
files.  Each command reads its artifacts (h5, JSON) and parses its flags,
and hands arrays and modules to a function that does the work
(:func:`run_eval_generator`, :func:`run_tally`, :func:`run_eval_iqap`,
:func:`run_infer_chain`), which callers holding data in memory call
directly.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger("esv_torch.cli")

__all__ = ["TallyResult", "build_parser", "identity_function_vocab", "main", "run_chains",
           "run_eval_generator", "run_eval_iqap", "run_infer_chain", "run_tally"]

MAX_STEPS = 28  # the tally's chain depth bound, as in the JAX package's CLI


def _device(args: argparse.Namespace) -> torch.device:
    from explainable_spatial_vqa_tpu_torch.device import resolve_device

    return resolve_device(args.device)


def _serve_mesh(args: argparse.Namespace):
    """The 1-D data mesh of ``--data_parallel`` chained serving over the
    process group, or None (unsharded: no flag, or one process)."""
    if not getattr(args, "data_parallel", False):
        return None
    from explainable_spatial_vqa_tpu_torch.parallel.mesh import make_mesh
    from explainable_spatial_vqa_tpu_torch.parallel.multihost import process_count

    if process_count() < 2:
        logger.warning("--data_parallel requested but only 1 process is running; "
                       "serving unsharded")
        return None
    logger.info("serving sharded over %d processes", process_count())
    return make_mesh((-1,), ("data",))


def _writes_files() -> bool:
    """Whether this process writes the command's output files (rank 0)."""
    from explainable_spatial_vqa_tpu_torch.parallel.multihost import process_index

    return process_index() == 0


def _restore(model: torch.nn.Module, directory: Optional[str], name: str) -> None:
    """Load the best snapshot a port ``Trainer`` saved in ``directory``."""
    if not directory:
        return
    from explainable_spatial_vqa_tpu_torch.train.checkpoints import CheckpointStore

    store = CheckpointStore(directory)
    best = store.restore_best()
    store.close()
    if best is None:
        logger.warning("no %s checkpoint at %s (random weights)", name, directory)
        return
    model.load_state_dict(best["model"])
    logger.info("restored %s checkpoint from %s", name, directory)


# ---------------------------------------------------------------------------
# data preparation
# ---------------------------------------------------------------------------


def cmd_build_vocab(args: argparse.Namespace) -> None:
    from explainable_spatial_vqa_tpu_torch.core.artifacts import load_questions_json
    from explainable_spatial_vqa_tpu_torch.core.vocab import build_clevr_vocab, save_vocab

    vocab = build_clevr_vocab([load_questions_json(p) for p in args.inputs])
    save_vocab(vocab, args.output)
    logger.info("wrote %s (%d program / %d question / %d answer tokens)",
                args.output, len(vocab["program_token_to_idx"]),
                len(vocab["question_token_to_idx"]), len(vocab["answer_token_to_idx"]))


def cmd_preprocess_questions(args: argparse.Namespace) -> None:
    from explainable_spatial_vqa_tpu_torch.core.artifacts import (
        encode_questions,
        load_questions_json,
        write_questions_h5,
    )
    from explainable_spatial_vqa_tpu_torch.core.vocab import load_vocab

    encoded = encode_questions(load_questions_json(args.input_questions_json),
                               load_vocab(args.input_vocab_json), mode=args.mode,
                               allow_unk=bool(args.encode_unk))
    write_questions_h5(encoded, args.output_h5_file)
    logger.info("wrote %s questions=%s programs=%s", args.output_h5_file,
                encoded.questions.shape,
                None if encoded.programs is None else encoded.programs.shape)


def cmd_extract_features(args: argparse.Namespace) -> None:
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.vision.extract import (
        collect_image_paths,
        extract_features,
    )
    from explainable_spatial_vqa_tpu_torch.vision.resnet import (
        ResNetFeatures,
        load_torchvision_state_dict,
    )

    device = _device(args)
    paths = collect_image_paths(args.input_image_dir, args.max_images)
    model = ResNetFeatures(num_stages=args.model_stage, device=device)
    if args.torch_weights:
        load_torchvision_state_dict(model, torch.load(args.torch_weights, map_location="cpu",
                                                      weights_only=True))
        logger.info("loaded torchvision weights from %s", args.torch_weights)
    else:
        init_parameters(model, seed=0)
        logger.warning("no --torch-weights given: using random ResNet weights "
                       "(features will not match the reference numerically)")
    extract_features(paths, args.output_h5_file, model=model, batch_size=args.batch_size,
                     size=(args.image_height, args.image_width), resize=args.resize,
                     device=device)
    logger.info("wrote %s (%d images)", args.output_h5_file, len(paths))


def cmd_export_scenes(args: argparse.Namespace) -> None:
    from explainable_spatial_vqa_tpu_torch.clevr.bboxes import export_scenes
    from explainable_spatial_vqa_tpu_torch.core.artifacts import load_scenes_json, write_scenes_h5

    scenes = load_scenes_json(args.input_scenes_json)
    if args.layout == "attributes":
        import h5py

        from explainable_spatial_vqa_tpu_torch.core.reshape import export_scene_attributes

        arrays, vocab = export_scene_attributes(scenes)
        with h5py.File(args.output_h5_file, "w") as f:
            for key, value in arrays.items():
                f.create_dataset(key, data=value)
        if args.vocab_output:
            with open(args.vocab_output, "w") as f:
                json.dump(vocab, f, indent=2)
        logger.info("wrote %s (attributes layout)", args.output_h5_file)
        return
    out = export_scenes(scenes, decimals=args.decimals)
    write_scenes_h5(args.output_h5_file, out["bounding_boxes"], out["class_labels"],
                    out["image_index"], out["image_filename"])
    logger.info("wrote %s (%d scenes, max %d objects)", args.output_h5_file,
                out["bounding_boxes"].shape[0], out["bounding_boxes"].shape[1])


def cmd_annotate(args: argparse.Namespace) -> None:
    import copy

    from explainable_spatial_vqa_tpu_torch.clevr import annotate as ann
    from explainable_spatial_vqa_tpu_torch.clevr.scenes import load_scenes
    from explainable_spatial_vqa_tpu_torch.core import vocab as voc
    from explainable_spatial_vqa_tpu_torch.core.artifacts import (
        load_questions_json,
        write_annotated_h5,
    )

    scenes = load_scenes(args.scenes)
    questions = load_questions_json(args.questions)
    if args.limit:
        questions = questions[:args.limit]
    logger.info("annotating %d questions over %d scenes (%s mode, %d workers)",
                len(questions), len(scenes), args.mode, args.workers)
    if args.mode == "string":
        from explainable_spatial_vqa_tpu_torch.core import annotated_strings as astr

        annotated = [ann.annotate_question_string(q, scenes[q["image_index"]])
                     for q in questions if q["image_index"] in scenes]
        arrays, token_to_id = astr.build_mapped_sequences(annotated)
        astr.write_mapped_sequences(arrays, args.output_h5)
        with open(args.vocab_output, "w") as f:
            json.dump({"token_to_id": token_to_id,
                       "id_to_token": {str(v): k for k, v in token_to_id.items()}}, f, indent=2)
        if args.raw_json:
            with open(args.raw_json, "w") as f:
                json.dump({"questions": annotated}, f)
        logger.info("wrote %s (+ vocab %s)", args.output_h5, args.vocab_output)
        return
    if args.mode == "v3":
        annotated = ann.annotate_questions(questions, scenes, num_workers=args.workers)
        vocabs = voc.build_split_vocab(annotated)
        converted = [voc.apply_split_vocab(copy.deepcopy(q), vocabs) for q in annotated]
        layout = "per_question"
    else:
        annotated = [ann.annotate_question_full(q, scenes[q["image_index"]])
                     for q in questions if q["image_index"] in scenes]
        vocabs = voc.build_joint_vocab(annotated)
        converted = [voc.apply_joint_vocab(copy.deepcopy(q), vocabs) for q in annotated]
        layout = "blob"
    if args.raw_json:
        with open(args.raw_json, "w") as f:
            json.dump({"questions": annotated}, f)
    with open(args.vocab_output, "w") as f:
        json.dump(vocabs, f, indent=4)
    write_annotated_h5(converted, args.output_h5, layout=layout)
    logger.info("wrote %s (+ vocab %s)", args.output_h5, args.vocab_output)


def cmd_stats(args: argparse.Namespace) -> None:
    """Dataset invariants over annotated questions: max boxes per step, max
    output tokens, function vocab size, box/token output case counts."""
    from explainable_spatial_vqa_tpu_torch.core.artifacts import read_annotated_h5
    from explainable_spatial_vqa_tpu_torch.train.datasets import parse_boxes

    annotated = read_annotated_h5(args.annotated_h5)
    max_in_boxes = max_out_boxes = max_tokens = max_steps = 0
    functions = set()
    box_steps = token_steps = empty_steps = 0
    for q in annotated:
        steps = q.get("annotated_program", [])
        max_steps = max(max_steps, len(steps))
        for step in steps:
            functions.add(step.get("function", ""))
            n_in = len(parse_boxes(step.get("input_values", "")))
            n_out = len(parse_boxes(step.get("output_values", "")))
            max_in_boxes = max(max_in_boxes, n_in)
            max_out_boxes = max(max_out_boxes, n_out)
            out_text = step.get("output_values", "").strip()
            max_tokens = max(max_tokens, len(out_text.split()))
            if n_out:
                box_steps += 1
            elif out_text:
                token_steps += 1
            else:
                empty_steps += 1
    report = {
        "questions": len(annotated),
        "max_steps": max_steps,
        "max_input_boxes": max_in_boxes,
        "max_output_boxes": max_out_boxes,
        "max_output_tokens": max_tokens,
        "function_vocab_size": len(functions),
        "box_output_steps": box_steps,
        "token_output_steps": token_steps,
        "empty_output_steps": empty_steps,
    }
    print(json.dumps(report, indent=2))


def cmd_visualize(args: argparse.Namespace) -> None:
    """One scene's approximated ground-truth boxes drawn over its image (a
    black 480x320 canvas without ``--image``)."""
    from PIL import Image

    from explainable_spatial_vqa_tpu_torch.clevr.bboxes import scene_bounding_boxes
    from explainable_spatial_vqa_tpu_torch.core.artifacts import load_scenes_json
    from explainable_spatial_vqa_tpu_torch.utils.visualize import draw_boxes

    scenes = load_scenes_json(args.input_scenes_json)
    scene = next(s for s in scenes if s["image_index"] == args.image_index)
    boxes = scene_bounding_boxes(scene, decimals=None)
    if args.image:
        image = Image.open(args.image).convert("RGB")
    else:
        image = Image.new("RGB", (480, 320), "black")
    labels = [f"{o['size']} {o['color']} {o['material']} {o['shape']}" for o in scene["objects"]]
    draw_boxes(image, boxes.tolist(), labels=labels if args.labels else None)
    image.save(args.output)
    logger.info("wrote %s (%d boxes)", args.output, len(boxes))


def cmd_inspect(args: argparse.Namespace) -> None:
    import h5py

    with h5py.File(args.file, "r") as f:
        print(f"datasets in {args.file}:")

        def show(name, obj):
            if isinstance(obj, h5py.Dataset):
                print(f"  {name}: shape={obj.shape} dtype={obj.dtype}")
                if args.n and obj.shape and obj.shape[0]:
                    head = obj[: min(args.n, obj.shape[0])]
                    print(f"    first {args.n}: {np.asarray(head)!r}"[:500])
        f.visititems(show)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


def cmd_train(args: argparse.Namespace) -> None:
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.train.pipelines import build_pipeline
    from explainable_spatial_vqa_tpu_torch.train.trainer import Trainer

    device = _device(args)
    config = get_preset(args.preset)
    data_overrides = {}
    for name in ("features_h5", "questions_h5", "annotated_h5", "vocab_json",
                 "split_vocab_json", "image_dir"):
        value = getattr(args, name, None)
        if value:
            data_overrides[name] = value
    if args.subset_fraction is not None:
        data_overrides["subset_fraction"] = args.subset_fraction
    if data_overrides:
        config = config.replace(data=dataclasses.replace(config.data, **data_overrides))
    train_overrides = {}
    if args.epochs is not None:
        train_overrides["num_epochs"] = args.epochs
    if args.batch_size is not None:
        train_overrides["batch_size"] = args.batch_size
    if train_overrides:
        config = config.replace(train=dataclasses.replace(config.train, **train_overrides))

    pipeline = build_pipeline(config, device)
    trainer = Trainer(pipeline.loss_fn, pipeline.model, config.optim, config.train,
                      steps_per_epoch=pipeline.steps_per_epoch,
                      checkpoint_dir=args.checkpoint_dir, device=device)
    history = trainer.fit(pipeline.train_batches, pipeline.val_batches,
                          monitor=pipeline.monitor)
    logger.info("training done; best %s = %.4f", pipeline.monitor, trainer.best_metric)
    if args.eval_test:
        acc = trainer.evaluate_best(pipeline.test_batches())
        logger.info("test: loss %.4f, %s = %.4f", acc.mean("loss_sum"),
                    "/".join(pipeline.monitor), acc.ratio(*pipeline.monitor))
        history["test"] = [acc.totals]
    trainer.store.close()
    if not _writes_files():
        return
    if args.history_json:
        with open(args.history_json, "w") as f:
            json.dump(history, f, default=float)
    if args.plot:
        from explainable_spatial_vqa_tpu_torch.utils.plots import plot_history

        plot_history(history, args.plot)
        logger.info("wrote %s", args.plot)


# ---------------------------------------------------------------------------
# eval-generator
# ---------------------------------------------------------------------------


def _on(a, device: torch.device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    return t.to(device=device, dtype=dtype)


def _batched(fn, batch_size: int, *columns: np.ndarray) -> np.ndarray:
    """``fn`` over full batches plus a PADDED tail batch, so every sample is
    scored; padding repeats the last row and is sliced off."""
    outputs = []
    n = len(columns[0])
    for start in range(0, n, batch_size):
        chunk = [col[start:start + batch_size] for col in columns]
        if len(chunk[0]) < batch_size:
            chunk = [np.concatenate([c, np.repeat(c[-1:], batch_size - len(c), axis=0)])
                     for c in chunk]
        outputs.append(fn(*chunk).cpu().numpy())
    return np.concatenate(outputs)[:n]


def run_eval_generator(model, questions: np.ndarray, programs: np.ndarray,
                       batch_size: int = 64, compare_tf: bool = False, beam_size: int = 0,
                       device="cuda") -> Tuple[Dict[str, Any], np.ndarray]:
    """Program accuracy of ``model`` (a ``ProgramGenerator``) on encoded
    questions and their programs: greedy decoding, with ``compare_tf`` the
    teacher-forced decode (gold prefix at every step), with ``beam_size`` > 1
    the best beam of ``beam_generate``.  Returns (the JAX CLI's payload, the
    greedy predictions)."""
    from explainable_spatial_vqa_tpu_torch.device import resolve_device
    from explainable_spatial_vqa_tpu_torch.evalsuite.accuracy import program_accuracy
    from explainable_spatial_vqa_tpu_torch.models.layers import eval_mode

    device = resolve_device(device)

    def on(a: np.ndarray) -> torch.Tensor:
        return _on(a, device)

    with torch.no_grad(), eval_mode(model):
        pred = _batched(lambda q: model.generate(on(q)), batch_size, questions)
        acc: Dict[str, Any] = program_accuracy(pred, programs)
        if compare_tf:
            tf_pred = _batched(
                lambda q, p: model(on(q), on(p), teacher_forcing=1.0)["tokens"], batch_size,
                questions, programs)
            acc["teacher_forced"] = program_accuracy(tf_pred, programs)
        if beam_size and beam_size > 1:
            beam_pred = _batched(lambda q: model.beam_generate(on(q), beam_size)[0][:, 0],
                                 batch_size, questions)
            beam_acc: Dict[str, Any] = program_accuracy(beam_pred, programs)
            beam_acc["beam_size"] = beam_size
            acc["beam"] = beam_acc
    return acc, pred


def cmd_eval_generator(args: argparse.Namespace) -> None:
    from explainable_spatial_vqa_tpu_torch.core.artifacts import read_questions_h5
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.core.vocab import invert_vocab, load_vocab
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.train.pipelines import model_dtype

    device = _device(args)
    enc = read_questions_h5(args.questions_h5)
    if enc.programs is None:
        raise SystemExit(f"{args.questions_h5} holds no programs")
    limit = args.limit or len(enc.questions)
    questions, programs = enc.questions[:limit], enc.programs[:limit]

    config = get_preset(args.preset)
    # the training pipeline's max(preset, data) sizing, so train-time
    # checkpoints restore with matching shapes
    model_cfg = dataclasses.replace(
        config.model,
        vocab_size=max(config.model.vocab_size, int(questions.max()) + 1),
        program_vocab_size=max(config.model.program_vocab_size, int(programs.max()) + 1),
        program_len=programs.shape[1],
    )
    model = init_parameters(ProgramGenerator(model_cfg, model_dtype(config, device), device), 0)
    _restore(model, args.checkpoint_dir, "generator")

    acc, pred = run_eval_generator(model, questions, programs, args.batch_size, args.compare_tf,
                                   args.beam_size, device)
    print(json.dumps(acc, indent=2))

    if args.show and args.vocab_json:
        inv = invert_vocab(load_vocab(args.vocab_json)["program_token_to_idx"])

        def decode(row) -> str:
            return " ".join(inv.get(int(t), "?") for t in row if t != 0)

        for i in range(min(args.show, len(pred))):
            print(f"[{i}] pred: {decode(pred[i])}")
            print(f"[{i}] gold: {decode(programs[i])}")


# ---------------------------------------------------------------------------
# tally
# ---------------------------------------------------------------------------


@dataclass
class TallyResult:
    pipeline: Any  # infer.pipeline.PipelineResult on the generated programs
    accuracy: Optional[Dict[str, float]] = None  # answer accuracy by question type
    step_tally: Any = None  # evalsuite.detection.DetectionTally on the annotated chains
    payload: Optional[Dict[str, Any]] = None  # the per-step JSON report
    conf_threshold: Any = None  # the per-step tally's threshold: a number or a map
    # one entry per executor run: its name, time.perf_counter() at its start
    # and its wall seconds (each ends in numpy on the host)
    runs: List[Dict[str, Any]] = field(default_factory=list)


def run_chains(runner, image_tokens, chains, chain_mode: str) -> Dict[str, np.ndarray]:
    """The annotated chains on ``runner``: the pool takes the per-IMAGE
    feature cache, every other mode the depth-sorted batches of per-question
    rows."""
    from explainable_spatial_vqa_tpu_torch.infer.pipeline import per_question_rows

    if chain_mode == "pool":
        return runner.run_pool(image_tokens, chains)
    return runner.run_sorted(per_question_rows(image_tokens, chains.image_index), chains)


def _final_functions(programs: np.ndarray, program_inv: Mapping[int, str]) -> List[str]:
    """Each gold program's last function: the token before <END>."""
    return [program_inv.get(int(row[row != 0][-2]) if (row != 0).sum() > 1 else 0, "")
            for row in programs]


def run_tally(generator, executor, exe_cfg, questions: np.ndarray, image_tokens,
              image_index: np.ndarray, program_inv: Mapping[int, str],
              function_vocab: Mapping[str, int], value_vocab: Mapping[str, int],
              gt_answers: Optional[np.ndarray] = None, programs: Optional[np.ndarray] = None,
              annotated: Optional[List[Dict[str, Any]]] = None, chain_mode: str = "sorted",
              iou_threshold: float = 0.5, calibrate_conf: bool = False,
              calibrate_conf_per_function: bool = False,
              conf_thresholds: Optional[Mapping[str, float]] = None,
              device="cuda", mesh=None) -> TallyResult:
    """The full pipeline on encoded questions (faithfulness quadrants and,
    with ``gt_answers`` in the value vocabulary and ``programs``, answer
    accuracy by question type), then, with ``annotated``, the per-step tally
    on the executor's predicted chains of the annotated programs.

    ``image_tokens``: the per-IMAGE (M, P, C) feature cache, numpy or a
    tensor; ``image_index`` maps questions to images.  The per-step tally's
    confidence threshold is, in order: the pre-fitted ``conf_thresholds``
    map (which also gates propagation), per-function F1 operating points
    fitted on a first run (``calibrate_conf_per_function``; the chains run
    again with them as the gate), one global F1 operating point
    (``calibrate_conf``; run again if it moved), or the config's.  With a
    ``mesh`` every chain runner serves data parallel over it
    (``--data_parallel``)."""
    from explainable_spatial_vqa_tpu_torch.device import resolve_device
    from explainable_spatial_vqa_tpu_torch.evalsuite.accuracy import answer_accuracy_by_type
    from explainable_spatial_vqa_tpu_torch.evalsuite.executor_eval import (
        build_conf_threshold_vector,
        calibrate_chain_conf_threshold,
        calibrate_chain_conf_thresholds_per_function,
        tally_predicted_chains,
    )
    from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
    from explainable_spatial_vqa_tpu_torch.infer.pipeline import InferencePipeline
    from explainable_spatial_vqa_tpu_torch.train.datasets import chain_arrays

    device = resolve_device(device)
    runs: List[Dict[str, Any]] = []

    def timed(name: str, fn):
        start = time.perf_counter()
        out = fn()
        runs.append({"name": name, "start": start, "seconds": time.perf_counter() - start})
        return out

    runner = ExecutorChainRunner(executor, exe_cfg, max_steps=MAX_STEPS, device=device,
                                 mesh=mesh)
    pipeline = InferencePipeline(generator, runner, program_inv, function_vocab, device=device)
    result = timed("pipeline", lambda: pipeline.run(
        questions, image_tokens, image_index, gt_answers=gt_answers, gt_programs=programs,
        chain_mode=chain_mode))
    accuracy = None
    if result.tally is not None:
        pred = np.where(result.answer_valid, result.answers, -1)
        accuracy = answer_accuracy_by_type(pred, gt_answers,
                                           _final_functions(programs, program_inv))
    out = TallyResult(result, accuracy, runs=runs)
    if annotated is None:
        return out

    chains = chain_arrays(annotated, function_vocab, max_steps=MAX_STEPS)

    def chain_run(name: str, cfg=exe_cfg, thr_map=None):
        vec = (None if thr_map is None
               else build_conf_threshold_vector(function_vocab, thr_map,
                                                default=exe_cfg.conf_threshold))
        rnr = ExecutorChainRunner(executor, cfg, max_steps=MAX_STEPS, conf_thresholds=vec,
                                  device=device, mesh=mesh)
        return timed(name, lambda: run_chains(rnr, image_tokens, chains, chain_mode))

    conf_threshold: Any = exe_cfg.conf_threshold
    if conf_thresholds:
        conf_threshold = dict(conf_thresholds)
        run_out = chain_run("chains, pre-fitted thresholds", thr_map=conf_threshold)
    else:
        run_out = chain_run("chains")
        if calibrate_conf_per_function:
            conf_threshold, _f1 = calibrate_chain_conf_thresholds_per_function(
                run_out, annotated, function_vocab, value_vocab, iou_threshold=iou_threshold)
            logger.info("per-function conf thresholds: %s",
                        {k: round(v, 2) for k, v in sorted(conf_threshold.items())})
            run_out = chain_run("chains, per-function thresholds", thr_map=conf_threshold)
        elif calibrate_conf:
            conf_threshold, f1 = calibrate_chain_conf_threshold(
                run_out, annotated, function_vocab, value_vocab, iou_threshold=iou_threshold)
            logger.info("calibrated conf threshold: %.2f (box F1 %.3f)", conf_threshold, f1)
            if abs(conf_threshold - exe_cfg.conf_threshold) > 1e-9:
                # the threshold gates box propagation through the chain
                run_out = chain_run("chains, calibrated threshold", cfg=dataclasses.replace(
                    exe_cfg, conf_threshold=conf_threshold))
    out.step_tally = tally_predicted_chains(run_out, annotated, function_vocab, value_vocab,
                                            conf_threshold=conf_threshold,
                                            iou_threshold=iou_threshold)
    out.conf_threshold = conf_threshold
    out.payload = {
        "per_function_box_pr": out.step_tally.precision_recall(),
        "per_function_token_acc": out.step_tally.token_accuracy(),
        "conf_threshold": conf_threshold,
        "iou_threshold": iou_threshold,
        # truncation accounting (generated / GT chains)
        "truncated_generated_programs": result.truncated,
        "truncated_gt_programs": chains.truncated,
    }
    return out


def cmd_tally(args: argparse.Namespace) -> None:
    import h5py

    from explainable_spatial_vqa_tpu_torch.core.artifacts import read_questions_h5
    from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, get_preset
    from explainable_spatial_vqa_tpu_torch.core.vocab import canonicalize, invert_vocab, load_vocab
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.train.pipelines import model_dtype

    device = _device(args)
    enc = read_questions_h5(args.questions_h5)
    limit = args.limit or len(enc.questions)
    questions = enc.questions[:limit]
    answers = enc.answers[:limit] if enc.answers is not None else None
    programs = enc.programs[:limit] if enc.programs is not None else None
    image_idxs = enc.image_idxs[:limit]

    clevr_vocab = load_vocab(args.vocab_json)
    split_vocab = load_vocab(args.split_vocab_json)
    program_inv = invert_vocab(clevr_vocab["program_token_to_idx"])
    answer_inv = invert_vocab(clevr_vocab["answer_token_to_idx"])
    value_vocab = split_vocab["other"]

    # max(preset, data) sizing, as the training pipelines size their models,
    # so checkpoints written by `train` restore with matching shapes
    gen_config = get_preset("generator")
    exe_config = get_preset(args.executor_preset)
    if not isinstance(exe_config.model, ExecutorConfig):
        raise SystemExit(f"--executor_preset {args.executor_preset!r} is not an "
                         "executor-family preset")
    gen_cfg = dataclasses.replace(
        gen_config.model,
        vocab_size=max(gen_config.model.vocab_size, int(questions.max()) + 1),
        program_vocab_size=max(gen_config.model.program_vocab_size,
                               (int(programs.max()) + 1) if programs is not None else 0),
        program_len=programs.shape[1] if programs is not None else 27,
    )
    exe_cfg = dataclasses.replace(
        exe_config.model,
        vocab_size=max(exe_config.model.vocab_size, len(split_vocab["function"]) + 1),
        token_classes=max(exe_config.model.token_classes, len(value_vocab) + 1),
    )
    generator = init_parameters(
        ProgramGenerator(gen_cfg, model_dtype(gen_config, device), device), 0)
    executor = init_parameters(
        ProgramExecutor(exe_cfg, model_dtype(exe_config, device), device), 2)
    _restore(generator, args.generator_checkpoint, "generator")
    _restore(executor, args.executor_checkpoint, "executor")

    with h5py.File(args.features_h5, "r") as f:
        feats = f["features"][()]
    n, c, h, w = feats.shape
    image_tokens = torch.from_numpy(
        np.ascontiguousarray(feats.reshape(n, c, h * w).transpose(0, 2, 1), np.float32)
    ).to(device)

    # GT answers in the executor's value-token space
    gt_value_ids = None
    if answers is not None:
        gt_value_ids = np.asarray([value_vocab.get(canonicalize(answer_inv.get(int(a), "")), -2)
                                   for a in answers])
    annotated = None
    if args.annotated_h5:
        from explainable_spatial_vqa_tpu_torch.core.artifacts import read_annotated_h5

        annotated = read_annotated_h5(args.annotated_h5)[:limit]
    conf_thresholds = None
    if args.annotated_h5 and args.conf_thresholds:
        # PRE-FITTED thresholds (e.g. calibrated on a held-in split with
        # --save_conf_thresholds): the out-of-sample counterpart of the
        # in-place --calibrate_conf* modes
        with open(args.conf_thresholds) as f:
            conf_thresholds = {k: float(v) for k, v in json.load(f).items()}
        logger.info("loaded conf thresholds from %s: %s", args.conf_thresholds,
                    {k: round(v, 2) for k, v in sorted(conf_thresholds.items())})

    out = run_tally(generator, executor, exe_cfg, questions, image_tokens, image_idxs,
                    program_inv, split_vocab["function"], value_vocab, gt_answers=gt_value_ids,
                    programs=programs, annotated=annotated, chain_mode=args.chain_mode,
                    iou_threshold=args.iou_threshold, calibrate_conf=args.calibrate_conf,
                    calibrate_conf_per_function=args.calibrate_conf_per_function,
                    conf_thresholds=conf_thresholds, device=device, mesh=_serve_mesh(args))
    print(f"truncated_programs: {out.pipeline.truncated} (generated programs deeper than "
          f"max_steps={MAX_STEPS}; their execution was cut and their answers read a "
          f"mid-chain value)")
    if out.pipeline.tally is not None:
        print(out.pipeline.tally.report())
        print(json.dumps(out.accuracy, indent=2))
    if out.step_tally is None:
        return
    if args.save_conf_thresholds and _writes_files():
        # the fitted operating points, for a later tally on another split
        # (or a serving deployment) through --conf_thresholds
        thr = out.conf_threshold
        out_map = thr if isinstance(thr, dict) else {"__global__": float(thr)}
        with open(args.save_conf_thresholds, "w") as f:
            json.dump(out_map, f, indent=2, sort_keys=True)
        logger.info("saved conf thresholds to %s", args.save_conf_thresholds)
    print(out.step_tally.report())
    print(json.dumps(out.payload, indent=2))


def cmd_cogent_protocol(args: argparse.Namespace) -> None:
    from explainable_spatial_vqa_tpu_torch.evalsuite.cogent import run_cogent_protocol

    result = run_cogent_protocol(
        num_scenes_a=args.scenes_a,
        num_scenes_val=args.scenes_val,
        num_scenes_b_pool=args.scenes_b_pool,
        questions_per_scene=args.questions_per_scene,
        gen_steps=args.gen_steps,
        exe_steps=args.exe_steps,
        ft_steps=args.ft_steps,
        finetune_images=args.finetune_images,
        finetune_questions=args.finetune_questions,
        noise=args.noise,
        drop=args.drop,
        seed=args.seed,
        entangled=not args.disentangled_features,
        d_model=args.d_model,
        encoder_layers=args.encoder_layers,
        box_roi=args.box_roi,
        roi_sim=args.roi_sim,
        count_embed=args.count_embed,
        lr_schedule=args.lr_schedule,
        hop_prob=args.hop_prob,
        chain_prob=args.chain_prob,
        max_chain_steps=args.max_chain_steps,
        device=_device(args),
    )
    report = result["report"]
    print(report.report())
    print()
    print(f"{'cell':<24}{'overall':>9}{'count':>9}{'exist':>9}"
          f"{'cmp_num':>9}{'cmp_attr':>9}{'query':>9}")
    for cell, acc in result["by_type"].items():
        print(f"{cell:<24}"
              f"{acc['overall']:>9.3f}{acc.get('count', float('nan')):>9.3f}"
              f"{acc.get('exist', float('nan')):>9.3f}"
              f"{acc.get('compare_number', float('nan')):>9.3f}"
              f"{acc.get('compare_attribute', float('nan')):>9.3f}"
              f"{acc.get('query_attribute', float('nan')):>9.3f}")
    if args.output_json:
        payload = {
            "four_cell": report.as_dict(),
            "by_type": result["by_type"],
            "sizes": result["sizes"],
        }
        with open(args.output_json, "w") as f:
            json.dump(payload, f, indent=2)
        logger.info("wrote %s", args.output_json)


# ---------------------------------------------------------------------------
# eval-iqap
# ---------------------------------------------------------------------------


def run_eval_iqap(model, questions: np.ndarray, image_tokens, image_index: np.ndarray,
                  answers: Optional[np.ndarray] = None, programs: Optional[np.ndarray] = None,
                  device="cuda") -> Tuple[Dict[str, Any], np.ndarray, Optional[np.ndarray]]:
    """``model`` (a ``TransformerIQAP``) on the selected questions in one
    forward: the answers and, with ``programs``, the greedy programs of
    their length.  ``image_tokens``: the per-IMAGE (M, P, C) features, numpy
    (gathered on the host) or a tensor (gathered on its device);
    ``image_index`` maps questions to images.  Returns (the JAX CLI's
    summary: samples, seconds, answer_accuracy and program accuracy where
    the ground truth is given; the predicted answers; the predicted
    programs or None)."""
    from explainable_spatial_vqa_tpu_torch.device import resolve_device
    from explainable_spatial_vqa_tpu_torch.evalsuite.accuracy import program_accuracy
    from explainable_spatial_vqa_tpu_torch.models.iqap import generate_programs
    from explainable_spatial_vqa_tpu_torch.models.layers import eval_mode

    device = resolve_device(device)
    t0 = time.perf_counter()
    with torch.no_grad(), eval_mode(model):
        if isinstance(image_tokens, torch.Tensor):
            images = image_tokens.index_select(
                0, torch.as_tensor(image_index, device=image_tokens.device))
        else:
            images = np.asarray(image_tokens)[image_index]
        out = model(_on(images, device, torch.float32), _on(questions, device))
        pred_answers = torch.argmax(out["answer_logits"], dim=-1).cpu().numpy()
        pred_programs = None
        if programs is not None:
            tokens, _ = generate_programs(model, out["memory"], max_len=programs.shape[1])
            pred_programs = tokens.cpu().numpy()
    elapsed = time.perf_counter() - t0
    summary: Dict[str, Any] = {"samples": len(questions), "seconds": round(elapsed, 3)}
    if answers is not None:
        summary["answer_accuracy"] = float(np.mean(pred_answers == answers))
    if pred_programs is not None:
        summary.update(program_accuracy(pred_programs, programs))
    return summary, pred_answers, pred_programs


def cmd_eval_iqap(args: argparse.Namespace) -> None:
    import h5py

    from explainable_spatial_vqa_tpu_torch.core.artifacts import read_questions_h5
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.core.vocab import invert_vocab, load_vocab
    from explainable_spatial_vqa_tpu_torch.models.iqap import TransformerIQAP
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.train.pipelines import model_dtype

    device = _device(args)
    enc = read_questions_h5(args.questions_h5)
    limit = args.limit or len(enc.questions)
    questions = enc.questions[:limit]
    answers = enc.answers[:limit] if enc.answers is not None else None
    programs = enc.programs[:limit] if enc.programs is not None else None
    image_idxs = enc.image_idxs[:limit]

    vocab = load_vocab(args.vocab_json)
    q_inv = invert_vocab(vocab["question_token_to_idx"])
    p_inv = invert_vocab(vocab["program_token_to_idx"])
    a_inv = invert_vocab(vocab["answer_token_to_idx"])

    config = get_preset(args.preset)
    with h5py.File(args.features_h5, "r") as f:
        features = f["features"][()]
    n, c, h, w = features.shape
    image_tokens = features.reshape(n, c, h * w).transpose(0, 2, 1).astype(np.float32)
    # sized to the data, as the JAX CLI sizes it
    model_cfg = dataclasses.replace(
        config.model,
        vocab_size=int(questions.max()) + 1,
        num_answer_classes=(int(answers.max()) + 1) if answers is not None else 32,
        program_vocab_size=(int(programs.max()) + 1) if programs is not None else 45,
        program_len=programs.shape[1] if programs is not None else 27,
        max_question_len=questions.shape[1],
        image_feature_dim=int(c),
        num_image_tokens=int(h * w),
    )
    model = init_parameters(TransformerIQAP(model_cfg, model_dtype(config, device), device), 0)
    _restore(model, args.checkpoint_dir, "IQAP")

    summary, pred_answers, pred_programs = run_eval_iqap(
        model, questions, image_tokens, image_idxs, answers, programs, device)
    results = []
    for i in range(len(questions)):
        record = {
            "image_index": int(image_idxs[i]),
            "question": " ".join(q_inv.get(int(t), "?") for t in questions[i] if t),
            "predicted_answer": a_inv.get(int(pred_answers[i]), "?"),
        }
        if answers is not None:
            record["gt_answer"] = a_inv.get(int(answers[i]), "?")
        if pred_programs is not None:
            record["predicted_program"] = " ".join(
                p_inv.get(int(t), "?") for t in pred_programs[i] if t)
        results.append(record)
    print(json.dumps(summary, indent=2))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump({"summary": summary, "results": results}, f, indent=2)
        logger.info("wrote %s", args.output_json)


# ---------------------------------------------------------------------------
# infer-chain
# ---------------------------------------------------------------------------


def run_infer_chain(model, chain_tokens, chains, annotated: List[Dict[str, Any]],
                    rev_vocab: Optional[Mapping[int, str]] = None, max_steps: int = MAX_STEPS,
                    device="cuda", mesh=None) -> Tuple[Dict[str, np.ndarray], List[Dict[str, Any]]]:
    """The step seq2seq ``model`` chained over ``chains`` (``chain_arrays``
    of ``annotated``, joint-vocab records): ``chain_tokens`` (N, P, C), one
    row of image features per chain, numpy or a tensor.  Returns (the
    runner's step and final outputs, one record per question: its image,
    the final step's token ids, their text in ``rev_vocab`` (joint-vocab
    ids, shifted by the specials) and the ground-truth answer).  With a
    ``mesh`` the runner serves data parallel over it (``--data_parallel``)."""
    from explainable_spatial_vqa_tpu_torch.device import resolve_device
    from explainable_spatial_vqa_tpu_torch.infer.chain import Seq2SeqChainRunner
    from explainable_spatial_vqa_tpu_torch.train.datasets import SPECIALS_OFFSET

    device = resolve_device(device)
    runner = Seq2SeqChainRunner(model, model.config, max_steps=max_steps, device=device,
                                mesh=mesh)
    out = runner.run(chain_tokens, chains)
    rev_vocab = rev_vocab or {}
    results = []
    for i, q in enumerate(annotated):
        final = [int(t) for t in out["final_outputs"][i] if t != 0]
        decoded = " ".join(rev_vocab.get(t - SPECIALS_OFFSET, "<unk>") for t in final)
        results.append({
            "image_index": int(chains.image_index[i]),
            "predicted_ids": final,
            "predicted_text": decoded,
            "answer": q.get("answer", ""),
        })
        if i < 10:
            logger.info("q%d: predicted %r (gt answer ids %r)", i, decoded, q.get("answer"))
    return out, results


def identity_function_vocab(annotated: List[Dict[str, Any]]) -> Dict[str, int]:
    """Joint-vocab records' function ids as the chains' function tokens: id
    + SPECIALS_OFFSET (the step seq2seq's src token ids), 0 for a function
    that is not an id."""
    from explainable_spatial_vqa_tpu_torch.train.datasets import SPECIALS_OFFSET

    vocab: Dict[str, int] = {}
    for q in annotated:
        for step in q["annotated_program"]:
            fn = step["function"]
            vocab.setdefault(fn, int(fn) + SPECIALS_OFFSET if fn.isdigit() else 0)
    return vocab


def cmd_infer_chain(args: argparse.Namespace) -> None:
    import h5py

    from explainable_spatial_vqa_tpu_torch.core.artifacts import read_annotated_h5
    from explainable_spatial_vqa_tpu_torch.core.config import get_preset
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.models.step_executor import StepExecutorSeq2Seq
    from explainable_spatial_vqa_tpu_torch.train.datasets import chain_arrays
    from explainable_spatial_vqa_tpu_torch.train.pipelines import model_dtype

    device = _device(args)
    config = get_preset("step_seq2seq")
    rev_vocab = {}
    if args.vocab_json:
        with open(args.vocab_json) as f:
            rev_vocab = {v: k for k, v in json.load(f).items()}
    annotated = read_annotated_h5(args.annotated_h5)
    if args.limit:
        annotated = annotated[:args.limit]
    chains = chain_arrays(annotated, identity_function_vocab(annotated), max_steps=args.max_steps)

    with h5py.File(args.features_h5, "r") as f:
        feats = np.stack([f["features"][int(i)] for i in chains.image_index])
    n, c, h, w = feats.shape
    chain_tokens = feats.reshape(n, c, h * w).transpose(0, 2, 1).astype(np.float32)
    model_cfg = dataclasses.replace(config.model, vocab_size=args.vocab_size,
                                    image_feature_dim=int(c), num_image_tokens=int(h * w))
    model = init_parameters(StepExecutorSeq2Seq(model_cfg, model_dtype(config, device), device),
                            0)
    _restore(model, args.checkpoint_dir, "step seq2seq")

    print(f"truncated_programs: {chains.truncated} "
          f"(GT chains deeper than --max_steps={args.max_steps})")
    _, results = run_infer_chain(model, chain_tokens, chains, annotated, rev_vocab,
                                 args.max_steps, device, mesh=_serve_mesh(args))
    if args.output_json and _writes_files():
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2)
        logger.info("wrote %s", args.output_json)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


def _preset_names():
    from explainable_spatial_vqa_tpu_torch.core.config import PRESETS

    return PRESETS.keys()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="explainable_spatial_vqa_tpu_torch")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the models (default cuda; raises without a "
                             "card unless cpu); stands for the JAX CLI's --platform")
    parser.add_argument(
        "--multihost", action="store_true",
        help="join the torch.distributed process group before running the command "
             "(parallel/multihost.py): one process per card, every process running the "
             "same command line; under torchrun the rendezvous comes from the environment")
    parser.add_argument("--coordinator_address", default=None,
                        help="host:port of process 0 (from the environment if unset)")
    parser.add_argument("--num_processes", type=int, default=None)
    parser.add_argument("--process_id", type=int, default=None)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("build-vocab")
    p.add_argument("--inputs", nargs="+", required=True,
                   help="question JSONs, reference order: val test train")
    p.add_argument("--output", default="vocab.json")
    p.set_defaults(fn=cmd_build_vocab)

    p = sub.add_parser("preprocess-questions")
    p.add_argument("--input_questions_json", required=True)
    p.add_argument("--input_vocab_json", required=True)
    p.add_argument("--output_h5_file", required=True)
    p.add_argument("--mode", default="postfix", choices=["chain", "prefix", "postfix"])
    p.add_argument("--encode_unk", default=0, type=int)
    p.set_defaults(fn=cmd_preprocess_questions)

    p = sub.add_parser("extract-features")
    p.add_argument("--input_image_dir", required=True)
    p.add_argument("--output_h5_file", required=True)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--image_height", type=int, default=224)
    p.add_argument("--image_width", type=int, default=224)
    p.add_argument("--model_stage", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--torch-weights", default=None,
                   help="path to torchvision resnet101 .pth for numeric parity")
    p.add_argument("--resize", choices=["device", "pil"], default="device",
                   help="device = the antialiased cubic resize on the device; "
                        "pil = host PIL BICUBIC + uint8 requantization "
                        "(bit-matches the reference preprocessing)")
    p.set_defaults(fn=cmd_extract_features)

    p = sub.add_parser("export-scenes")
    p.add_argument("--input_scenes_json", required=True)
    p.add_argument("--output_h5_file", required=True)
    p.add_argument("--decimals", type=int, default=None)
    p.add_argument("--layout", default="boxes", choices=["boxes", "attributes"])
    p.add_argument("--vocab_output", default=None)
    p.set_defaults(fn=cmd_export_scenes)

    p = sub.add_parser("annotate")
    p.add_argument("--scenes", required=True)
    p.add_argument("--questions", required=True)
    p.add_argument("--output_h5", required=True)
    p.add_argument("--vocab_output", required=True)
    p.add_argument("--raw_json", default=None)
    p.add_argument("--mode", default="v3", choices=["v3", "full", "string"])
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--limit", type=int, default=0)
    p.set_defaults(fn=cmd_annotate)

    p = sub.add_parser("train")
    p.add_argument("--preset", required=True,
                   help="one of: " + ", ".join(sorted(_preset_names())))
    p.add_argument("--features_h5")
    p.add_argument("--questions_h5")
    p.add_argument("--annotated_h5")
    p.add_argument("--vocab_json")
    p.add_argument("--split_vocab_json")
    p.add_argument("--image_dir", help="raw PNGs (yolo_bb preset)")
    p.add_argument("--subset_fraction", type=float, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--history_json", default=None)
    p.add_argument("--eval_test", action="store_true")
    p.add_argument("--plot", default=None)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("presets", help="list training presets")
    p.set_defaults(fn=lambda a: print("\n".join(sorted(_preset_names()))))

    p = sub.add_parser("eval-iqap")
    p.add_argument("--questions_h5", required=True)
    p.add_argument("--features_h5", required=True)
    p.add_argument("--vocab_json", required=True)
    p.add_argument("--preset", default="transformer_iqap")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--output_json", default=None)
    p.set_defaults(fn=cmd_eval_iqap)

    p = sub.add_parser("eval-generator")
    p.add_argument("--questions_h5", required=True)
    p.add_argument("--preset", default="generator")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--vocab_json", default=None)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--show", type=int, default=0)
    p.add_argument("--beam_size", type=int, default=0,
                   help=">1: also report best-beam program accuracy")
    p.add_argument("--compare_tf", action="store_true",
                   help="also report teacher-forced accuracy "
                        "(run_model_lstm_qp.py:277-321 comparison)")
    p.set_defaults(fn=cmd_eval_generator)

    p = sub.add_parser("tally")
    p.add_argument("--questions_h5", required=True)
    p.add_argument("--features_h5", required=True)
    p.add_argument("--vocab_json", required=True)
    p.add_argument("--split_vocab_json", required=True)
    p.add_argument("--generator_checkpoint", default=None)
    p.add_argument("--executor_checkpoint", default=None)
    p.add_argument("--executor_preset", default="executor",
                   help="executor-family preset whose model config to build "
                        "(e.g. executor_roi / executor_roi_sim so checkpoints "
                        "trained with those presets restore with matching "
                        "parameters)")
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--annotated_h5", default=None,
                   help="also compute per-function box P/R + token accuracy "
                        "on the executor's predicted chains (Tables 4.3/4.4)")
    p.add_argument("--iou_threshold", type=float, default=0.5)
    p.add_argument("--calibrate_conf", action="store_true",
                   help="F1-max confidence-threshold calibration before the "
                        "per-step tally")
    p.add_argument("--calibrate_conf_per_function", action="store_true",
                   help="per-FUNCTION F1 operating points instead of one "
                        "global threshold (same_* confidences sit far below "
                        "the filters'); gates both the tally and in-chain "
                        "box propagation")
    p.add_argument("--conf_thresholds", default=None,
                   help="JSON file of pre-fitted conf thresholds "
                        "({function: thr, '__global__': fallback}) to apply "
                        "instead of calibrating in place; use with "
                        "--save_conf_thresholds on a held-in split for "
                        "out-of-sample operating points")
    p.add_argument("--save_conf_thresholds", default=None,
                   help="write the thresholds used for the per-step tally "
                        "to this JSON file for reuse via --conf_thresholds")
    p.add_argument("--chain_mode", default="sorted",
                   choices=("sorted", "pool", "bucketed", "plain"),
                   help="chained-execution schedule of the generated programs: "
                        "depth-sorted batches (default), the continuous-batching "
                        "slot pool, per-depth buckets, or one full-depth batch; the "
                        "per-step tally runs the pool in pool mode, else sorted")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard chained serving over the processes of --multihost")
    p.set_defaults(fn=cmd_tally)

    p = sub.add_parser("infer-chain")
    p.add_argument("--annotated_h5", required=True)
    p.add_argument("--features_h5", required=True)
    p.add_argument("--vocab_json", default=None)
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--vocab_size", type=int, required=True)
    p.add_argument("--max_steps", type=int, default=MAX_STEPS)
    p.add_argument("--limit", type=int, default=10)
    p.add_argument("--output_json", default=None)
    p.add_argument("--data_parallel", action="store_true",
                   help="shard chained serving over the processes of --multihost")
    p.set_defaults(fn=cmd_infer_chain)

    p = sub.add_parser("stats")
    p.add_argument("--annotated_h5", required=True)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("visualize")
    p.add_argument("--input_scenes_json", required=True)
    p.add_argument("--image_index", type=int, default=0)
    p.add_argument("--image", default=None, help="source PNG (black canvas if absent)")
    p.add_argument("--labels", action="store_true")
    p.add_argument("--output", required=True)
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("inspect")
    p.add_argument("file")
    p.add_argument("-n", type=int, default=2)
    p.set_defaults(fn=cmd_inspect)

    from explainable_spatial_vqa_tpu_torch.cli.repro import add_repro_parser

    add_repro_parser(sub)

    p = sub.add_parser(
        "cogent-protocol",
        help="four-cell CoGenT A->B protocol on synthetic data "
             "(train A -> eval A/B -> fine-tune on B subset -> re-eval)")
    p.add_argument("--scenes_a", type=int, default=80)
    p.add_argument("--scenes_val", type=int, default=20)
    p.add_argument("--scenes_b_pool", type=int, default=40)
    p.add_argument("--questions_per_scene", type=int, default=6)
    p.add_argument("--gen_steps", type=int, default=400)
    p.add_argument("--exe_steps", type=int, default=500)
    p.add_argument("--ft_steps", type=int, default=150)
    p.add_argument("--finetune_images", type=int, default=3000,
                   help="thesis: 3000 (scaled down automatically by pool size)")
    p.add_argument("--finetune_questions", type=int, default=30000,
                   help="thesis: 30000")
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--drop", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--d_model", type=int, default=0,
                   help="executor width (0 = protocol default 96); the "
                        "flagship accuracy recipe uses 192")
    p.add_argument("--encoder_layers", type=int, default=2)
    p.add_argument("--box_roi", action="store_true",
                   help="ROI content injection under input boxes "
                        "(docs/DESIGN.md §11)")
    p.add_argument("--roi_sim", action="store_true",
                   help="content-similarity channel on top of box_roi "
                        "(docs/DESIGN.md §12)")
    p.add_argument("--count_embed", action="store_true",
                   help="input-box-count embedding on CLS "
                        "(docs/DESIGN.md §13)")
    p.add_argument("--lr_schedule", default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--hop_prob", type=float, default=0.0,
                   help="scene-aware relational hop rate in the corpora")
    p.add_argument("--chain_prob", type=float, default=0.0,
                   help="second-hop chaining rate given a hop")
    p.add_argument("--max_chain_steps", type=int, default=12)
    p.add_argument("--output_json", default=None)
    p.add_argument("--disentangled_features", action="store_true",
                   help="use plain one-hot color channels (no per-shape "
                        "permutation) — color readout is then shape-free and "
                        "NO A->B gap can appear; default is the entangled "
                        "mode that exhibits the Table 4.6 phenomenon")
    p.set_defaults(fn=cmd_cogent_protocol)
    return parser


def main(argv=None) -> None:
    from explainable_spatial_vqa_tpu_torch.utils.logging import setup_logging

    setup_logging()
    args = build_parser().parse_args(argv)
    if args.multihost:
        from explainable_spatial_vqa_tpu_torch.parallel.multihost import initialize

        initialize(args.coordinator_address, args.num_processes, args.process_id)
    try:
        args.fn(args)
    except BrokenPipeError:
        # output piped into head/less that exited early: not an error
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), 1)


if __name__ == "__main__":
    main()
