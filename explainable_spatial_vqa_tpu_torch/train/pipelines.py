"""Training pipelines: artifacts -> (model, loss_fn, batches), ported from
``explainable_spatial_vqa_tpu/train/pipelines.py``, every family of it: the
thesis pair, ``generator`` and ``executor`` (presets ``generator``,
``executor``, ``executor_roi``, ``executor_roi_count``, ``executor_roi_sim``
and ``executor_roi_sim_count``), the executor's chain-level scheduled
sampling, ``executor_scheduled``, the baselines: ``iqap`` (presets
``transformer_iqap`` and ``transformer_iqap_bb``), ``lstm_iqap``
(``lstm_iqap``, ``lstm_iqa``) and ``step_seq2seq``; ``lstm_qp`` is a
``generator`` preset; the chain-of-thought IQAP, ``iqap_cot``
(``transformer_iqap_cot``), and the prototype step models,
``prototype_step`` (``token_only``, ``bb_only``, ``bb_only_iou``,
``yolo_bb``, ``multitask_bb``, ``bbinout``, ``multihead``,
``hierarchical``).

Each family is two functions: ``_<family>_pipeline(config, device)`` reads
the h5 artifacts named by ``config.data`` and hands the arrays to
``<family>_pipeline_from_arrays``, which a caller holding its data in memory
(``bench_data``'s synthetic sets) calls directly.  Splits are sklearn's
(``train.data``), so both packages train and validate on the same rows.
"""

from __future__ import annotations

import dataclasses
import json
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from explainable_spatial_vqa_tpu_torch.core.config import ExperimentConfig
from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
from explainable_spatial_vqa_tpu_torch.parallel.mesh import global_normaliser
from explainable_spatial_vqa_tpu_torch.parallel.multihost import process_count, process_index
from explainable_spatial_vqa_tpu_torch.train.data import Subset, batches, train_val_test_split
from explainable_spatial_vqa_tpu_torch.models.iqap import TransformerIQAP, generate_programs
from explainable_spatial_vqa_tpu_torch.models.lstm_iqap import LstmIQAP
from explainable_spatial_vqa_tpu_torch.models.step_executor import StepExecutorSeq2Seq
from explainable_spatial_vqa_tpu_torch.train.losses import (
    cross_entropy,
    executor_set_loss,
    masked_box_regression_loss,
    perturb_input_boxes,
)
from explainable_spatial_vqa_tpu_torch.train.metrics import (
    answer_metrics,
    masked_token_metrics,
    mean_iou,
    program_metrics,
)
from explainable_spatial_vqa_tpu_torch.train.scheduled import make_scheduled_loss_fn, schedule_p

__all__ = ["Pipeline", "build_pipeline", "model_dtype", "generator_pipeline_from_arrays",
           "executor_pipeline_from_arrays", "executor_scheduled_pipeline_from_arrays",
           "iqap_pipeline_from_arrays", "lstm_iqap_pipeline_from_arrays",
           "step_seq2seq_pipeline_from_arrays", "iqap_cot_pipeline_from_arrays",
           "prototype_step_pipeline_from_arrays"]

# a (N, P, C) numpy array or tensor, or core.artifacts.H5Features ((N, C, H,
# W) grids for the LSTM baselines)
Features = Any


@dataclass
class Pipeline:
    model: nn.Module
    loss_fn: Callable
    train_batches: Callable[[int], Iterable[Dict[str, Any]]]
    val_batches: Callable[[], Iterable[Dict[str, Any]]]
    test_batches: Callable[[], Iterable[Dict[str, Any]]]
    monitor: Tuple[str, str]
    steps_per_epoch: int


def model_dtype(config: ExperimentConfig, device: torch.device) -> torch.dtype:
    """``TrainConfig.dtype`` as a torch dtype: "auto" is bfloat16 on the card
    (as the JAX package picks bf16 on its accelerator) and float32 on the
    CPU; parameters, softmax and LayerNorm stay float32 in the models."""
    name = config.train.dtype
    if name == "auto":
        name = "bfloat16" if device.type == "cuda" else "float32"
    return getattr(torch, name)


class _FeatureGather:
    """Batch transform attaching image features by ``image_index`` from
    ``features``: an array or tensor (a tensor on the card is gathered
    there), ``core.artifacts.H5Features`` or :class:`_ImageGather`.  With
    ``as_tokens`` a gathered (B, C, H, W) grid becomes (B, H*W, C) tokens."""

    def __init__(self, features: Features, as_tokens: bool = False):
        self.features = features
        self.as_tokens = as_tokens

    def __call__(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        idx = batch["image_index"]
        if isinstance(self.features, torch.Tensor):
            idx = torch.as_tensor(idx, dtype=torch.long).to(self.features.device)
        image = self.features[idx]
        if self.as_tokens and image.ndim == 4:
            n, c, h, w = image.shape
            image = image.reshape(n, c, h * w).swapaxes(1, 2)
            if isinstance(image, torch.Tensor):
                image = image.contiguous()
        return {**batch, "image": image}


def _batch_factories(arrays: Dict[str, np.ndarray], config: ExperimentConfig, transform=None,
                     train_transform: Optional[Callable[[int], Callable]] = None):
    """(train, validation and test batch factories, steps per epoch) over
    sklearn's splits; ``train_transform(epoch)``, when given, is that
    epoch's transform of the training batches in place of ``transform``.
    Under a process group each process reads only its own rows of every
    global batch (``batches``' ``process_index``/``process_count``), as the
    JAX factories do across hosts."""
    n = len(next(iter(arrays.values())))
    d = config.data
    train_idx, val_idx, test_idx = train_val_test_split(n, d.test_split, d.validation_split, d.seed)
    bs = config.train.batch_size
    train_sub, val_sub, test_sub = (Subset(arrays, i) for i in (train_idx, val_idx, test_idx))
    hosts = dict(process_index=process_index(), process_count=process_count())

    def train_b(epoch):
        return batches(train_sub, bs, shuffle=True, seed=d.seed, epoch=epoch,
                       transform=transform if train_transform is None else train_transform(epoch),
                       **hosts)

    def val_b():
        return batches(val_sub, bs, shuffle=False, transform=transform, **hosts)

    def test_b():
        return batches(test_sub, bs, shuffle=False, transform=transform, **hosts)

    return train_b, val_b, test_b, len(train_sub) // bs


# ---------------------------------------------------------------------------
# generator
# ---------------------------------------------------------------------------


def generator_pipeline_from_arrays(config: ExperimentConfig, questions: np.ndarray,
                                   programs: np.ndarray, image_index: np.ndarray,
                                   device: Union[str, torch.device] = "cuda") -> Pipeline:
    """The generator's pipeline on questions (N, Lq) and programs (N, Lp), in
    the questions h5's layout.  The vocabulary sizes grow to the data's
    maxima (max(preset, data)) and the program length is the data's."""
    device = resolve_device(device)
    cfg = dataclasses.replace(
        config.model,
        vocab_size=max(config.model.vocab_size, int(questions.max()) + 1),
        program_vocab_size=max(config.model.program_vocab_size, int(programs.max()) + 1),
        program_len=programs.shape[1],
    )
    config = config.replace(model=cfg)
    model = init_parameters(ProgramGenerator(cfg, model_dtype(config, device), device),
                            config.train.seed)

    def loss_fn(model, batch, generator, train):
        out = model(batch["questions"], batch["programs"], generator=generator)
        loss = cross_entropy(out["logits"], batch["programs"])
        return loss, program_metrics(torch.argmax(out["logits"], -1), batch["programs"])

    arrays = {"questions": questions, "programs": programs, "image_index": image_index}
    train_b, val_b, test_b, spe = _batch_factories(arrays, config)
    return Pipeline(model, loss_fn, train_b, val_b, test_b, ("program_em", "program_em_total"),
                    spe)


def _generator_pipeline(config: ExperimentConfig, device) -> Pipeline:
    from explainable_spatial_vqa_tpu_torch.core.artifacts import read_questions_h5

    enc = read_questions_h5(config.data.questions_h5)
    if enc.programs is None:
        raise ValueError(f"{config.data.questions_h5} holds no programs to train on")
    return generator_pipeline_from_arrays(config, enc.questions, enc.programs, enc.image_idxs,
                                          device)


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


def _init_executor(model: ProgramExecutor, seed: int) -> ProgramExecutor:
    init_parameters(model, seed)
    with torch.no_grad():  # zero at init, as in the JAX model: exact no-ops
        for name in ("sim_embed", "count_embed"):
            if hasattr(model, name):
                getattr(model, name).weight.zero_()
    return model


def executor_pipeline_from_arrays(config: ExperimentConfig, arrays: Dict[str, np.ndarray],
                                  features: Features,
                                  device: Union[str, torch.device] = "cuda") -> Pipeline:
    """The executor's pipeline on step records in ``executor_step_arrays``'
    layout and image features (N_images, P, C) indexed by their
    ``image_index``.  ``config.model`` is used as it is."""
    device = resolve_device(device)
    cfg = config.model
    model = _init_executor(ProgramExecutor(cfg, model_dtype(config, device), device),
                           config.train.seed)
    perturb = cfg.input_box_noise > 0.0 or cfg.input_box_drop > 0.0

    def loss_fn(model, batch, generator, train):
        boxes, mask = batch["input_boxes"], batch["input_box_mask"]
        if train and perturb:
            boxes, mask = perturb_input_boxes(boxes, mask, generator, cfg.input_box_noise,
                                              cfg.input_box_drop)
        out = model(batch["image"], boxes, mask, batch["text"], batch["text_mask"])
        losses = executor_set_loss(out, batch["target_boxes"], batch["target_box_mask"],
                                   batch["token_target"], batch["is_box_branch"], cfg)
        is_box = batch["is_box_branch"]
        routing_pred = torch.argmax(out["routing_logits"], -1)
        token_pred = torch.argmax(out["token_logits"], -1)
        metrics = {
            "routing_correct": (routing_pred == 1 - is_box.long()).sum(),
            "routing_total": routing_pred.shape[0],
            "token_correct": ((token_pred == batch["token_target"]) & ~is_box).sum(),
            "token_total": (~is_box).sum(),
        }
        return losses["loss"], metrics

    train_b, val_b, test_b, spe = _batch_factories(arrays, config, _FeatureGather(features))
    return Pipeline(model, loss_fn, train_b, val_b, test_b, ("routing_correct", "routing_total"),
                    spe)


def _read_executor_data(config: ExperimentConfig):
    """(annotated questions, split vocabulary, model config sized to it:
    max(preset, data) for the function and value vocabularies)."""
    from explainable_spatial_vqa_tpu_torch.core.artifacts import read_annotated_h5
    from explainable_spatial_vqa_tpu_torch.core.vocab import load_vocab

    annotated = read_annotated_h5(config.data.annotated_h5)
    vocabs = load_vocab(config.data.split_vocab_json)
    cfg = dataclasses.replace(
        config.model,
        vocab_size=max(config.model.vocab_size, len(vocabs["function"]) + 1),
        token_classes=max(config.model.token_classes, len(vocabs["other"]) + 1),
    )
    return annotated, vocabs, cfg


def _executor_pipeline(config: ExperimentConfig, device) -> Pipeline:
    """The thesis executor on annotated questions and the split vocabulary."""
    from explainable_spatial_vqa_tpu_torch.core.artifacts import H5Features
    from explainable_spatial_vqa_tpu_torch.train.datasets import executor_step_arrays

    annotated, vocabs, cfg = _read_executor_data(config)
    arrays = executor_step_arrays(annotated, vocabs["function"], vocabs["other"],
                                  max_input_boxes=cfg.max_input_boxes,
                                  max_output_boxes=cfg.num_queries,
                                  subset_fraction=config.data.subset_fraction)
    return executor_pipeline_from_arrays(config.replace(model=cfg), arrays,
                                         H5Features(config.data.features_h5), device)


# ---------------------------------------------------------------------------
# executor_scheduled
# ---------------------------------------------------------------------------


def executor_scheduled_pipeline_from_arrays(config: ExperimentConfig,
                                            arrays: Dict[str, np.ndarray], features: Features,
                                            device: Union[str, torch.device] = "cuda"
                                            ) -> Pipeline:
    """The executor trained with chain-level scheduled sampling
    (``train.scheduled``) on per-question chain records in
    ``executor_chain_step_arrays``' layout and image features indexed by
    their ``image_index``.  Training batches carry ``p_sample`` =
    ``schedule_p(epoch)``, validation and test batches 0 (the ground-truth
    caches: the loss without the chained pass).  ``config.model`` is used as
    it is."""
    device = resolve_device(device)
    cfg = config.model
    model = _init_executor(ProgramExecutor(cfg, model_dtype(config, device), device),
                           config.train.seed)
    gather = _FeatureGather(features)

    def with_p(p: float):
        def transform(batch):
            return {**gather(batch), "p_sample": np.float32(p)}

        return transform

    train_b, val_b, test_b, spe = _batch_factories(
        arrays, config, with_p(0.0), lambda epoch: with_p(schedule_p(epoch, cfg)))
    return Pipeline(model, make_scheduled_loss_fn(cfg), train_b, val_b, test_b,
                    ("routing_correct", "routing_total"), spe)


def _executor_scheduled_pipeline(config: ExperimentConfig, device) -> Pipeline:
    from explainable_spatial_vqa_tpu_torch.core.artifacts import H5Features
    from explainable_spatial_vqa_tpu_torch.train.datasets import executor_chain_step_arrays

    annotated, vocabs, cfg = _read_executor_data(config)
    arrays = executor_chain_step_arrays(annotated, vocabs["function"], vocabs["other"],
                                        max_steps=28, max_output_boxes=cfg.num_queries,
                                        subset_fraction=config.data.subset_fraction)
    return executor_scheduled_pipeline_from_arrays(config.replace(model=cfg), arrays,
                                                   H5Features(config.data.features_h5), device)


# ---------------------------------------------------------------------------
# iqap (transformer_iqap, transformer_iqap_bb)
# ---------------------------------------------------------------------------


def iqap_pipeline_from_arrays(config: ExperimentConfig, arrays: Dict[str, np.ndarray],
                              features: Features,
                              device: Union[str, torch.device] = "cuda") -> Pipeline:
    """The Transformer IQAP on encoded questions: ``arrays`` holds
    "questions", "answers", "image_index" and optionally "programs" (then
    the program is generated greedily, also in training, and its logits'
    cross-entropy joins the loss) and "target_boxes"/"target_box_mask" (the
    bbox head's smooth-L1 targets); ``features`` (N_images, P, C) tokens.
    ``config.model`` is used as it is."""
    device = resolve_device(device)
    cfg = config.model
    model = init_parameters(TransformerIQAP(cfg, model_dtype(config, device), device),
                            config.train.seed)

    def loss_fn(model, batch, generator, train):
        out = model(batch["image"], batch["questions"])
        loss = cross_entropy(out["answer_logits"], batch["answers"])
        metrics = answer_metrics(out["answer_logits"], batch["answers"])
        if "programs" in batch:
            # as the reference: generated without teacher forcing, also in training
            tokens, logits = generate_programs(model, out["memory"],
                                               max_len=batch["programs"].shape[1])
            loss = (cfg.answer_loss_weight * loss
                    + cfg.program_loss_weight * cross_entropy(logits, batch["programs"]))
            metrics.update(program_metrics(tokens, batch["programs"]))
        if "pred_boxes" in out and "target_boxes" in batch:
            loss = loss + masked_box_regression_loss(out["pred_boxes"], batch["target_boxes"],
                                                     batch["target_box_mask"])
            metrics.update(mean_iou(out["pred_boxes"], batch["target_boxes"],
                                    batch["target_box_mask"]))
        return loss, metrics

    train_b, val_b, test_b, spe = _batch_factories(arrays, config, _FeatureGather(features))
    return Pipeline(model, loss_fn, train_b, val_b, test_b, ("answer_correct", "answer_total"),
                    spe)


def _iqap_pipeline(config: ExperimentConfig, device) -> Pipeline:
    from explainable_spatial_vqa_tpu_torch.core.artifacts import H5Features, read_questions_h5

    enc = read_questions_h5(config.data.questions_h5)
    arrays = {"questions": enc.questions, "answers": enc.answers, "programs": enc.programs,
              "image_index": enc.image_idxs}
    arrays = {k: v for k, v in arrays.items() if v is not None}
    if config.model.with_bbox_head and config.data.scenes_h5:
        from explainable_spatial_vqa_tpu_torch.core.artifacts import read_scenes_h5

        scenes = read_scenes_h5(config.data.scenes_h5)
        # by image_index VALUE, not row position: a scenes h5 exported from a
        # filtered or offset split is not dense 0..N-1
        row_of = {int(v): i for i, v in enumerate(scenes["image_index"])}
        missing = sorted({int(i) for i in enc.image_idxs} - set(row_of))
        if missing:
            raise ValueError(f"scenes_h5 lacks image indices {missing[:5]}"
                             f"{'...' if len(missing) > 5 else ''} referenced by questions")
        rows = np.asarray([row_of[int(i)] for i in enc.image_idxs])
        slots = config.model.num_bbox_slots
        gt = scenes["bounding_boxes"][rows][:, :slots]
        gt_mask = scenes["class_labels"][rows][:, :slots] > 0
        pad = slots - gt.shape[1]
        if pad > 0:
            gt = np.pad(gt, ((0, 0), (0, pad), (0, 0)))
            gt_mask = np.pad(gt_mask, ((0, 0), (0, pad)))
        arrays["target_boxes"] = gt.astype(np.float32)
        arrays["target_box_mask"] = gt_mask
    return iqap_pipeline_from_arrays(config, arrays, H5Features(config.data.features_h5),
                                     device)


# ---------------------------------------------------------------------------
# lstm_iqap (lstm_iqap, lstm_iqa)
# ---------------------------------------------------------------------------


def lstm_iqap_pipeline_from_arrays(config: ExperimentConfig, arrays: Dict[str, np.ndarray],
                                   features: Features,
                                   device: Union[str, torch.device] = "cuda") -> Pipeline:
    """The LSTM IQAP/IQA on encoded questions: ``arrays`` holds "questions",
    "answers", "image_index" and, for the program decoder, "programs"
    (scheduled teacher forcing, the coins from the trainer's generator);
    ``features`` (N_images, C, H, W) grids.  ``config.model`` is used as it
    is."""
    device = resolve_device(device)
    cfg = config.model
    model = init_parameters(LstmIQAP(cfg, model_dtype(config, device), device),
                            config.train.seed)
    if not cfg.with_program_decoder:
        arrays = {k: v for k, v in arrays.items() if k != "programs"}

    def loss_fn(model, batch, generator, train):
        out = model(batch["image"], batch["questions"], batch.get("programs"),
                    generator=generator)
        loss = cross_entropy(out["answer_logits"], batch["answers"])
        metrics = answer_metrics(out["answer_logits"], batch["answers"])
        if "program_logits" in out and "programs" in batch:
            loss = loss + cross_entropy(out["program_logits"], batch["programs"])
            metrics.update(program_metrics(out["program_tokens"], batch["programs"]))
        return loss, metrics

    train_b, val_b, test_b, spe = _batch_factories(arrays, config, _FeatureGather(features))
    return Pipeline(model, loss_fn, train_b, val_b, test_b, ("answer_correct", "answer_total"),
                    spe)


def _lstm_iqap_pipeline(config: ExperimentConfig, device) -> Pipeline:
    from explainable_spatial_vqa_tpu_torch.core.artifacts import H5Features, read_questions_h5

    enc = read_questions_h5(config.data.questions_h5)
    arrays = {"questions": enc.questions, "answers": enc.answers,
              "image_index": enc.image_idxs}
    if enc.programs is not None:
        arrays["programs"] = enc.programs
    return lstm_iqap_pipeline_from_arrays(
        config, arrays, H5Features(config.data.features_h5, as_tokens=False), device)


# ---------------------------------------------------------------------------
# step_seq2seq
# ---------------------------------------------------------------------------


def step_seq2seq_pipeline_from_arrays(config: ExperimentConfig, arrays: Dict[str, np.ndarray],
                                      features: Features,
                                      device: Union[str, torch.device] = "cuda") -> Pipeline:
    """The step seq2seq on ``flatten_steps``' records ("image_index", "src",
    "tgt"): teacher-forced on tgt[:, :-1] against tgt[:, 1:] with padding
    ignored, the src padding masked in the encoder; ``features`` (N_images,
    P, C) tokens.  ``config.model`` is used as it is."""
    device = resolve_device(device)
    model = init_parameters(StepExecutorSeq2Seq(config.model, model_dtype(config, device),
                                                device), config.train.seed)

    def loss_fn(model, batch, generator, train):
        src, tgt = batch["src"], batch["tgt"]
        logits = model(batch["image"], src, tgt[:, :-1], src != 0)
        targets = tgt[:, 1:]
        loss = cross_entropy(logits, targets, ignore_index=0)
        return loss, masked_token_metrics(torch.argmax(logits, -1), targets)

    train_b, val_b, test_b, spe = _batch_factories(arrays, config, _FeatureGather(features))
    return Pipeline(model, loss_fn, train_b, val_b, test_b, ("token_correct", "token_total"),
                    spe)


def _step_seq2seq_pipeline(config: ExperimentConfig, device) -> Pipeline:
    from explainable_spatial_vqa_tpu_torch.core.artifacts import H5Features, read_annotated_h5
    from explainable_spatial_vqa_tpu_torch.train.datasets import flatten_steps

    arrays = flatten_steps(read_annotated_h5(config.data.annotated_h5),
                           max_src_len=config.model.max_src_len,
                           max_tgt_len=config.model.max_tgt_len,
                           subset_fraction=config.data.subset_fraction)
    return step_seq2seq_pipeline_from_arrays(config, arrays,
                                             H5Features(config.data.features_h5), device)


# ---------------------------------------------------------------------------
# iqap_cot (transformer_iqap_cot)
# ---------------------------------------------------------------------------


def iqap_cot_pipeline_from_arrays(config: ExperimentConfig, mapped: Dict[str, np.ndarray],
                                  token_to_id: Dict[str, int], features: Features,
                                  device: Union[str, torch.device] = "cuda") -> Pipeline:
    """The chain-of-thought IQAP on ``build_mapped_sequences``' arrays and
    vocabulary; ``features`` (N_images, P, C) tokens.  The model is sized to
    the string vocabulary (vocab, program vocab and answer classes all
    max(vocabulary, preset)) and to the arrays' question and program
    lengths; the answer is the first answer token.  The loss is the
    answer's CE plus the CE of the teacher-forced combined sequence without
    its box-coordinate tokens, the decode run without dropout in any mode,
    as in JAX."""
    from explainable_spatial_vqa_tpu_torch.models.cot import (
        bbox_token_table,
        cross_entropy_skip_bbox,
    )

    device = resolve_device(device)
    vocab_size = max(len(token_to_id), config.model.program_vocab_size)
    cfg = dataclasses.replace(
        config.model, vocab_size=vocab_size, program_vocab_size=vocab_size,
        num_answer_classes=vocab_size, program_len=int(mapped["program_tokens"].shape[1]),
        max_question_len=int(mapped["question_tokens"].shape[1]))
    config = config.replace(model=cfg)
    idx_to_token = {int(v): k for k, v in token_to_id.items()}
    bbox_table = torch.from_numpy(bbox_token_table(idx_to_token, vocab_size)).to(device)
    arrays = {
        "questions": mapped["question_tokens"].astype(np.int32),
        "programs": mapped["program_tokens"].astype(np.int32),
        "answers": mapped["answer_tokens"][:, 0].astype(np.int32),
        "image_index": mapped["image_index"].astype(np.int32),
    }
    model = init_parameters(TransformerIQAP(cfg, model_dtype(config, device), device),
                            config.train.seed)

    def loss_fn(model, batch, generator, train):
        out = model(batch["image"], batch["questions"])
        programs = batch["programs"]
        # the start id is 1 (<UNK> in the string vocabulary), as in JAX
        inputs = torch.cat([torch.ones_like(programs[:, :1]), programs[:, :-1]], dim=1)
        logits = model.decode_programs_tf(inputs, out["memory"])
        loss = (cross_entropy(out["answer_logits"], batch["answers"])
                + cross_entropy_skip_bbox(logits, programs, bbox_table, ignore_index=0))
        metrics = answer_metrics(out["answer_logits"], batch["answers"])
        metrics.update(masked_token_metrics(torch.argmax(logits, -1), programs))
        return loss, metrics

    train_b, val_b, test_b, spe = _batch_factories(arrays, config, _FeatureGather(features))
    return Pipeline(model, loss_fn, train_b, val_b, test_b, ("answer_correct", "answer_total"),
                    spe)


def _iqap_cot_pipeline(config: ExperimentConfig, device) -> Pipeline:
    from explainable_spatial_vqa_tpu_torch.core.annotated_strings import read_mapped_sequences
    from explainable_spatial_vqa_tpu_torch.core.artifacts import H5Features

    mapped = read_mapped_sequences(config.data.mapped_sequences_h5)
    with open(config.data.string_vocab_json) as f:
        blob = json.load(f)
    return iqap_cot_pipeline_from_arrays(config, mapped, blob.get("token_to_id", blob),
                                         H5Features(config.data.features_h5), device)


# ---------------------------------------------------------------------------
# prototype_step (token_only, bb_only, bb_only_iou, yolo_bb, multitask_bb,
# bbinout, multihead, hierarchical)
# ---------------------------------------------------------------------------


class _ImageGather:
    """Decoded raw images by image index, (B, S, S, 3) float32 in [0, 1]
    (the from-pixels YOLO prototype), from the directory's PNGs; the decoded
    images stay in a bounded LRU cache (a full CLEVR split would otherwise
    pin ~40 GB of pixels on the host)."""

    def __init__(self, image_dir: str, size: int = 224, cache_images: int = 2048):
        from explainable_spatial_vqa_tpu_torch.vision.extract import collect_image_paths

        if not image_dir:
            raise ValueError("this preset trains from raw pixels: pass --image_dir with the "
                             "CLEVR PNG directory (DataConfig.image_dir is empty)")
        self.paths = collect_image_paths(image_dir)
        self.size = size
        self._cache: "OrderedDict[int, np.ndarray]" = OrderedDict()
        self._cache_images = cache_images

    def _load(self, idx: int) -> np.ndarray:
        if idx in self._cache:
            self._cache.move_to_end(idx)
            return self._cache[idx]
        from explainable_spatial_vqa_tpu_torch.vision.extract import _decode_resize_pil

        arr = _decode_resize_pil(self.paths[idx], (self.size, self.size)).astype(np.float32)
        arr /= 255.0
        self._cache[idx] = arr
        if len(self._cache) > self._cache_images:
            self._cache.popitem(last=False)
        return arr

    def __getitem__(self, idx: np.ndarray) -> np.ndarray:
        return np.stack([self._load(int(i)) for i in idx])


def _masked_box_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Squared coordinate error over the masked slots, per coordinate."""
    m = mask.float()
    return (((pred - target) ** 2) * m[..., None]).sum() / global_normaliser(m.sum() * 4)


def _prototype_model(cfg, dtype: torch.dtype, device: torch.device) -> nn.Module:
    from explainable_spatial_vqa_tpu_torch.models import prototypes as proto

    fused = dict(function_vocab_size=cfg.function_vocab_size,
                 max_input_boxes=cfg.max_input_boxes,
                 image_feature_dim=cfg.image_feature_dim, dtype=dtype, device=device)
    if cfg.kind == "token_only":
        return proto.TokenOnlyPredictor(token_vocab_size=cfg.token_vocab_size, **fused)
    if cfg.kind == "bb_only":
        return proto.BBoxOnlyPredictor(max_output_boxes=cfg.max_output_boxes, **fused)
    if cfg.kind == "multitask_bb":
        return proto.MultiTaskBBoxTokenPredictor(max_output_boxes=cfg.max_output_boxes,
                                                 token_vocab_size=cfg.token_vocab_size, **fused)
    if cfg.kind == "selection":
        return proto.BBoxSelectionPredictor(**fused)
    if cfg.kind == "multihead":
        return proto.MultiHeadStepModel(
            vocab_size=cfg.vocab_size, image_feat_dim=cfg.image_feature_dim,
            image_spatial=tuple(cfg.image_spatial), max_bbox_steps=cfg.max_output_boxes,
            dtype=dtype, device=device)
    if cfg.kind == "hierarchical":
        return proto.HierarchicalGenerator(
            num_image_tokens=cfg.num_image_tokens, image_feature_dim=cfg.image_feature_dim,
            max_inner_steps=cfg.max_output_boxes, dtype=dtype, device=device)
    if cfg.kind == "yolo":
        return proto.YoloDetector(grid=cfg.grid, image_size=cfg.image_size, dtype=dtype,
                                  device=device)
    raise KeyError(f"unknown prototype kind {cfg.kind!r}")


def _prototype_loss_fn(cfg):
    """(loss_fn, monitor) of the prototype ``cfg.kind``, JAX's losses and
    metric names."""
    from explainable_spatial_vqa_tpu_torch.models.prototypes import yolo_grid_loss
    from explainable_spatial_vqa_tpu_torch.ops.matching import box_iou
    from explainable_spatial_vqa_tpu_torch.train.datasets import MULTIHEAD_HEADS
    from explainable_spatial_vqa_tpu_torch.train.losses import binary_cross_entropy

    kind = cfg.kind

    def fused_inputs(batch):
        return batch["image"], batch["text"][:, 0], batch["input_boxes"]

    if kind == "token_only":
        def loss_fn(model, batch, generator, train):
            logits = model(*fused_inputs(batch))
            pred = torch.argmax(logits, -1)
            return cross_entropy(logits, batch["token_target"]), {
                "token_correct": (pred == batch["token_target"]).sum(),
                "token_total": pred.shape[0]}

        return loss_fn, ("token_correct", "token_total")

    if kind == "bb_only":
        def loss_fn(model, batch, generator, train):
            out = model(*fused_inputs(batch))
            boxes, conf = out[..., :4], out[..., 4]
            mask = batch["target_box_mask"]
            loss = (_masked_box_mse(boxes, batch["target_boxes"], mask)
                    + binary_cross_entropy(conf, mask.float()).mean())
            iou = box_iou(boxes, batch["target_boxes"])
            if cfg.iou_weight > 0.0:  # v2: + the IoU term
                loss = loss + cfg.iou_weight * (
                    ((1.0 - iou) * mask).sum() / global_normaliser(mask.float().sum()))
            return loss, {"iou_sum": (iou * mask).sum(), "iou_total": mask.sum()}

        return loss_fn, ("iou_sum", "iou_total")

    if kind == "multitask_bb":
        def loss_fn(model, batch, generator, train):
            out = model(*fused_inputs(batch))
            losses = executor_set_loss(out, batch["target_boxes"], batch["target_box_mask"],
                                       batch["token_target"], batch["is_box_branch"], cfg)
            routing_pred = torch.argmax(out["routing_logits"], -1)
            return losses["loss"], {
                "routing_correct": (routing_pred == 1 - batch["is_box_branch"].long()).sum(),
                "routing_total": routing_pred.shape[0]}

        return loss_fn, ("routing_correct", "routing_total")

    if kind == "selection":
        def loss_fn(model, batch, generator, train):
            logits = model(*fused_inputs(batch))
            mask = batch["input_box_mask"].float()
            bce = binary_cross_entropy(torch.sigmoid(logits), batch["selected"])
            pred = (logits > 0).float()
            return (bce * mask).sum() / global_normaliser(mask.sum()), {
                "select_correct": ((pred == batch["selected"]) * mask).sum(),
                "select_total": mask.sum()}

        return loss_fn, ("select_correct", "select_total")

    if kind == "multihead":
        def loss_fn(model, batch, generator, train):
            out = model(batch["text"][:, 0], batch["text"][:, 1:], batch["image"],
                        batch["target_boxes"], generator=generator)
            head_id, typed = batch["head_id"], batch["typed_target"]
            total = torch.zeros((), device=typed.device)
            correct = torch.zeros((), device=typed.device)
            count = torch.zeros((), device=typed.device)
            # each typed head's CE on its rows; the targets clamped into the
            # head's classes first (another head's target past them would
            # give NaN, and 0 * NaN poisons the sum)
            for h, name in enumerate(MULTIHEAD_HEADS):
                if name == "bbox":
                    continue
                sel = head_id == h
                safe = torch.clamp(typed, max=out[name].shape[-1] - 1)
                total = total + cross_entropy(out[name], safe, label_weights=sel.float())
                correct = correct + ((torch.argmax(out[name], -1) == typed) & sel).sum()
                count = count + sel.sum()
            # the box branch: the masked coordinate MSE and the stop CE
            is_box = head_id == 0
            mask = batch["target_box_mask"] & is_box[:, None]
            stop_target = (~batch["target_box_mask"]).long()
            total = total + _masked_box_mse(out["bbox"], batch["target_boxes"], mask)
            total = total + cross_entropy(
                out["bbox_stop_logits"], stop_target,
                label_weights=is_box[:, None].expand(stop_target.shape).float())
            return total, {"typed_correct": correct, "typed_total": count}

        return loss_fn, ("typed_correct", "typed_total")

    if kind == "hierarchical":
        def loss_fn(model, batch, generator, train):
            out = model(batch["image"], batch["target_boxes"])
            is_box = batch["is_box_branch"]
            type_target = (~is_box).long()
            mask = batch["target_box_mask"] & is_box[:, None]
            loss = (cross_entropy(out["type_logits"], type_target)
                    + _masked_box_mse(out["pred_boxes"], batch["target_boxes"], mask))
            stop_target = (~batch["target_box_mask"]).float()
            stop_bce = binary_cross_entropy(torch.sigmoid(out["stop_logits"]), stop_target)
            box_rows = is_box[:, None].float()
            loss = loss + (stop_bce * box_rows).sum() / global_normaliser(
                box_rows.sum() * stop_target.shape[1])
            value_err = (out["nonspatial_value"] - batch["token_target"].float()) ** 2
            value_rows = (~is_box).float()
            loss = loss + (value_err * value_rows).sum() / global_normaliser(value_rows.sum())
            type_pred = torch.argmax(out["type_logits"], -1)
            return loss, {"type_correct": (type_pred == type_target).sum(),
                          "type_total": type_pred.shape[0]}

        return loss_fn, ("type_correct", "type_total")

    if kind == "yolo":
        def loss_fn(model, batch, generator, train):
            pred = model(batch["image"])
            hit = (pred[..., 4] > 0.5) == (batch["yolo_target"][..., 4] > 0)
            return yolo_grid_loss(pred, batch["yolo_target"]), {
                "cell_correct": hit.sum(), "cell_total": hit.numel()}

        return loss_fn, ("cell_correct", "cell_total")

    raise KeyError(f"unknown prototype kind {kind!r}")


def prototype_step_pipeline_from_arrays(config: ExperimentConfig, arrays: Dict[str, np.ndarray],
                                        function_vocab: Dict[str, int],
                                        value_vocab: Dict[str, int], features: Features,
                                        device: Union[str, torch.device] = "cuda") -> Pipeline:
    """A prototype step model (``config.model.kind``) on step records in
    ``executor_step_arrays``' layout, built with ``config.model``'s
    ``max_input_boxes`` and ``max_output_boxes``, and the split vocabulary
    they were encoded in.  ``features``: the (N_images, C, H, W) grids (as
    tokens for every kind but ``multihead``), or for ``yolo`` the (N_images,
    S, S, 3) pixels in [0, 1] or an :class:`_ImageGather`.  The vocabulary
    sizes grow to the vocabulary's (max(preset, data)); each kind keeps its
    own samples (``token_only`` the token steps, ``bb_only`` and ``yolo``
    the box steps, ``selection`` the box steps with input boxes)."""
    from explainable_spatial_vqa_tpu_torch.train import datasets as ds

    device = resolve_device(device)
    n_fn, n_val = len(function_vocab) + 1, len(value_vocab) + 1
    cfg = dataclasses.replace(
        config.model, function_vocab_size=max(config.model.function_vocab_size, n_fn),
        token_vocab_size=max(config.model.token_vocab_size, n_val),
        vocab_size=max(config.model.vocab_size, n_val, n_fn))
    config = config.replace(model=cfg)
    kind = cfg.kind
    arrays = dict(arrays)
    if kind == "multihead":
        arrays.update(ds.multihead_typed_targets(arrays, function_vocab, value_vocab))
    if kind == "selection":
        arrays["selected"] = ds.selection_targets(arrays)
    if kind == "yolo":
        arrays["yolo_target"] = ds.yolo_grid_targets(arrays["target_boxes"],
                                                     arrays["target_box_mask"], cfg.grid)
    if kind == "token_only":
        keep = ~arrays["is_box_branch"]
    elif kind in ("bb_only", "yolo"):
        keep = arrays["is_box_branch"]
    elif kind == "selection":
        keep = arrays["is_box_branch"] & arrays["input_box_mask"].any(-1)
    else:
        keep = np.ones(len(arrays["is_box_branch"]), bool)
    arrays = {k: v[keep] for k, v in arrays.items()}
    if len(arrays["is_box_branch"]) < 2:
        raise ValueError(
            f"preset kind {kind!r} found {len(arrays['is_box_branch'])} usable step samples: "
            f"check that the annotated steps and the split vocabulary come from the same "
            f"annotate run (e.g. `annotate --mode v3 --vocab_output vocab3.json`)")

    model = init_parameters(_prototype_model(cfg, model_dtype(config, device), device),
                            config.train.seed)
    loss_fn, monitor = _prototype_loss_fn(cfg)
    gather = _FeatureGather(features, as_tokens=kind not in ("multihead", "yolo"))
    train_b, val_b, test_b, spe = _batch_factories(arrays, config, gather)
    return Pipeline(model, loss_fn, train_b, val_b, test_b, monitor, spe)


def _prototype_step_pipeline(config: ExperimentConfig, device) -> Pipeline:
    from explainable_spatial_vqa_tpu_torch.core.artifacts import H5Features, read_annotated_h5
    from explainable_spatial_vqa_tpu_torch.core.vocab import load_vocab
    from explainable_spatial_vqa_tpu_torch.train.datasets import executor_step_arrays

    vocabs = load_vocab(config.data.split_vocab_json)
    cfg = config.model
    arrays = executor_step_arrays(read_annotated_h5(config.data.annotated_h5),
                                  vocabs["function"], vocabs["other"],
                                  max_input_boxes=cfg.max_input_boxes,
                                  max_output_boxes=cfg.max_output_boxes,
                                  subset_fraction=config.data.subset_fraction)
    if cfg.kind == "yolo":
        features: Features = _ImageGather(config.data.image_dir, cfg.image_size)
    else:
        features = H5Features(config.data.features_h5, as_tokens=False)
    return prototype_step_pipeline_from_arrays(config, arrays, vocabs["function"],
                                               vocabs["other"], features, device)


_FAMILIES = {"generator": _generator_pipeline, "executor": _executor_pipeline,
             "executor_scheduled": _executor_scheduled_pipeline, "iqap": _iqap_pipeline,
             "lstm_iqap": _lstm_iqap_pipeline, "step_seq2seq": _step_seq2seq_pipeline,
             "iqap_cot": _iqap_cot_pipeline, "prototype_step": _prototype_step_pipeline}


def build_pipeline(config: ExperimentConfig,
                   device: Union[str, torch.device] = "cuda") -> Pipeline:
    if config.model_family not in _FAMILIES:
        raise KeyError(f"unknown model family {config.model_family!r}")
    return _FAMILIES[config.model_family](config, resolve_device(device))
