"""Configurations: copies of the JAX package's ``DataConfig``,
``OptimConfig``, ``GeneratorConfig``, ``ExecutorConfig``, ``TrainConfig`` and
``ExperimentConfig``, the baselines' ``IQAPConfig``, ``LstmIQAPConfig`` and
``StepSeq2SeqConfig`` and the prototypes' ``PrototypeStepConfig``
(``explainable_spatial_vqa_tpu/core/config.py``), field for field, so one
set of keyword arguments builds both packages' models and trainers, with
every preset of the JAX package: ``generator``, the five executor presets,
``executor_scheduled``, the checked-in reference scripts' ``lstm_qp``,
``transformer_iqap``, ``transformer_iqap_bb``, ``transformer_iqap_cot``,
``lstm_iqap``, ``lstm_iqa`` and ``step_seq2seq``, and the eight prototype
presets.
``TrainConfig.mesh_shape`` and ``mesh_axes`` give the data-parallel
trainer its mesh over the process group's ranks (``train.trainer``,
``parallel.mesh.make_mesh``)."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

__all__ = ["DataConfig", "OptimConfig", "GeneratorConfig", "ExecutorConfig", "IQAPConfig",
           "LstmIQAPConfig", "StepSeq2SeqConfig", "PrototypeStepConfig", "TrainConfig",
           "ExperimentConfig", "PRESETS", "get_preset"]


@dataclass(frozen=True)
class DataConfig:
    features_h5: str = "data/train_features.h5"
    questions_h5: str = "data/train_questions.h5"
    annotated_h5: str = "data/annotated_questions.h5"
    mapped_sequences_h5: str = "data/mapped_sequences.h5"
    scenes_h5: str = ""  # GT boxes for the iqap_bb variant (optional)
    string_vocab_json: str = "data/string_vocab.json"
    vocab_json: str = "data/vocab.json"
    split_vocab_json: str = "data/vocab3.json"
    image_dir: str = ""  # raw PNGs for the from-pixels YOLO variant
    max_question_len: int = 46
    max_program_len: int = 27
    max_src_len: int = 50
    max_tgt_len: int = 20
    max_input_boxes: int = 18
    max_output_boxes: int = 10
    subset_fraction: float = 1.0
    validation_split: float = 0.1
    test_split: float = 0.1
    seed: int = 42


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    grad_clip_norm: Optional[float] = None
    lr_step_size: Optional[int] = None  # epochs between step decays
    lr_gamma: float = 0.1
    weight_decay: float = 0.0


@dataclass(frozen=True)
class GeneratorConfig:
    """Program generator (thesis §3.4.1: 3-layer bi-LSTM encoder, 3-layer
    decoder with Luong dot attention, emb 300, hid 512, TF 0.5)."""

    vocab_size: int = 96
    program_vocab_size: int = 45
    embed_dim: int = 300
    hidden_dim: int = 512
    encoder_layers: int = 3
    decoder_layers: int = 3
    bidirectional: bool = True
    attention: bool = True
    dropout: float = 0.3
    teacher_forcing: float = 0.5
    program_len: int = 27
    simple: bool = False  # True = checked-in 1-layer no-attention variant


@dataclass(frozen=True)
class ExecutorConfig:
    """Program executor (thesis §3.4.2: fusion encoder CLS+P+10+3 d=512 3L/4H,
    routing head, DETR-style box decoder with 10 queries/2L, token head)."""

    vocab_size: int = 128
    d_model: int = 512
    num_heads: int = 4
    encoder_layers: int = 3
    box_decoder_layers: int = 2
    num_queries: int = 10
    num_image_tokens: int = 196
    image_feature_dim: int = 1024
    max_input_boxes: int = 10
    num_text_tokens: int = 3
    token_classes: int = 32
    dropout: float = 0.1
    conf_threshold: float = 0.5
    # loss weights (thesis Table 4.1)
    routing_weight: float = 0.1
    bbox_weight: float = 5.0
    token_weight: float = 1.0
    # Hungarian cost weights
    cost_l1: float = 5.0
    cost_giou: float = 2.0
    cost_conf: float = 1.0
    matcher: str = "auto"
    sinkhorn_iters: int = 20
    sinkhorn_tau: float = 1.0
    # grounding-noise augmentation (training only)
    input_box_noise: float = 0.0
    input_box_drop: float = 0.0
    # chain-level scheduled sampling (training only)
    scheduled_p_max: float = 0.0
    scheduled_ramp_epochs: int = 5
    remat: bool = False
    # ROI content for input-box tokens: each dependency-box token also gets
    # the coverage-weighted average of the image tokens under its box
    box_roi: bool = False
    # content-similarity channel (roi_sim_heads match maps per input box;
    # needs box_roi) and input-box-count embedding on CLS
    roi_sim: bool = False
    roi_sim_heads: int = 1
    count_embed: bool = False


@dataclass(frozen=True)
class IQAPConfig:
    """Transformer IQAP baseline family (train_transformer_iqap*.py)."""

    vocab_size: int = 96
    program_vocab_size: int = 45
    num_answer_classes: int = 32
    embed_dim: int = 256
    hidden_dim: int = 256
    num_heads: int = 4
    encoder_layers: int = 2
    decoder_layers: int = 2
    num_image_tokens: int = 196
    image_feature_dim: int = 1024
    program_len: int = 27
    max_question_len: int = 46
    dropout: float = 0.1
    sos_token: int = 1
    answer_loss_weight: float = 1.0
    program_loss_weight: float = 1.0
    with_bbox_head: bool = False
    num_bbox_slots: int = 10


@dataclass(frozen=True)
class LstmIQAPConfig:
    """LSTM IQAP/IQA family (train_lstm_iqap.py / train_lstm_iqa.py)."""

    vocab_size: int = 96
    program_vocab_size: int = 45
    num_answer_classes: int = 32
    embed_dim: int = 256
    hidden_dim: int = 512
    image_feature_dim: int = 1024
    image_spatial: Tuple[int, int] = (14, 14)
    program_len: int = 27
    with_program_decoder: bool = True
    teacher_forcing: float = 0.5
    dropout: float = 0.5


@dataclass(frozen=True)
class StepSeq2SeqConfig:
    """Step executor seq2seq (train_transformer_full_annotation_new.py:35-76)."""

    vocab_size: int = 128
    d_model: int = 256
    num_heads: int = 4
    encoder_layers: int = 2
    decoder_layers: int = 2
    ffn_dim: int = 512
    dropout: float = 0.1
    max_src_len: int = 50
    max_tgt_len: int = 20
    num_image_tokens: int = 196
    image_feature_dim: int = 1024


@dataclass(frozen=True)
class PrototypeStepConfig:
    """One config for the prototype step-model families, by ``kind``:

    - ``token_only``   -- TokenOnlyPredictor
    - ``bb_only``      -- BBoxOnlyPredictor, positional box regression
                         (iou_weight > 0 adds an IoU term)
    - ``multitask_bb`` -- MultiTaskBBoxTokenPredictor + the set-matching loss
    - ``selection``    -- BBoxSelectionPredictor, per-input-box membership
    - ``multihead``    -- MultiHeadStepModel, 8 typed heads + AR box decoder
    - ``hierarchical`` -- HierarchicalGenerator
    - ``yolo``         -- YoloDetector from raw pixels + the grid loss
    """

    kind: str = "token_only"
    function_vocab_size: int = 64
    token_vocab_size: int = 64
    vocab_size: int = 64  # multihead text vocab
    max_input_boxes: int = 18
    max_output_boxes: int = 10
    image_feature_dim: int = 1024
    image_spatial: Tuple[int, int] = (14, 14)
    num_image_tokens: int = 196
    iou_weight: float = 0.0  # bb_only v2: + iou_weight * (1 - IoU)
    # multitask_bb's set loss (read by train.losses.executor_set_loss)
    matcher: str = "sinkhorn"
    sinkhorn_iters: int = 20
    sinkhorn_tau: float = 1.0
    cost_l1: float = 5.0
    cost_giou: float = 2.0
    cost_conf: float = 1.0
    routing_weight: float = 1.0
    bbox_weight: float = 1.0
    token_weight: float = 1.0
    input_box_noise: float = 0.0
    input_box_drop: float = 0.0
    # yolo
    grid: int = 7
    image_size: int = 224


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 16
    num_epochs: int = 100
    patience: int = 10
    checkpoint_dir: str = "checkpoints"
    checkpoint_interval: int = 10
    log_every: int = 50
    eval_every: int = 1
    # compute dtype for model matmuls; params/softmax/layernorm stay float32.
    # "auto" = bfloat16 on the card, float32 on the CPU (train.pipelines)
    dtype: str = "auto"
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    seed: int = 42
    resume: bool = True


@dataclass(frozen=True)
class ExperimentConfig:
    name: str
    # generator | executor | executor_scheduled | iqap | lstm_iqap |
    # step_seq2seq | iqap_cot | prototype_step
    model_family: str
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    model: Any = None

    def replace(self, **kwargs: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _preset_map() -> Dict[str, ExperimentConfig]:
    """The thesis pair (hyperparameters of record, thesis Table 4.1), the
    executor's beyond-reference channels and the baselines, as in the JAX
    package's presets."""
    executor = dict(model_family="executor", optim=OptimConfig(learning_rate=1e-4),
                    train=TrainConfig(batch_size=16, num_epochs=100, patience=10))
    presets = {
        "generator": ExperimentConfig(
            name="generator", model_family="generator", model=GeneratorConfig(),
            optim=OptimConfig(learning_rate=1e-3),
            train=TrainConfig(batch_size=64, num_epochs=20, patience=5)),
        "executor": ExperimentConfig(name="executor", model=ExecutorConfig(), **executor),
        # the shipped recipe's model: ROI content for the dependency-box tokens
        "executor_roi": ExperimentConfig(
            name="executor_roi", model=ExecutorConfig(box_roi=True), **executor),
        "executor_roi_count": ExperimentConfig(
            name="executor_roi_count", model=ExecutorConfig(box_roi=True, count_embed=True),
            **executor),
        "executor_roi_sim": ExperimentConfig(
            name="executor_roi_sim", model=ExecutorConfig(box_roi=True, roi_sim=True),
            **executor),
        "executor_roi_sim_count": ExperimentConfig(
            name="executor_roi_sim_count",
            model=ExecutorConfig(box_roi=True, roi_sim=True, roi_sim_heads=4, count_embed=True),
            **executor),
        # chain-level scheduled sampling (train.scheduled): opt-in, the
        # shipped recipe trains teacher-forced
        "executor_scheduled": ExperimentConfig(
            name="executor_scheduled",
            model=ExecutorConfig(scheduled_p_max=0.5, scheduled_ramp_epochs=5),
            **dict(executor, model_family="executor_scheduled")),
        # the checked-in reference scripts' configurations (the baselines)
        "lstm_qp": ExperimentConfig(
            name="lstm_qp", model_family="generator",
            model=GeneratorConfig(embed_dim=256, hidden_dim=512, encoder_layers=1,
                                  decoder_layers=1, bidirectional=False, attention=False,
                                  dropout=0.5, simple=True),
            optim=OptimConfig(learning_rate=1e-3),
            train=TrainConfig(batch_size=64, num_epochs=20, patience=5)),
        "transformer_iqap": ExperimentConfig(
            name="transformer_iqap", model_family="iqap", model=IQAPConfig(),
            optim=OptimConfig(learning_rate=1e-3, grad_clip_norm=1.0, lr_step_size=10),
            train=TrainConfig(batch_size=64, num_epochs=100, patience=10)),
        "transformer_iqap_bb": ExperimentConfig(
            name="transformer_iqap_bb", model_family="iqap",
            model=IQAPConfig(encoder_layers=1, decoder_layers=1, with_bbox_head=True),
            optim=OptimConfig(learning_rate=1e-3, grad_clip_norm=1.0),
            train=TrainConfig(batch_size=64, num_epochs=100, patience=10)),
        "lstm_iqap": ExperimentConfig(
            name="lstm_iqap", model_family="lstm_iqap", model=LstmIQAPConfig(),
            optim=OptimConfig(learning_rate=1e-3),
            train=TrainConfig(batch_size=64, num_epochs=50, patience=5)),
        "lstm_iqa": ExperimentConfig(
            name="lstm_iqa", model_family="lstm_iqap",
            model=LstmIQAPConfig(with_program_decoder=False),
            optim=OptimConfig(learning_rate=1e-3),
            train=TrainConfig(batch_size=64, num_epochs=50, patience=5)),
        "transformer_iqap_cot": ExperimentConfig(
            name="transformer_iqap_cot", model_family="iqap_cot",
            model=IQAPConfig(encoder_layers=1, decoder_layers=1, program_len=100,
                             max_question_len=20),
            optim=OptimConfig(learning_rate=1e-3, grad_clip_norm=1.0),
            train=TrainConfig(batch_size=64, num_epochs=100, patience=10)),
        "step_seq2seq": ExperimentConfig(
            name="step_seq2seq", model_family="step_seq2seq", model=StepSeq2SeqConfig(),
            optim=OptimConfig(learning_rate=1e-4),
            train=TrainConfig(batch_size=32, num_epochs=10)),
    }

    # the prototype step models, each over the annotated-step arrays
    def proto(name, kind, lr=1e-3, bs=32, epochs=10, clip=None, **kw):
        presets[name] = ExperimentConfig(
            name=name, model_family="prototype_step", model=PrototypeStepConfig(kind=kind, **kw),
            optim=OptimConfig(learning_rate=lr, grad_clip_norm=clip),
            train=TrainConfig(batch_size=bs, num_epochs=epochs, patience=3))

    proto("token_only", "token_only", lr=1e-3)
    proto("bb_only", "bb_only")
    proto("bb_only_iou", "bb_only", iou_weight=1.0)
    proto("yolo_bb", "yolo", lr=1e-4)
    proto("multitask_bb", "multitask_bb", lr=1e-3)
    proto("bbinout", "selection", lr=1e-3)
    # lr 1e-4 and clipping: the flattened-image Dense (200k fan-in)
    # diverges at 1e-3 on random features
    proto("multihead", "multihead", lr=1e-4, clip=1.0)
    proto("hierarchical", "hierarchical", lr=1e-3)
    return presets


PRESETS: Dict[str, ExperimentConfig] = _preset_map()


def get_preset(name: str, **overrides: Any) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; the port has {sorted(PRESETS)}")
    config = PRESETS[name]
    if overrides:
        config = config.replace(**overrides)
    return config
