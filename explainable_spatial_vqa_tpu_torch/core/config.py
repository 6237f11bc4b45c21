"""Configurations: copies of the JAX package's ``DataConfig``,
``OptimConfig``, ``GeneratorConfig``, ``ExecutorConfig``, ``TrainConfig`` and
``ExperimentConfig`` (``explainable_spatial_vqa_tpu/core/config.py``), field
for field, so one set of keyword arguments builds both packages' models and
trainers, with the presets of the families the port trains: ``generator``,
the five executor presets and ``executor_scheduled``.
``TrainConfig.mesh_shape`` and ``mesh_axes`` are kept for that reason; the
port trains on one card and reads neither."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

__all__ = ["DataConfig", "OptimConfig", "GeneratorConfig", "ExecutorConfig", "TrainConfig",
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
    model_family: str  # generator | executor | executor_scheduled (the port's families)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    model: Any = None

    def replace(self, **kwargs: Any) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


def _preset_map() -> Dict[str, ExperimentConfig]:
    """The thesis pair (hyperparameters of record, thesis Table 4.1) and the
    executor's beyond-reference channels, as in the JAX package's presets."""
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
    }
    return presets


PRESETS: Dict[str, ExperimentConfig] = _preset_map()


def get_preset(name: str, **overrides: Any) -> ExperimentConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; the port has {sorted(PRESETS)}")
    config = PRESETS[name]
    if overrides:
        config = config.replace(**overrides)
    return config
