"""Model configurations: copies of the JAX package's ``GeneratorConfig`` and
``ExecutorConfig`` (``explainable_spatial_vqa_tpu/core/config.py``), field for
field, so one set of keyword arguments builds both packages' models."""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["GeneratorConfig", "ExecutorConfig"]


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
