"""The port routes to K2 at head dims 128 and 256 with d_model a multiple of
128, as the JAX package routes to its fused block only at MXU-aligned widths
(``explainable_spatial_vqa_tpu/models/layers.py``, ``_fused_eligible``), and
to K1 at every head dim from 1 to 256, as JAX's attention dispatch takes any
(``explainable_spatial_vqa_tpu/ops/attention.py:51-59``).

Spies stand in for the ``fused_encoder_block`` and ``fused_attention`` that
``models/layers.py`` calls: each records its call and returns the wrapper's
own result (the plain version, on the CPU).  An eval forward of the
protocol's executor (4 heads) at d_model 96 and 192, head dims 24 and 48,
calls K1 once per fusion layer (the plain block's self-attention) and once
per box-decoder layer, and K2 never; at 512, head dim 128, every fusion
layer calls K2 and the box decoder's query self-attention calls K1.
"""

import dataclasses

import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu_torch.models import layers
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import HEAD_DIMS, head_dim_built
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    BLOCK_HEAD_DIMS,
    block_head_dim_built,
)
from explainable_spatial_vqa_tpu_torch.train.synthetic_protocol import (
    make_protocol_executor_config,
)

torch.set_num_threads(1)

VOCABS = {"function": {f"f{i}": i for i in range(6)}, "other": {f"o{i}": i for i in range(5)}}


@pytest.fixture
def spies(monkeypatch):
    calls = {"block": [], "attention": []}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name].append(tuple(args[0].shape))
            return fn(*args, **kwargs)

        return wrapped

    monkeypatch.setattr(layers, "fused_encoder_block", spy("block", layers.fused_encoder_block))
    monkeypatch.setattr(layers, "fused_attention", spy("attention", layers.fused_attention))
    return calls


def _eval_forward(d_model: int, train: bool = False):
    cfg = dataclasses.replace(
        make_protocol_executor_config(VOCABS, d_model=d_model, encoder_layers=2, box_roi=True),
        num_image_tokens=4, image_feature_dim=8)
    model = init_parameters(ProgramExecutor(cfg, device="cpu"), 0).train(train)
    rng = np.random.RandomState(d_model)
    b, s = 3, cfg.max_input_boxes
    corner = rng.uniform(0, 0.5, (b, s, 2)).astype(np.float32)
    boxes = np.concatenate([corner, corner + 0.4], -1)
    with torch.set_grad_enabled(train):
        out = model(torch.from_numpy(rng.randn(b, 4, 8).astype(np.float32)),
                    torch.from_numpy(boxes), torch.from_numpy(rng.rand(b, s) < 0.6),
                    torch.from_numpy(rng.randint(1, 6, (b, 3))), torch.ones(b, 3, dtype=torch.bool))
    assert all(torch.isfinite(v).all() for v in out.values())
    return cfg


@pytest.mark.parametrize("d_model", [96, 192])
def test_unbuilt_head_dims_take_the_plain_path(spies, d_model):
    """Head dims K2 is not built for take the plain block, whose
    self-attention, like the box decoder's, runs on K1: d 96 and d 192 run
    K1 and never K2."""
    cfg = _eval_forward(d_model)
    head_dim = d_model // cfg.num_heads
    assert head_dim not in BLOCK_HEAD_DIMS and head_dim in HEAD_DIMS
    assert spies["block"] == []
    # (B, L, H, D): the fusion layers at L = CLS + 4 image + 8 box + 3 text,
    # then the box decoder's queries
    assert spies["attention"] == ([(3, 16, 4, head_dim)] * cfg.encoder_layers
                                  + [(3, cfg.num_queries, 4, head_dim)] * cfg.box_decoder_layers)


def test_head_dim_128_routes_to_k2_and_k1(spies):
    cfg = _eval_forward(512)
    # every fusion layer on K2 (L = CLS + 4 image + 8 box + 3 text), and the
    # box decoder's query self-attention on K1, (B, Q, H, D)
    assert spies["block"] == [(3, 16, 512)] * cfg.encoder_layers
    assert spies["attention"] == [(3, cfg.num_queries, 4, 128)] * cfg.box_decoder_layers


def test_training_forward_never_routes(spies):
    _eval_forward(512, train=True)
    assert spies == {"block": [], "attention": []}


@pytest.mark.parametrize("d_model, heads, built", [
    (512, 4, True), (256, 2, True), (128, 1, True), (96, 4, False), (192, 4, False),
    (384, 4, False), (512, 2, True), (500, 4, False), (130, 4, False), (1024, 4, True),
    (768, 2, True), (640, 5, True), (1536, 4, True), (2048, 4, True), (2560, 4, False)])
def test_head_dim_built(d_model, heads, built):
    """K2's head dims: 128, 256, 384 and 512 (d_model 512 at 2 heads, 1024,
    1536 and 2048 at 4, 768 at 2), with d_model a multiple of 128; not 640
    (2560 at 4 heads), nor 96 or 48."""
    assert block_head_dim_built(d_model, heads) is built


@pytest.mark.parametrize("d_model, heads, built", [
    (96, 4, True), (192, 4, True), (256, 4, True), (512, 4, True), (384, 4, True),
    (512, 2, True), (130, 4, False), (100, 4, True), (544, 4, True), (16, 4, True),
    (1028, 4, True), (100, 3, False), (1100, 4, True), (2048, 4, True), (2052, 4, False)])
def test_k1_head_dim_built(d_model, heads, built):
    """K1's head dims: every one from 1 to 512, so 96 (384/4), 256 (512/2),
    25 (100/4), 136 (544/4), 4 (16/4), 257 (1028/4), 275 (1100/4) and 512
    (2048/4) are built; 513 (2052/4) is not, nor a width that does not split
    into whole heads."""
    assert head_dim_built(d_model, heads) is built
