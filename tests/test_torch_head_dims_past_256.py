"""K1, K2 and K3 at head dims 257-512, on the CPU against the JAX package.

JAX's dispatch sends self-attention to its kernel at any head dim
(``explainable_spatial_vqa_tpu/ops/attention.py:51-59``), and its gate sends
a block to its fused kernel wherever d_model and the head dim are multiples
of 128 (``models/layers.py:244-262``).  The port's K1 takes every head dim up
to ``MAX_HEAD_DIM`` (512, ``csrc/attention.cuh``'s ``kAttnMaxHeadDim``), past
256 on the deep kernels of ``csrc/attention_padded.cuh``; K2's and K3's
attention takes the multiples of 128 up to it (384 and 512 on the same deep
kernels).  Here, on the same numpy inputs:

- K1's plain version (the wrapper's path for a CPU tensor) against JAX's
  Pallas kernel in interpret mode at head dims 257, 275, 384, 400 and 512
  and lengths 8 and 10 (the box decoders), 17, 64 and 257, masked and not:
  float32 within 1e-5 (``tests/test_pallas_attention.py``'s tolerance), bf16
  within ``chip_smoke.attention_agreement`` of the float64 reference
  (``tests/test_torch_ops.py``'s bf16 attention check), the port's and
  JAX's kernel's outputs both;
- K2's and K3's plain versions against JAX's ``fused_encoder_block`` and
  ``fused_encoder_block_tiled`` in interpret mode at head dims 384 and 512
  (one head at d_model 384 and 512), masked and not: float32 weights within
  2e-5, bf16 weights within the limits of
  ``tests/test_torch_block_head_dim_256.py``;
- a one-layer executor at d_model 512 with one head, eval forward in
  float32, JAX with its fused block in interpret mode against the port on
  weights carried over by ``convert.flax_to_state_dict``: the routing,
  token and box-confidence argmaxes equal, K2 on the fusion layer and K1 on
  the box decoder;
- routing and the wrappers agree at 512 and 513 (K2: at 512 and 640), and
  the ceiling is the C source's.
"""

import dataclasses
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.models.executor import ProgramExecutor as JaxExecutor
from explainable_spatial_vqa_tpu.models.layers import EncoderBlock as JaxEncoderBlock
from explainable_spatial_vqa_tpu.ops import pallas_block as jax_block
from explainable_spatial_vqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from explainable_spatial_vqa_tpu.train import synthetic_protocol as jax_protocol
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.models import layers
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.models.layers import EncoderBlock, MultiHeadAttention
from explainable_spatial_vqa_tpu_torch.ops import _build, fused_block
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
    HEAD_DIMS,
    MAX_HEAD_DIM,
    PADDED_DEPTHS,
    check_attention,
    fused_attention,
    head_dim_built,
    padded_depth,
)
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    BLOCK_HEAD_DIMS,
    block_head_dim_built,
    fuse_encoder_params,
    fused_encoder_block,
    fused_encoder_block_tiled,
    split_block_weights,
)
from explainable_spatial_vqa_tpu_torch.train import synthetic_protocol

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its bf16 attention check; the script imports nothing at the top)

torch.set_num_threads(1)

# a head dim at each deep depth's edges: 257 and 275 (depth 288), 384 (384),
# 400 (448), 512 (512)
DEEP_HEAD_DIMS = (257, 275, 384, 400, 512)
VOCABS = {"function": {f"f{i}": i for i in range(6)}, "other": {f"o{i}": i for i in range(5)}}


def _key_mask(batch, length, seed):
    """Ragged key-padding mask: row b keeps its first length - r_b keys."""
    rng = np.random.RandomState(seed)
    keep = np.ones((batch, length), bool)
    for b in range(batch):
        keep[b, length - rng.randint(1, length // 2 + 1):] = False
    return keep


@pytest.mark.parametrize("head_dim", DEEP_HEAD_DIMS)
@pytest.mark.parametrize("length", [8, 10, 17, 64, 257])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_k1_plain_matches_jax_past_256(head_dim, length, masked, dtype):
    """B = 1, H = 2; the scale is 1/sqrt(head dim).  float32: atol 1e-5
    against JAX's kernel in interpret mode.  bf16: the port's plain version
    and JAX's kernel each within ``chip_smoke.attention_agreement``."""
    assert head_dim_built(2 * head_dim, 2)
    rng = np.random.RandomState(head_dim * 3 + length)
    q, k, v = (rng.randn(1, length, 2, head_dim).astype(np.float32) for _ in range(3))
    mask = _key_mask(1, length, head_dim)[:, None, None, :] if masked else None
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "fp32" else (jnp.bfloat16, torch.bfloat16)
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)] + [
        None if mask is None else jnp.asarray(mask)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, k, v)] + [
        None if mask is None else torch.from_numpy(mask)]
    out = fused_attention(*targs)
    ref = jax_fused_attention(*jargs, interpret=True)
    if dtype == "fp32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
        return
    jax_out = torch.from_numpy(np.array(ref.astype(jnp.float32))).bfloat16()
    for name, got in (("port", out), ("jax", jax_out)):
        stats = chip_smoke.attention_agreement(torch, got, *targs)
        assert chip_smoke.bf16_ok(stats), (name, stats)


def _blocks(d_model, length, batch, seed):
    """A linen EncoderBlock of one head with random weights and the port's
    block with the same weights, plus a numpy input."""
    jblock = JaxEncoderBlock(d_model, 1, d_model * 4, dropout=0.0)
    x = np.random.RandomState(seed).randn(batch, length, d_model).astype(np.float32)
    variables = jblock.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    block = EncoderBlock(d_model, 1, d_model * 4, dropout=0.0, device="cpu")
    block.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    return variables, block.eval(), x


def _check(out, ref, dtype):
    """``tests/test_torch_block_head_dim_256.py``'s limits: float32 within
    2e-5; bf16 a max error under 1e-2 and a median under 1e-6 (rare roundings
    flipped by a float32 sum taken in another order)."""
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, atol=2e-5)
    else:
        err = np.abs(out - ref)
        assert err.max() < 1e-2 and np.median(err) < 1e-6, (err.max(), np.median(err))


@pytest.mark.parametrize("d_model", [384, 512])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiled", [False, True])
def test_block_plain_matches_jax_kernel_past_256(d_model, masked, dtype, tiled):
    """K2 (B = 2) and K3 (B = 4, batch_tile 2, ffn_chunks 2) at one head of
    d_model, L = 16."""
    batch = 4 if tiled else 2
    variables, block, x = _blocks(d_model, 16, batch, seed=d_model + tiled)
    assert block_head_dim_built(d_model, 1)
    mask = _key_mask(batch, 16, d_model) if masked else None
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jweights = jax_block.fuse_encoder_params(variables["params"], dtype=jdtype)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    weights = fuse_encoder_params(block, dtype=dtype)
    if tiled:
        ref = jax_block.fused_encoder_block_tiled(jnp.asarray(x), jmask, jweights, 1,
                                                  batch_tile=2, ffn_chunks=2, interpret=True)
        out = fused_encoder_block_tiled(torch.from_numpy(x), tmask, weights, 1, batch_tile=2,
                                        ffn_chunks=2)
    else:
        ref = jax_block.fused_encoder_block(jnp.asarray(x), jmask, jweights, 1, interpret=True)
        out = fused_encoder_block(torch.from_numpy(x), tmask, weights, 1)
    _check(out.numpy(), np.asarray(ref), dtype)


@pytest.fixture
def spies(monkeypatch):
    """The (B, L, H, D) of each call of K1 and the (B, L, d) of each call of
    K2 from ``models/layers.py``, each passed on to the wrapper."""
    calls = {"block": [], "attention": []}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name].append(tuple(args[0].shape))
            return fn(*args, **kwargs)

        return wrapped

    monkeypatch.setattr(layers, "fused_encoder_block", spy("block", layers.fused_encoder_block))
    monkeypatch.setattr(layers, "fused_attention", spy("attention", layers.fused_attention))
    return calls


def test_executor_matches_jax_fused_block_at_head_dim_512(spies, monkeypatch):
    """The protocol's executor cut to one fusion layer (1 box-decoder layer,
    8 queries, 4 image tokens of 8 features) at d_model 512 with one head,
    float32 eval forward, JAX's fused block in interpret mode: every output
    within 1e-4 of JAX's (``tests/test_torch_layers.py``'s executor
    tolerance), the routing, token and box-confidence argmaxes equal; K2 on
    the fusion layer (L = CLS + 4 image + 8 box + 3 text), K1 on the box
    decoder's 8 queries."""
    narrow = dict(num_image_tokens=4, image_feature_dim=8, num_heads=1)
    jcfg = dataclasses.replace(jax_protocol.make_protocol_executor_config(
        VOCABS, d_model=512, encoder_layers=1, box_roi=True), **narrow)
    cfg = dataclasses.replace(synthetic_protocol.make_protocol_executor_config(
        VOCABS, d_model=512, encoder_layers=1, box_roi=True), **narrow)
    rng = np.random.RandomState(512)
    b, s = 3, cfg.max_input_boxes
    corner = rng.uniform(0, 0.5, (b, s, 2)).astype(np.float32)
    inputs = (rng.randn(b, 4, 8).astype(np.float32),
              np.concatenate([corner, corner + 0.4], -1).astype(np.float32),
              rng.rand(b, s) < 0.6, rng.randint(1, 6, (b, 3)).astype(np.int32),
              np.ones((b, 3), bool))
    jmodel = JaxExecutor(jcfg)
    variables = jmodel.init(jax.random.PRNGKey(5), *map(jnp.asarray, inputs))
    calls, block_fn = [], jax_block.fused_encoder_block
    monkeypatch.setattr(jax_block, "fused_encoder_block",
                        lambda x, *a, **k: calls.append(x.shape) or block_fn(x, *a, **k))
    jax_block.use_fused_encoder_block(True, interpret=True)
    try:
        ref = jmodel.apply(variables, *map(jnp.asarray, inputs))
    finally:
        jax_block.use_fused_encoder_block(False)
    fusion = 1 + 4 + 8 + 3
    assert calls == [(b, fusion, 512)]  # JAX ran its fused block on the fusion layer
    model = ProgramExecutor(cfg, device="cpu").eval()
    model.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in inputs))
    for key in ("routing_logits", "token_logits", "pred_boxes", "pred_conf"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=1e-4,
                                   err_msg=key)
    for key in ("routing_logits", "token_logits", "pred_conf"):
        np.testing.assert_array_equal(out[key].numpy().argmax(-1),
                                      np.asarray(ref[key]).argmax(-1), err_msg=key)
    assert spies["block"] == [(b, fusion, 512)] * cfg.encoder_layers
    assert spies["attention"] == [(b, cfg.num_queries, 1, 512)] * cfg.box_decoder_layers


def test_ceiling_is_the_c_sources():
    """``MAX_HEAD_DIM`` is ``csrc/attention.cuh``'s ``kAttnMaxHeadDim``, and
    the head dims, the padded depths and K2's head dims all end at it."""
    source = (_build.CSRC_DIR / "attention.cuh").read_text()
    found = re.search(r"constexpr int kAttnMaxHeadDim = (\d+);", source)
    assert int(found.group(1)) == MAX_HEAD_DIM == 512
    assert HEAD_DIMS == tuple(range(1, MAX_HEAD_DIM + 1))
    assert PADDED_DEPTHS[-1] == padded_depth(MAX_HEAD_DIM) == MAX_HEAD_DIM
    assert BLOCK_HEAD_DIMS == tuple(range(128, MAX_HEAD_DIM + 1, 128))


@pytest.mark.parametrize("head_dim", range(257, 513))
def test_deep_depths_hold_each_head_dim(head_dim):
    """Past 256 a row group's G = ceil(D / 128) warps each take a slice of
    at most 128 columns, a multiple of 16 within 16 of D / G: the depth is
    one of ``PADDED_DEPTHS``."""
    depth, slices = padded_depth(head_dim), -(-head_dim // 128)
    assert depth in PADDED_DEPTHS and depth % slices == 0
    part = depth // slices
    assert part % 16 == 0 and part <= 128 and part - 16 < -(-head_dim // slices) <= part


@pytest.mark.parametrize("head_dim", [512, 513])
def test_k1_routing_and_wrapper_agree_at_the_ceiling(spies, head_dim):
    """``MultiHeadAttention``'s self-attention in eval mode under no_grad at
    one head of ``head_dim`` routes to K1 exactly where the wrapper's
    contract takes the call: 512 both, 513 neither (the plain path runs it)."""
    attn = MultiHeadAttention(head_dim, 1, device="cpu").eval()
    x = torch.from_numpy(np.random.RandomState(head_dim).randn(1, 10, head_dim)
                         .astype(np.float32))
    with torch.no_grad():
        out = attn(x, x)
    assert out.shape == (1, 10, head_dim) and torch.isfinite(out).all()
    q = torch.zeros(1, 10, 1, head_dim)
    try:
        check_attention(q, q, q)
        takes = True
    except ValueError as err:
        assert "head dim" in str(err)
        takes = False
    assert takes == head_dim_built(head_dim, 1) == (head_dim <= MAX_HEAD_DIM)
    assert spies["attention"] == ([(1, 10, 1, head_dim)] if takes else [])


@pytest.mark.parametrize("head_dim", [512, 640])
def test_block_routing_and_wrappers_agree_at_the_ceiling(spies, head_dim):
    """An ``EncoderBlock`` of one head in eval mode under no_grad routes to
    K2 exactly where the wrappers' ``_check_launch`` takes it (float32 and
    bf16 weights): at 512, the widest head dim K2 takes, and not at 640, the
    next that JAX's rule (a multiple of 128) sends its fused block."""
    block = EncoderBlock(head_dim, 1, 2 * head_dim, dropout=0.0, device="cpu").eval()
    x = torch.from_numpy(np.random.RandomState(head_dim).randn(1, 8, head_dim)
                         .astype(np.float32))
    with torch.no_grad():
        routed = block._fused_eligible(x, None)
        block(x)
    for dtype in (torch.float32, torch.bfloat16):
        weights = fuse_encoder_params(block, dtype=dtype)
        try:
            fused_block._check_launch("k2", x.to(dtype), weights, 1, split_block_weights(weights))
            takes = True
        except ValueError as err:
            assert "d/H" in str(err)
            takes = False
        assert takes == routed == (head_dim <= MAX_HEAD_DIM), dtype
    assert spies["block"] == ([(1, 8, head_dim)] if routed else [])
