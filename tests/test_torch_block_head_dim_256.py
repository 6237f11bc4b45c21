"""K2 and K3 at head dim 256, on the CPU against the JAX package.

JAX's ``EncoderBlock._fused_eligible``
(``explainable_spatial_vqa_tpu/models/layers.py:244-262``) sends a block to
its fused kernel where d_model and the head dim are multiples of 128; the
port's K2 and K3 run their attention at head dims 128 and 256
(``ops.fused_block.BLOCK_HEAD_DIMS``; 256 on ``csrc/attention_padded.cuh``'s
kernels).  Here, on the same numpy inputs and JAX's Flax weights carried over
by ``convert.flax_to_state_dict``:

- K2's and K3's plain versions (the wrappers' path for a CPU tensor) against
  JAX's ``fused_encoder_block`` and ``fused_encoder_block_tiled`` in interpret
  mode at d_model 512 with 2 heads (head dim 256), masked and not: float32
  weights within 2e-5 (``tests/test_pallas_block.py``'s tolerance), bf16
  weights within the limits of ``tests/test_torch_ops.py``'s bf16 block
  tests (a max error under 1e-2 and a median under 1e-6: rare roundings
  flipped by a float32 sum taken in another order);
- the gate follows JAX's rule at every d_model of 1 to 8 heads up to 1024;
- routing and the wrappers agree on length: ``EncoderBlock`` routes to K2
  exactly where ``_check_launch`` (which reads no device memory) takes the
  block, at 1025 and ``MAX_LEN`` keys and not one key more.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.models.layers import EncoderBlock as JaxEncoderBlock
from explainable_spatial_vqa_tpu.ops import pallas_block as jax_block
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.models import layers
from explainable_spatial_vqa_tpu_torch.models.layers import EncoderBlock
from explainable_spatial_vqa_tpu_torch.ops import fused_block
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import MAX_LEN
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    BLOCK_HEAD_DIMS,
    block_head_dim_built,
    block_shape_built,
    fuse_encoder_params,
    fused_encoder_block,
    fused_encoder_block_tiled,
    split_block_weights,
)

torch.set_num_threads(1)


def _blocks(d_model, num_heads, length, batch, seed):
    """A linen EncoderBlock with random weights and the port's block with the
    same weights, plus a numpy input."""
    jblock = JaxEncoderBlock(d_model, num_heads, d_model * 4, dropout=0.0)
    x = np.random.RandomState(seed).randn(batch, length, d_model).astype(np.float32)
    variables = jblock.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    block = EncoderBlock(d_model, num_heads, d_model * 4, dropout=0.0, device="cpu")
    block.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    return variables, block.eval(), x


def _mask(batch, length):
    """A distinct ragged key mask per sequence."""
    keep = np.ones((batch, length), bool)
    for b in range(batch):
        keep[b, length - 1 - 2 * b:] = False
    return keep


def _check(out, ref, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(out, ref, atol=2e-5)
    else:
        err = np.abs(out - ref)
        assert err.max() < 1e-2 and np.median(err) < 1e-6, (err.max(), np.median(err))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_plain_matches_jax_kernel_at_head_dim_256(masked, dtype):
    """d_model 512, 2 heads, B = 2, L = 16."""
    variables, block, x = _blocks(512, 2, 16, 2, seed=7)
    mask = _mask(2, 16) if masked else None
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_block.fused_encoder_block(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        jax_block.fuse_encoder_params(variables["params"], dtype=jdtype), 2, interpret=True)
    out = fused_encoder_block(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
                              fuse_encoder_params(block, dtype=dtype), 2)
    _check(out.numpy(), np.asarray(ref), dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch_tile,ffn_chunks", [(2, 1), (4, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_plain_matches_jax_kernel_at_head_dim_256(masked, batch_tile, ffn_chunks, dtype):
    """d_model 512, 2 heads, B = 4, L = 16, both tilings of
    ``tests/test_torch_ops.py``'s K3 tests."""
    variables, block, x = _blocks(512, 2, 16, 4, seed=8)
    mask = _mask(4, 16) if masked else None
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_block.fused_encoder_block_tiled(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        jax_block.fuse_encoder_params(variables["params"], dtype=jdtype), 2,
        batch_tile=batch_tile, ffn_chunks=ffn_chunks, interpret=True)
    out = fused_encoder_block_tiled(
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
        fuse_encoder_params(block, dtype=dtype), 2, batch_tile=batch_tile, ffn_chunks=ffn_chunks)
    _check(out.numpy(), np.asarray(ref), dtype)


def test_gate_follows_jax_rule():
    """``block_head_dim_built`` is JAX's rule (d_model and the head dim
    multiples of 128) at every d_model of 1 to 8 heads up to 2048 whose head
    dim is built (128, 256, 384 or 512); JAX's rule also holds at 640 and
    past it (d_model 1280 at 2 heads, 2560 at 4), which K2 does not take."""
    assert BLOCK_HEAD_DIMS == (128, 256, 384, 512)
    for heads in range(1, 9):
        for d_model in range(heads, 2049, heads):
            jax_rule = d_model % 128 == 0 and (d_model // heads) % 128 == 0
            built = block_head_dim_built(d_model, heads)
            assert built == (jax_rule and d_model // heads in BLOCK_HEAD_DIMS), (d_model, heads)
    assert block_head_dim_built(512, 2) and block_head_dim_built(1024, 4)
    assert block_head_dim_built(768, 2) and block_head_dim_built(1024, 2)
    assert block_head_dim_built(1536, 4) and block_head_dim_built(2048, 4)
    assert not block_head_dim_built(1280, 2) and not block_head_dim_built(2560, 4)


@pytest.mark.parametrize("length", [1025, MAX_LEN, MAX_LEN + 1])
def test_routing_and_wrappers_agree_on_length(monkeypatch, length):
    """An ``EncoderBlock`` at d_model 256, one head of 256, in eval mode under
    no_grad: ``_fused_eligible`` routes it to K2 exactly where the wrappers'
    ``_check_launch`` takes it (float32 and bf16 weights), and K2 (its plain
    version here) is called just then."""
    block = EncoderBlock(256, 1, 512, dropout=0.0, device="cpu").eval()
    calls = []
    monkeypatch.setattr(layers, "fused_encoder_block",
                        lambda x, *a, **k: calls.append(x.shape) or fused_block
                        .fused_encoder_block(x, *a, **k))
    x = torch.zeros(1, length, 256)
    with torch.no_grad():
        routed = block._fused_eligible(x, None)
        if length <= 1025:
            block(x)
    for dtype in (torch.float32, torch.bfloat16):
        weights = fuse_encoder_params(block, dtype=dtype)
        try:
            fused_block._check_launch("k2", x.to(dtype), weights, 1, split_block_weights(weights))
            takes = True
        except ValueError as err:
            assert "length" in str(err)
            takes = False
        assert takes == routed == block_shape_built(1, length) == (length <= MAX_LEN), dtype
    assert calls == ([(1, length, 256)] if length <= 1025 else [])
