"""The port's K1 (fused attention), K2 (fused encoder block) and K3 (the
batch-tiled block) on the CPU, where each wrapper runs its plain PyTorch
version, against the JAX Pallas kernels in interpret mode and the JAX XLA
paths, on the same numpy inputs."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.models.layers import EncoderBlock as JaxEncoderBlock
from explainable_spatial_vqa_tpu.ops import pallas_block as jax_block
from explainable_spatial_vqa_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention,
)
from explainable_spatial_vqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.models.layers import EncoderBlock
from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    fuse_encoder_params,
    fused_encoder_block,
    fused_encoder_block_plain,
    fused_encoder_block_tiled,
    fused_encoder_block_tiled_plain,
    pad_len,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its bf16 check; the script imports nothing at the top)

torch.set_num_threads(1)


def _key_mask(batch, length, seed):
    """Ragged key-padding mask: row b keeps its first length - r_b keys."""
    rng = np.random.RandomState(seed)
    keep = np.ones((batch, length), bool)
    for b in range(batch):
        keep[b, length - rng.randint(1, length // 2 + 1):] = False
    return keep


@pytest.mark.parametrize("length", [10, 16])
@pytest.mark.parametrize("masked", [False, True])
def test_k1_plain_matches_jax(length, masked):
    """fp32, atol 1e-5: the tolerance of tests/test_pallas_attention.py."""
    rng = np.random.RandomState(length)
    q, k, v = (rng.randn(2, length, 2, 8).astype(np.float32) for _ in range(3))
    mask = _key_mask(2, length, 1)[:, None, None, :] if masked else None
    jargs = [jnp.asarray(a) for a in (q, k, v)] + [None if mask is None else jnp.asarray(mask)]
    targs = [torch.from_numpy(a) for a in (q, k, v)] + [
        None if mask is None else torch.from_numpy(mask)]
    ref_kernel = np.asarray(jax_fused_attention(*jargs, interpret=True))
    ref_xla = np.asarray(jax_dot_product_attention(*jargs))
    for out in (fused_attention(*targs), dot_product_attention(*targs)):
        np.testing.assert_allclose(out.numpy(), ref_kernel, atol=1e-5)
        np.testing.assert_allclose(out.numpy(), ref_xla, atol=1e-5)


def test_k1_rejects_cross_attention():
    q = torch.zeros(1, 3, 1, 8)
    kv = torch.zeros(1, 5, 1, 8)
    with pytest.raises(ValueError, match="Lq == Lk"):
        fused_attention(q, kv, kv)


def _blocks(d_model, num_heads, length, batch, seed, norm="post"):
    """A linen EncoderBlock with random weights and the port's block with the
    same weights, plus a numpy input."""
    jblock = JaxEncoderBlock(d_model, num_heads, d_model * 4, dropout=0.0, norm=norm)
    x = np.random.RandomState(seed).randn(batch, length, d_model).astype(np.float32)
    variables = jblock.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    block = EncoderBlock(d_model, num_heads, d_model * 4, dropout=0.0, norm=norm, device="cpu")
    block.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    return jblock, variables, block.eval(), x


@pytest.mark.parametrize("masked", [False, True])
def test_k2_plain_matches_jax_kernel(masked):
    """fp32, atol 2e-5: the tolerance of tests/test_pallas_block.py:33."""
    jblock, variables, block, x = _blocks(128, 4, 16, 2, seed=0)
    mask = _key_mask(2, 16, 2) if masked else None
    ref = jax_block.fused_encoder_block(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        jax_block.fuse_encoder_params(variables["params"]), 4, interpret=True)
    out = fused_encoder_block(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
                              fuse_encoder_params(block), 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_k2_plain_matches_jax_kernel_bf16_weights(masked):
    """bf16 weights, fp32 activations.  Both sides round x, the attention
    output, x1 and the ReLU output to bf16 before each product and accumulate
    in fp32, so they differ only where an fp32 sum taken in another order lands
    on the other side of a bf16 rounding boundary.  One such flip moves one
    operand by a bf16 ulp (2^-8 ~ 4e-3 of itself) and, through the next
    product and the LayerNorm that couples a row, every output of that row by
    up to about that much: atol 1e-2 allows two or three flips in a row.  The
    median error stays at fp32 rounding (< 1e-6): the flips are rare."""
    jblock, variables, block, x = _blocks(128, 4, 16, 2, seed=3)
    mask = _key_mask(2, 16, 4) if masked else None
    ref = jax_block.fused_encoder_block(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        jax_block.fuse_encoder_params(variables["params"], dtype=jnp.bfloat16), 4,
        interpret=True)
    out = fused_encoder_block(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
                              fuse_encoder_params(block, dtype=torch.bfloat16), 4)
    err = np.abs(out.numpy() - np.asarray(ref))
    assert err.max() < 1e-2 and np.median(err) < 1e-6, (err.max(), np.median(err))


@pytest.mark.parametrize("norm", ["post", "pre"])
@pytest.mark.parametrize("length", [14, 16])
def test_encoder_block_matches_linen(length, norm):
    """The port's EncoderBlock in eval mode (post-LN routed to K2's plain
    version) against the linen block on its XLA path and on its fused Pallas
    path, which pads L=14 to 16 and masks the padded keys; the port does not
    pad.  Pre-LN takes neither fused path in either package."""
    jblock, variables, block, x = _blocks(128, 1, length, 3, seed=5, norm=norm)
    mask = np.ones((3, length), bool)
    mask[:, -3:] = False
    mask4 = mask[:, None, None, :]
    ref_xla = np.asarray(jblock.apply(variables, jnp.asarray(x), jnp.asarray(mask4)))
    jax_block.use_fused_encoder_block(True, interpret=True)
    try:
        ref_fused = np.asarray(jblock.apply(variables, jnp.asarray(x), jnp.asarray(mask4)))
    finally:
        jax_block.use_fused_encoder_block(False)
    out = block(torch.from_numpy(x), torch.from_numpy(mask4)).detach().numpy()
    np.testing.assert_allclose(out, ref_fused, atol=2e-5)
    np.testing.assert_allclose(out, ref_xla, atol=2e-5)
    # training mode takes the layer-by-layer path (no kernel); dropout 0
    train_out = block.train()(torch.from_numpy(x), torch.from_numpy(mask4)).detach().numpy()
    np.testing.assert_allclose(train_out, ref_xla, atol=2e-5)


def _tiled_mask(batch, length):
    """A distinct mask per sequence, as tests/test_pallas_block.py:50-53 builds
    it, so that each tile reads its own rows."""
    keep = np.ones((batch, length), bool)
    for b in range(batch):
        keep[b, length - 1 - b:] = False
    return keep


def _k3_pair(masked, batch_tile, ffn_chunks, dtype):
    """K3: JAX ``fused_encoder_block_tiled`` in interpret mode and the port's
    wrapper (its plain version on the CPU), weights in ``dtype``."""
    _jblock, variables, block, x = _blocks(128, 4, 16, 4, seed=1)
    mask = _tiled_mask(4, 16) if masked else None
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = jax_block.fused_encoder_block_tiled(
        jnp.asarray(x), None if mask is None else jnp.asarray(mask),
        jax_block.fuse_encoder_params(variables["params"], dtype=jdtype), 4,
        batch_tile=batch_tile, ffn_chunks=ffn_chunks, interpret=True)
    out = fused_encoder_block_tiled(
        torch.from_numpy(x), None if mask is None else torch.from_numpy(mask),
        fuse_encoder_params(block, dtype=dtype), 4, batch_tile=batch_tile, ffn_chunks=ffn_chunks)
    return out.numpy(), np.asarray(ref)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch_tile,ffn_chunks", [(2, 1), (4, 2)])
def test_k3_plain_matches_jax_kernel(masked, batch_tile, ffn_chunks):
    """fp32, atol 2e-5: the tolerance of tests/test_pallas_block.py:64."""
    out, ref = _k3_pair(masked, batch_tile, ffn_chunks, torch.float32)
    np.testing.assert_allclose(out, ref, atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("batch_tile,ffn_chunks", [(2, 1), (4, 2)])
def test_k3_plain_matches_jax_kernel_bf16_weights(masked, batch_tile, ffn_chunks):
    """bf16 weights, fp32 activations, with the limits of the bf16 K2 test
    above and for the same reason: both sides round the same values to bf16
    (x, q, k, v, the softmax weights, the attention output, x1, the ReLU
    output) and differ only where an fp32 sum in another order lands on the
    other side of a rounding."""
    out, ref = _k3_pair(masked, batch_tile, ffn_chunks, torch.bfloat16)
    err = np.abs(out - ref)
    assert err.max() < 1e-2 and np.median(err) < 1e-6, (err.max(), np.median(err))


def test_k3_and_k2_plain_versions_differ_in_bf16():
    """In bf16, K3's arithmetic (q, k, v rounded to bf16) and K2's (float32
    q, k, v) each fail the other's check in chip_smoke.py by the mean error,
    so neither kernel can pass for the other on the card; each passes
    against itself.  In float32 the two are the same arithmetic, up to K3's
    QKV sums, which are taken in float64 and rounded once."""
    _jblock, _variables, block, x = _blocks(128, 4, 16, 4, seed=6)
    mask = torch.from_numpy(_tiled_mask(4, 16))
    xb = torch.from_numpy(x).bfloat16()
    w = fuse_encoder_params(block, dtype=torch.bfloat16)
    k2 = fused_encoder_block_plain(xb, mask, w, 4)
    k3 = fused_encoder_block_tiled_plain(xb, mask, w, 4, batch_tile=2, ffn_chunks=2)
    for out, ref in ((k2, k3), (k3, k2)):
        stats = chip_smoke.bf16_agreement(torch, out, ref)
        assert not chip_smoke.bf16_ok(stats), stats
        assert stats["mean_ulps"] > chip_smoke.MEAN_ULPS, stats
    assert chip_smoke.bf16_ok(chip_smoke.bf16_agreement(torch, k3, k3))
    w32 = fuse_encoder_params(block)
    torch.testing.assert_close(
        fused_encoder_block_tiled_plain(torch.from_numpy(x), mask, w32, 4, 2, 2),
        fused_encoder_block_plain(torch.from_numpy(x), mask, w32, 4), rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape,batch_tile,ffn_chunks,match", [
    ((3, 16, 128), 2, 1, "batch_tile"),  # batch % batch_tile
    ((4, 16, 128), 2, 3, "ffn_chunks"),  # (batch_tile * L) % ffn_chunks
    ((4, 12, 128), 2, 1, "pad L"),  # L % 8
    ((4, 16, 64), 2, 1, "pad L"),  # d % 128
])
def test_k3_contract_errors(shape, batch_tile, ffn_chunks, match):
    """The port raises where the JAX wrapper asserts
    (ops/pallas_block.py:286-289), and launches nothing."""
    batch, length, d_model = shape
    block = EncoderBlock(d_model, 4, 2 * d_model, dropout=0.0, device="cpu")
    with pytest.raises(AssertionError):  # asserted on the shapes, before any weight is read
        jax_block.fused_encoder_block_tiled(
            jnp.zeros(shape), None, tuple(jnp.zeros(1) for _ in range(16)), 4,
            batch_tile=batch_tile, ffn_chunks=ffn_chunks, interpret=True)
    before = fused_encoder_block_tiled.launches
    with pytest.raises(ValueError, match=match):
        fused_encoder_block_tiled(torch.zeros(shape), None, fuse_encoder_params(block), 4,
                                  batch_tile=batch_tile, ffn_chunks=ffn_chunks)
    assert fused_encoder_block_tiled.launches == before


def test_pad_len():
    assert [pad_len(n) for n in (210, 216, 1, 14)] == [
        jax_block.pad_len(n) for n in (210, 216, 1, 14)] == [216, 216, 8, 16]
