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
from explainable_spatial_vqa_tpu_torch.ops.block_gemm import block_gemm, block_gemm_plain
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
    HEAD_DIMS,
    MAX_LEN,
    check_attention,
    fused_attention,
)
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    block_scratch,
    fuse_encoder_params,
    fused_encoder_block,
    fused_encoder_block_plain,
    fused_encoder_block_tiled,
    fused_encoder_block_tiled_plain,
    pad_len,
    split_tf32,
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


@pytest.mark.parametrize("length", [10, 16, 210])
@pytest.mark.parametrize("masked", [False, True])
def test_k1_plain_matches_jax(length, masked):
    """fp32, atol 1e-5: the tolerance of tests/test_pallas_attention.py.  L=210
    is the fusion encoder's length, where the kernel holds a whole row of
    scores in registers before it normalises them."""
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


def _gemm_inputs(m, n, k, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32), (rng.randn(n, k) / np.sqrt(k)).astype(np.float32),
            (0.02 * rng.randn(n)).astype(np.float32))


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape", [(37, 48, 64), (130, 136, 72)])
def test_block_gemm_plain_matches_jax(w_dtype, relu, shape):
    """The block GEMM's plain version (the wrapper on the CPU) against the TPU
    kernel's product, jnp.dot(a.astype(w_dtype), w, preferred_element_type=
    float32) + b with ReLU where asked (ops/pallas_block.py:126, :154-156);
    the wrapper takes a in the weights' type (bf16 weights need a bf16 a).
    atol 1e-5: float32 sums of at most 72 products, in another order (bf16
    products are exact in float32).  A bf16 output is the float32 one rounded."""
    a, w, b = _gemm_inputs(*shape, seed=sum(shape))
    jdt = jnp.bfloat16 if w_dtype == torch.bfloat16 else jnp.float32
    ref = jnp.dot(jnp.asarray(a).astype(jdt), jnp.asarray(w).astype(jdt).T,
                  preferred_element_type=jnp.float32) + jnp.asarray(b)
    ref = np.asarray(jnp.maximum(ref, 0.0) if relu else ref)
    ta, tw = (torch.from_numpy(t).to(w_dtype) for t in (a, w))
    tb = torch.from_numpy(b)
    out = block_gemm(ta, tw, tb, relu)
    assert out.dtype == torch.float32 and out.shape == (shape[0], shape[1])
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    torch.testing.assert_close(block_gemm(ta, tw, tb, relu, torch.bfloat16), out.bfloat16(),
                               rtol=0, atol=0)
    assert block_gemm.launches == 0  # the CPU runs the plain version


def _misaligned(shape, dtype):
    """A contiguous tensor whose data starts 2 bytes past a 16-byte boundary."""
    flat = torch.zeros(int(np.prod(shape)) + 8, dtype=dtype)
    return flat[1:1 + int(np.prod(shape))].view(shape)


@pytest.mark.parametrize("case,match", [
    ("meta", "device"),
    ("mixed_device", "device"),
    ("float16", "one of"),
    ("float32_a_bf16_w", "a must be bf16"),
    ("bias_float64", "bias float32"),
    ("k_mismatch", "shapes"),
    ("bias_shape", "shapes"),
    ("three_d", "shapes"),
    ("not_contiguous", "contiguous"),
    ("misaligned", "16-byte"),
    ("k_not_multiple_of_8", "multiples of 8"),
    ("n_not_multiple_of_8", "multiples of 8"),
    ("compensated_float32_w", "compensated"),
    ("compensated_relu", "compensated"),
    ("bf16_a_float32_w", "a must be float32"),
    ("float32_misaligned", "16-byte"),
    ("float32_k_not_multiple_of_4", "multiples of 4"),
    ("float32_n_not_multiple_of_4", "multiples of 4"),
    ("split_bf16_w", "split"),
    ("split_shape", "split"),
])
def test_block_gemm_contract_errors(case, match):
    """The wrapper raises before any launch on operands the kernel does not
    take: device, type, shape, contiguity, TMA's alignment rules (bf16 and
    float32), a split only beside float32 weights and of their (2N, K)
    shape, and the compensated product's bf16 weights without ReLU."""
    bf = torch.bfloat16
    a, w, b = torch.zeros(32, 64, dtype=bf), torch.zeros(48, 64, dtype=bf), torch.zeros(48)
    out_dtype = torch.float32
    options = {}
    if case == "meta":
        a, w, b = (t.to("meta") for t in (a, w, b))
    elif case == "mixed_device":
        a = a.to("meta")
    elif case == "float16":
        a = a.half()
    elif case == "float32_a_bf16_w":
        a = a.float()
    elif case == "bias_float64":
        b = b.double()
    elif case == "k_mismatch":
        a = torch.zeros(32, 72, dtype=bf)
    elif case == "bias_shape":
        b = torch.zeros(40)
    elif case == "three_d":
        a = torch.zeros(2, 16, 64, dtype=bf)
    elif case == "not_contiguous":
        a = torch.zeros(64, 32, dtype=bf).t()
    elif case == "misaligned":
        a = _misaligned((32, 64), bf)
    elif case == "k_not_multiple_of_8":
        a, w = torch.zeros(32, 60, dtype=bf), torch.zeros(48, 60, dtype=bf)
    elif case == "n_not_multiple_of_8":
        w, b = torch.zeros(44, 64, dtype=bf), torch.zeros(44)
    elif case == "compensated_float32_w":
        a, w = a.float(), w.float()
        options = dict(compensated=True)
    elif case == "compensated_relu":
        options = dict(compensated=True, relu=True)
    elif case == "bf16_a_float32_w":
        w = w.float()
    elif case == "float32_misaligned":
        a, w = _misaligned((32, 64), torch.float32), w.float()
    elif case == "float32_k_not_multiple_of_4":
        a, w = torch.zeros(32, 62), torch.zeros(48, 62)
    elif case == "float32_n_not_multiple_of_4":
        a, w, b = a.float(), torch.zeros(46, 64), torch.zeros(46)
    elif case == "split_bf16_w":
        options = dict(split=torch.zeros(96, 64))
    elif case == "split_shape":
        a, w = a.float(), w.float()
        options = dict(split=torch.zeros(48, 64))
    before = block_gemm.launches
    with pytest.raises(ValueError, match=match):
        block_gemm(a, w, b, out_dtype=out_dtype, **options)
    assert block_gemm.launches == before


@pytest.mark.parametrize("shape", [(37, 48, 64), (130, 136, 72)])
def test_block_gemm_compensated_is_the_rounded_exact_sum(shape):
    """compensated=True is K3's QKV product: the float32 value of the exact
    sum (float64 here: bf16 products and their sums are exact in it), plus
    bias, as K3's plain version takes it; its bf16 output is that rounded."""
    a, w, b = _gemm_inputs(*shape, seed=sum(shape))
    ta, tw = (torch.from_numpy(t).bfloat16() for t in (a, w))
    exact = (ta.double().numpy() @ tw.double().numpy().T).astype(np.float32) + b
    out = block_gemm(ta, tw, torch.from_numpy(b), compensated=True)
    np.testing.assert_array_equal(out.numpy(), exact)
    torch.testing.assert_close(
        block_gemm(ta, tw, torch.from_numpy(b), out_dtype=torch.bfloat16, compensated=True),
        out.bfloat16(), rtol=0, atol=0)
    assert block_gemm.launches == 0


def test_block_gemm_float32_weights_take_any_alignment():
    """Float32 weights take TMA's float32 rules, not bf16's: any M, and K
    and N multiples of 4 (16 bytes), where bf16 needs multiples of 8; a
    given split gives the product of the weights it splits."""
    a = torch.arange(60, dtype=torch.float32).view(5, 12)
    w = torch.ones(20, 12)
    out = block_gemm(a, w, torch.zeros(20))
    torch.testing.assert_close(out, a.sum(1, keepdim=True).expand(5, 20))
    torch.testing.assert_close(block_gemm(a, w, torch.zeros(20), split=split_tf32(w)), out)
    with pytest.raises(ValueError, match="multiples of 8"):
        block_gemm(a.bfloat16(), w.bfloat16(), torch.zeros(20))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_limits_accept_what_they_did(dtype):
    """MAX_LEN and HEAD_DIMS did not shrink: the kernel's checks take 4096
    keys at every head dim from 1 to 512 and refuse one key more, a head dim
    past 512 (513, 1024), and q/k/v at a head dim with kernels of its own
    (128) that do not start on a 16-byte boundary (cp.async copies 16
    bytes)."""
    assert MAX_LEN == 4096 and set(HEAD_DIMS) >= {24, 48, 64, 128}
    assert HEAD_DIMS == tuple(range(1, 513))
    for head_dim in HEAD_DIMS:
        q = torch.zeros(1, MAX_LEN, 1, head_dim, dtype=dtype)
        check_attention(q, q, q)
    for bad, match in ((torch.zeros(1, MAX_LEN + 1, 1, 128, dtype=dtype), "length"),
                       (torch.zeros(1, 16, 1, 513, dtype=dtype), "head dim"),
                       (torch.zeros(1, 16, 1, 1024, dtype=dtype), "head dim"),
                       (_misaligned((1, 16, 1, 128), dtype), "16-byte")):
        with pytest.raises(ValueError, match=match):
            check_attention(bad, bad, bad)


@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tiled", [False, True])
def test_block_scratch_layout(w_dtype, tiled):
    """The scratch of one block launch, in the C interface's order: the
    attention output in the weights' type (the out projection's rounding),
    a bf16 copy of x1 for FFN1's TMA loads only with bf16 weights, q/k/v in
    the weights' type for K3 and float32 for K2."""
    block = EncoderBlock(128, 4, 256, dropout=0.0, device="cpu")
    w = fuse_encoder_params(block, dtype=w_dtype)
    x = torch.zeros(4, 16, 128)
    qkv, attn, proj, x1, x1w, hidden = block_scratch(x, w, tiled=tiled, ffn_chunks=2)
    assert qkv.shape == (64, 384) and qkv.dtype == (w_dtype if tiled else torch.float32)
    assert attn.shape == (64, 128) and attn.dtype == w_dtype
    assert proj.dtype == x1.dtype == torch.float32 and proj.shape == x1.shape == (64, 128)
    if w_dtype == torch.float32:
        assert x1w is None
    else:
        assert x1w.shape == (64, 128) and x1w.dtype == torch.bfloat16
    assert hidden.shape == (32, 256) and hidden.dtype == w_dtype


@pytest.mark.parametrize("length,masked", [(10, False), (210, True)])
def test_attention_agreement_holds_the_bf16_attention_arithmetic(length, masked):
    """chip_smoke.py's bf16 attention check, on the CPU: the plain version
    (float32 scores in one order) and the same with float64 scores (another
    order) both pass; outputs 3 ulps off, and outputs whose softmax weights
    were never rounded to bf16, fail it through the mean error."""
    gen = torch.Generator().manual_seed(length)
    q, k, v = (torch.randn(16, length, 4, 128, generator=gen).bfloat16() for _ in range(3))
    mask = None
    if masked:
        keep = torch.ones(16, length, dtype=torch.bool)
        keep[:, -13:] = torch.rand(16, 13, generator=gen) < 0.6
        mask = keep[:, None, None, :]
    out = dot_product_attention(q, k, v, mask)
    assert chip_smoke.bf16_ok(chip_smoke.attention_agreement(torch, out, q, k, v, mask))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()).float() / 128 ** 0.5
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    weights = torch.softmax(scores, dim=-1)
    wide = torch.einsum("bhqk,bkhd->bqhd", weights.bfloat16().float(), v.float()).bfloat16()
    assert chip_smoke.bf16_ok(chip_smoke.attention_agreement(torch, wide, q, k, v, mask))
    shifted = (out.float() * (1 + 3 * 2.0 ** -8)).bfloat16()
    unrounded = torch.einsum("bhqk,bkhd->bqhd", weights, v.float()).bfloat16()
    for bad in (shifted, unrounded):
        stats = chip_smoke.attention_agreement(torch, bad, q, k, v, mask)
        assert not chip_smoke.bf16_ok(stats) and stats["mean_ulps"] > chip_smoke.MEAN_ULPS, stats
