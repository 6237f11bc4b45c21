"""The port's float32 products as the card computes them, 3xTF32, on the CPU:
the TF32 split of ``ops/fused_block.py:split_tf32`` (the rule of
``split_tf32`` in ``csrc/attention.cuh``, which the GEMM applies to its left
operand on the card), a 3xTF32 product emulated from it against JAX's
float32 ``jnp.dot`` at K2's four product shapes, and the split weights the
encoder block keeps with its fused weights."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu_torch.models.layers import EncoderBlock
from explainable_spatial_vqa_tpu_torch.ops.block_gemm import block_gemm_plain
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    fuse_encoder_params,
    split_block_weights,
    split_tf32,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (K2's product shapes and GEMM tolerance)

torch.set_num_threads(1)

LOW_BITS = 0x1FFF  # the 13 mantissa bits float32 has beyond TF32's 10


def _values(case: str) -> np.ndarray:
    rng = np.random.RandomState(13)
    if case == "random":
        return rng.randn(64, 48).astype(np.float32)
    if case == "tiny":  # normal numbers near float32's smallest
        return (rng.uniform(1, 2, (16, 16)) * 1e-37).astype(np.float32)
    if case == "negative":
        return -np.abs(rng.randn(16, 16) * 1e3).astype(np.float32)
    # ties: the 13 bits below TF32's last exactly half a TF32 ulp, both signs,
    # and with a mantissa of all ones below (the rounding carries into the
    # exponent)
    bits = (rng.randint(0x3F000000, 0x41000000, (16, 16)) & ~LOW_BITS) | 0x1000
    bits[0, :8] = 0x3FFFF000
    bits[1::2] |= np.int64(0x80000000)
    return bits.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("case", ["random", "tiny", "negative", "ties"])
def test_split_tf32(case):
    """hi has its low 13 bits zero, hi + lo == x exactly in float32, |lo| <=
    2^-11 |x|; ties round away from zero (half a TF32 ulp is added to the
    magnitude's bits)."""
    x = _values(case)
    split = split_tf32(torch.from_numpy(x))
    assert split.shape == (2 * x.shape[0], x.shape[1]) and split.dtype == torch.float32
    hi, lo = (t.numpy() for t in split.split(x.shape[0]))
    assert not (hi.view(np.uint32) & LOW_BITS).any()
    np.testing.assert_array_equal(hi + lo, x)
    assert (np.abs(lo) <= np.abs(x) * 2.0 ** -11).all()
    if case == "ties":
        assert (np.abs(hi) > np.abs(x)).all() and (np.sign(hi) == np.sign(x)).all()
        assert (hi[0, :8] == 2.0).all()


def _tf32_read(t: np.ndarray) -> np.ndarray:
    """A float32 operand as the tensor cores read it as TF32: the low 13
    bits dropped."""
    return (t.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def _emulated_3xtf32(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """a @ w.T as the float32 GEMM takes it on the card: each operand split
    (hi exact in TF32, lo read with its low bits dropped), the three
    products a_lo w_hi + a_hi w_lo + a_hi w_hi summed in float64, rounded to
    float32 once."""
    parts = []
    for t in (a, w):
        hi, lo = (p.numpy() for p in split_tf32(torch.from_numpy(t)).split(t.shape[0]))
        parts.append((hi.astype(np.float64), _tf32_read(lo).astype(np.float64)))
    (a_hi, a_lo), (w_hi, w_lo) = parts
    return (a_lo @ w_hi.T + a_hi @ w_lo.T + a_hi @ w_hi.T).astype(np.float32)


def _product_inputs(name: str, rows: int = 32):
    _, n, k, relu, _ = next(g for g in chip_smoke.K2_GEMMS if g[0] == name)
    rng = np.random.RandomState(sum(map(ord, name)))
    return (rng.randn(rows, k).astype(np.float32),
            (rng.randn(n, k) / np.sqrt(k)).astype(np.float32),
            (0.02 * rng.randn(n)).astype(np.float32), relu)


def _rel_err(out: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("name", [g[0] for g in chip_smoke.K2_GEMMS])
def test_emulated_3xtf32_matches_jax(name):
    """The 3xTF32 product, bias and ReLU where K2 takes it, against the TPU
    kernel's float32 product, jnp.dot(a, w.T, preferred_element_type=float32)
    (ops/pallas_block.py:126), and against the port's plain version, within
    chip_smoke.GEMM_REL_TOL of the largest |ref|: the tolerance phase 3 holds
    the kernel to on the card, at K2's four product shapes (32 rows)."""
    a, w, b, relu = _product_inputs(name)
    ref = jnp.dot(jnp.asarray(a), jnp.asarray(w).T, preferred_element_type=jnp.float32) + b
    ref = np.asarray(jnp.maximum(ref, 0.0) if relu else ref)
    out = _emulated_3xtf32(a, w) + b
    out = np.maximum(out, 0.0) if relu else out
    assert _rel_err(out, ref) <= chip_smoke.GEMM_REL_TOL, _rel_err(out, ref)
    plain = block_gemm_plain(torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(b),
                             relu).numpy()
    assert _rel_err(out, plain) <= chip_smoke.GEMM_REL_TOL


@pytest.mark.parametrize("name", [g[0] for g in chip_smoke.K2_GEMMS])
def test_one_tf32_pass_misses_the_tolerance(name):
    """The negative control of phase 3 on the CPU: the product in one TF32
    pass (each operand rounded to TF32 once, float64 sums) misses
    GEMM_REL_TOL, so the tolerance tells 3xTF32 from TF32."""
    a, w, _, _ = _product_inputs(name)
    ref = a.astype(np.float64) @ w.astype(np.float64).T
    hi = [split_tf32(torch.from_numpy(t))[:t.shape[0]].double().numpy() for t in (a, w)]
    assert _rel_err(hi[0] @ hi[1].T, ref) > chip_smoke.GEMM_REL_TOL
    assert _rel_err(_emulated_3xtf32(a, w), ref) <= chip_smoke.GEMM_REL_TOL / 10


def _cached_split(block):
    weights, split = block.__dict__["_cached_on_params"][1]
    return weights, split


def test_cached_split_follows_the_parameters():
    """The encoder block keeps its weights' split with its fused weights
    (models.layers.cached_on_params), and an optimizer step makes it anew:
    the cached split equals the split of the current parameters."""
    torch.manual_seed(0)
    block = EncoderBlock(256, 2, 512, dropout=0.0, device="cpu")  # head dim 128: K2's route
    x = torch.randn(2, 8, 256)
    block.eval()
    with torch.no_grad():
        block(x)
    _, before = _cached_split(block)
    torch.testing.assert_close(before, split_block_weights(fuse_encoder_params(block)),
                               rtol=0, atol=0)
    block.train()
    opt = torch.optim.SGD(block.parameters(), lr=0.1)
    block(x).square().mean().backward()
    opt.step()
    block.eval()
    with torch.no_grad():
        block(x)
    weights, after = _cached_split(block)
    fresh = fuse_encoder_params(block)
    torch.testing.assert_close(weights, fresh, rtol=0, atol=0)
    torch.testing.assert_close(after, split_block_weights(fresh), rtol=0, atol=0)
    assert not torch.equal(after.qkv, before.qkv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_block_weights_layout(dtype):
    """Float32 weights' four matrices split to (2N, K), the hi parts over the
    lo parts; bf16 weights take no split."""
    block = EncoderBlock(128, 1, 256, dropout=0.0, device="cpu")
    w = fuse_encoder_params(block, dtype=dtype)
    split = split_block_weights(w)
    if dtype == torch.bfloat16:
        assert split is None
        return
    for t, s in zip((w.qkv, w.out, w.ffn1, w.ffn2), split):
        assert s.shape == (2 * t.shape[0], t.shape[1]) and s.is_contiguous()
        torch.testing.assert_close(s[:t.shape[0]] + s[t.shape[0]:], t, rtol=0, atol=0)
