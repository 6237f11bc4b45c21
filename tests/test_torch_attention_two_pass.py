"""K1's bf16 two-pass kernel (``attention_kernel_wgmma_2pass`` in
``csrc/attention_wide.cuh``: rows past 256 keys at every head dim up to 128)
on the CPU.

The kernel runs on the card only.  Here its order of arithmetic is emulated
in numpy and held against JAX's Pallas kernel (``_fused_attention_bhld``
through ``fused_attention``, interpret mode) in bf16 at D = 72 and 128,
L = 300 and 1025, with a ragged key mask, under the rule of
``chip_smoke.attention_agreement``, which ``chip_smoke.py`` phase 3 holds the
kernel to on the card: every element within sum_j ulp(w_j)|v_j| + ulp(|ref|)
+ ulp(rms) and the mean error within ``MEAN_ULPS``.  The emulation follows
the kernel: the scores of each 64-key tile summed over 16-deep slices of the
depth zero-padded to a multiple of 16; pass 1 keeps each row's running max
(over the tile, as the quad's shuffles take it) and four partial sums (a
thread's 16 keys of each tile), rescaled when the max grows and added at the
end as the quad's shuffles add them; pass 2 takes the same scores again,
normalises exp(s - max) by the sum + 1e-30 (``div_by``: the correctly
rounded quotient), rounds the weights to bf16 and sums P V in float32, 16
keys a product.  JAX's output passes the same rule (the rule is the TPU
kernel's arithmetic), and the emulation agrees with JAX's output within it.
The negative control, the weights rounded to bf16 before they are normalised
(``chip_smoke.rounded_first``'s arithmetic), fails it.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its bf16 attention check; it imports nothing at the top)

torch.set_num_threads(1)

B, H, KEYS = 1, 2, 64  # KEYS: the kernel's tile (kWgmmaKeys)
f32 = np.float32


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=f32)).bfloat16().float().numpy()


def _slices(a: np.ndarray, b: np.ndarray, depth: int) -> np.ndarray:
    """a b^T as one wgmma chain sums it: each 16-deep slice's products added
    to the float32 accumulator in turn."""
    acc = np.zeros((a.shape[0], b.shape[0]), f32)
    for d0 in range(0, depth, 16):
        part = a[:, d0:d0 + 16].astype(np.float64) @ b[:, d0:d0 + 16].T.astype(np.float64)
        acc = (acc + part.astype(f32)).astype(f32)
    return acc


def _emulated_head(q, k, v, keep, round_first=False):
    """One (batch, head) of attention_kernel_wgmma_2pass: q, k, v (L, D)
    float32 holding bf16 values, keep (L,) bool; the output rounded to bf16.
    round_first: the weights rounded before they are normalised (the
    negative control)."""
    length, d = q.shape
    depth = (d + 15) // 16 * 16
    pad = ((0, 0), (0, depth - d))
    scale = f32(1.0) / np.sqrt(f32(d))
    s = _slices(np.pad(q, pad), np.pad(k, pad), depth)
    s = np.where(keep[None, :], (s * scale).astype(f32), f32(-1e30)).astype(f32)
    tiles = (length + KEYS - 1) // KEYS
    s = np.pad(s, ((0, 0), (0, tiles * KEYS - length)), constant_values=-np.inf)
    # pass 1: thread t of a row's quad holds keys 8 n + 2 t + e of each tile
    m = np.full(length, -np.inf, f32)
    parts = np.zeros((length, 4), f32)
    for j in range(tiles):
        st = s[:, j * KEYS:(j + 1) * KEYS].reshape(length, 8, 4, 2)
        mn = np.maximum(m, st.max(axis=(1, 2, 3)))
        with np.errstate(invalid="ignore"):
            parts = (parts * np.exp(m - mn)[:, None]).astype(f32)
        m = mn
        e = np.exp(st - m[:, None, None, None]).astype(f32)
        for n in range(8):
            for i in range(2):
                parts = (parts + e[:, n, :, i]).astype(f32)
    total = ((parts[:, 0] + parts[:, 1]) + (parts[:, 2] + parts[:, 3])).astype(f32)
    denom = (total + f32(1e-30)).astype(f32)
    # pass 2: the same scores, normalised, rounded to bf16, times V
    e = np.exp(s - m[:, None]).astype(f32)
    w = _bf16(e) if round_first else _bf16((e / denom[:, None]).astype(f32))
    vp = np.pad(v, ((0, tiles * KEYS - length), (0, 0)))
    o = np.zeros((length, d), f32)
    for k0 in range(0, tiles * KEYS, 16):
        part = w[:, k0:k0 + 16].astype(np.float64) @ vp[k0:k0 + 16].astype(np.float64)
        o = (o + part.astype(f32)).astype(f32)
    if round_first:
        o = (o / denom[:, None]).astype(f32)
    return _bf16(o)


def _emulated(q, k, v, keep, round_first=False):
    out = np.zeros_like(q)
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            out[b, :, h] = _emulated_head(q[b, :, h], k[b, :, h], v[b, :, h], keep[b],
                                          round_first)
    return out


def _inputs(d: int, length: int):
    """bf16 q, k, v (B, L, H, D) as float32 and a ragged key mask (B, L)."""
    rng = np.random.RandomState(1000 * d + length)
    q, k, v = (_bf16(rng.randn(B, length, H, d)) for _ in range(3))
    keep = np.ones((B, length), bool)
    keep[:, length - 13:] = rng.rand(B, 13) < 0.6  # a ragged tail, as chip_smoke.py masks
    return q, k, v, keep


@pytest.mark.parametrize("d, length", [(72, 300), (72, 1025), (128, 300), (128, 1025)])
def test_emulated_two_pass_matches_jax(d, length):
    """The two-pass kernel's arithmetic, emulated, within the bf16 attention
    check of the float64 reference and of JAX's kernel in interpret mode;
    the weights rounded before they are normalised fail both."""
    q, k, v, keep = _inputs(d, length)
    mask = keep[:, None, None, :]
    ref = np.asarray(jax_fused_attention(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                                         jnp.asarray(mask), interpret=True)).astype(f32)
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    mt = torch.from_numpy(mask)
    jax_out = torch.from_numpy(ref)

    def held(out, against=None):
        stats = chip_smoke.attention_agreement(torch, torch.from_numpy(out), qt, kt, vt, mt,
                                               ref=against)
        return chip_smoke.bf16_ok(stats), stats

    assert held(ref)[0], held(ref)[1]  # JAX's kernel keeps the rule
    emulated = _emulated(q, k, v, keep)
    for against in (None, jax_out):
        ok, stats = held(emulated, against)
        assert ok, stats
    control = _emulated(q, k, v, keep, round_first=True)
    for against in (None, jax_out):
        ok, stats = held(control, against)
        assert not ok, stats


def test_rounded_first_is_the_emulated_control():
    """``chip_smoke.rounded_first`` (phase 3's negative control on the card)
    computes the weights-rounded-first arithmetic of the emulation's control
    (within the bf16 attention check of it: another float32 score order),
    and fails the check as the control does."""
    q, k, v, keep = _inputs(72, 300)
    qt, kt, vt = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    mask = torch.from_numpy(keep[:, None, None, :])
    got = chip_smoke.rounded_first(torch, qt, kt, vt, mask)
    want = torch.from_numpy(_emulated(q, k, v, keep, round_first=True))
    assert chip_smoke.bf16_ok(chip_smoke.attention_agreement(torch, got, qt, kt, vt, mask,
                                                             ref=want))
    assert not chip_smoke.bf16_ok(chip_smoke.attention_agreement(torch, got, qt, kt, vt, mask))
