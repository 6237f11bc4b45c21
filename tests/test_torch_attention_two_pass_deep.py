"""K1's bf16 two-pass kernel past padded depth 128
(``attention_kernel_wgmma_2pass_deep`` in ``csrc/attention_wide.cuh``: rows
past 256 keys at every head dim 129-512, K3's attention past 256 keys at
head dims 256-512) on the CPU.

The kernel runs on the card only.  Here:

* its order of arithmetic is emulated in numpy and held against JAX's
  Pallas kernel (``_fused_attention_bhld`` through ``fused_attention``,
  interpret mode) in bf16 at D = 160, 192, 256, 275, 320, 384 and 512, L =
  257, 300 and 1025, B = 1, H = 2, with a ragged key mask and unmasked,
  under the rule of ``chip_smoke.attention_agreement`` (``MEAN_ULPS``),
  which ``chip_smoke.py`` phase 3 holds the kernel to on the card.  The
  emulation follows the kernel: Q and K zero-padded to the padded depth;
  each 64-key tile's scores summed over 16-deep slices, piece by piece of
  128 columns (the pieces' widths parsed from the source), into one float32
  chain, the same in every column chunk of the output; pass 1's running row
  max and the quad's four partial sums, rescaled when the max grows;
  pass 2's weights normalised by the sum + 1e-30 (``div_by``: the correctly
  rounded quotient) and rounded to bf16; P V summed in float32, 16 keys a
  product.  JAX's output passes the same rule, and the emulation agrees with
  JAX's output within it.  The negative control, the weights rounded to
  bf16 before they are normalised (``chip_smoke.rounded_first``'s
  arithmetic), fails it;
* K3 at head dims 256 and 512 (one head of d_model 256 and 512) on 264
  keys: its plain version with the emulation in place of its attention,
  held against JAX's ``fused_encoder_block_tiled`` (``_tiled_kernel``) in
  interpret mode, bf16 weights;
* the kernel's shared memory at every depth it is built at (the one-pass
  wgmma kernels' layout, ``wgmma_smem_at`` at ``wgmma_stages``, parsed from
  the source) is under ``kPaddedSmemMax``, with at least as many ring
  stages as pass 2 holds at once (a tile's V pieces of the block's output
  columns), and so does the layout it was timed against (the variant
  ``twopass_deep_shared``, every V piece of a tile past depth 256).
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.models.layers import EncoderBlock as JaxEncoderBlock
from explainable_spatial_vqa_tpu.ops import pallas_block as jax_block
from explainable_spatial_vqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from explainable_spatial_vqa_tpu_torch.convert import flax_to_state_dict
from explainable_spatial_vqa_tpu_torch.measure.attention_variants import TWOPASS_DEEP_VARIANTS
from explainable_spatial_vqa_tpu_torch.measure.variants import variant_sources
from explainable_spatial_vqa_tpu_torch.models.layers import EncoderBlock
from explainable_spatial_vqa_tpu_torch.ops import _build, fused_block
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import PADDED_DEPTHS, padded_depth
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    fuse_encoder_params,
    fused_encoder_block_tiled,
)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its bf16 attention check; it imports nothing at the top)

torch.set_num_threads(1)

WIDE = (_build.CSRC_DIR / "attention_wide.cuh").read_text()
ATTN = (_build.CSRC_DIR / "attention.cuh").read_text()
B, H = 1, 2
f32 = np.float32


def _constant(src: str, name: str, **names) -> int:
    """The value of ``constexpr ... name = <expr>;`` in ``src``, its
    expression evaluated with ``names``."""
    return int(eval(re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1), {}, names))


KEYS = _constant(WIDE, "kWgmmaKeys")  # a tile's keys
PIECE = 128  # K's and V's columns a ring stage
assert re.search(r"return piece \+ 1 < wgmma_pieces<DP>\(\) \? 128 : DP - 128 \* "
                 r"\(wgmma_pieces<DP>\(\) - 1\);", WIDE)
assert re.search(r"return \(DP \+ 127\) / 128;", WIDE)


def _pieces(depth: int):
    """The 128-column pieces of the padded depth, as (first column, width)."""
    n = (depth + 127) // 128
    return [(PIECE * i, PIECE if i + 1 < n else depth - PIECE * (n - 1)) for i in range(n)]


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=f32)).bfloat16().float().numpy()


def _chain(a: np.ndarray, b: np.ndarray, pieces) -> np.ndarray:
    """a b^T as one wgmma chain over ``pieces`` sums it: each 16-deep slice's
    products added to the float32 accumulator in turn, piece by piece."""
    acc = np.zeros((a.shape[0], b.shape[0]), f32)
    for c0, width in pieces:
        for d0 in range(c0, c0 + width, 16):
            part = a[:, d0:d0 + 16].astype(np.float64) @ b[:, d0:d0 + 16].T.astype(np.float64)
            acc = (acc + part.astype(f32)).astype(f32)
    return acc


def _scores(q, k, d: int) -> np.ndarray:
    """The kernel's float32 scores of one (batch, head) before scaling: one
    chain over every piece of the padded depth, in order."""
    depth = padded_depth(d)
    pad = ((0, 0), (0, depth - d))
    return _chain(np.pad(q, pad), np.pad(k, pad), _pieces(depth))


def _emulated_head(q, k, v, keep, round_first=False):
    """One (batch, head) of attention_kernel_wgmma_2pass_deep: q, k, v (L, D)
    float32 holding bf16 values, keep (L,) bool; the output rounded to bf16.
    round_first: the weights rounded before they are normalised (the
    negative control)."""
    length, d = q.shape
    scale = f32(1.0) / np.sqrt(f32(d))
    s = _scores(q, k, d)
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
    """(B, L, H, D) in K1's layout, rows of any width (the narrow copies move
    the same numbers)."""
    out = np.zeros_like(q)
    for b in range(q.shape[0]):
        for h in range(q.shape[2]):
            out[b, :, h] = _emulated_head(q[b, :, h], k[b, :, h], v[b, :, h], keep[b],
                                          round_first)
    return out


def _inputs(d: int, length: int, masked: bool):
    """bf16 q, k, v (B, L, H, D) as float32 and a key mask (B, L): a ragged
    tail, as chip_smoke.py masks, or every key."""
    rng = np.random.RandomState(1000 * d + length + masked)
    q, k, v = (_bf16(rng.randn(B, length, H, d)) for _ in range(3))
    keep = np.ones((B, length), bool)
    if masked:
        keep[:, length - 13:] = rng.rand(B, 13) < 0.6
    return q, k, v, keep


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("length", [257, 300, 1025])
@pytest.mark.parametrize("d", [160, 192, 256, 275, 320, 384, 512])
def test_emulated_two_pass_deep_matches_jax(d, length, masked):
    """The kernel's arithmetic, emulated, within the bf16 attention check of
    the float64 reference and of JAX's kernel in interpret mode; the weights
    rounded before they are normalised fail both; the routing mirror names
    the kernel at this shape."""
    assert chip_smoke.k1_bf16_kernel(d, length) == chip_smoke.WGMMA_2PASS_DEEP
    q, k, v, keep = _inputs(d, length, masked)
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


@pytest.mark.parametrize("d_model", [256, 512])
def test_emulated_two_pass_deep_in_k3_matches_jax_block(d_model, monkeypatch):
    """K3's plain version (batch_tile 2, ffn_chunks 2) with the kernel's
    emulated attention in place of its plain attention, against JAX's
    ``_tiled_kernel`` in interpret mode at one head of d_model (head dim
    256, one column chunk, and 512, two), B = 2, L = 264, a ragged key
    mask, bf16 weights: a max error under 1e-2 and a median under 1e-6
    (``tests/test_torch_head_dims_past_256.py``'s bf16 block limits)."""
    batch, length = 2, 264
    assert chip_smoke.block_attention_kernel(d_model, length, "bf16") == \
        chip_smoke.WGMMA_2PASS_DEEP
    jblock = JaxEncoderBlock(d_model, 1, d_model * 4, dropout=0.0)
    x = np.random.RandomState(d_model).randn(batch, length, d_model).astype(f32)
    variables = jblock.init(jax.random.PRNGKey(d_model), jnp.asarray(x))
    block = EncoderBlock(d_model, 1, d_model * 4, dropout=0.0, device="cpu")
    block.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                                    variables["params"])))
    keep = np.ones((batch, length), bool)
    keep[0, length - 9:] = False
    keep[1, length - 3:] = [True, False, True]
    calls = []

    def emulated(q, k, v, mask, bf16_scores=False):
        assert not bf16_scores and q.dtype == torch.bfloat16
        kept = np.ones((q.shape[0], q.shape[1]), bool) if mask is None else \
            mask[:, 0, 0, :].numpy()
        calls.append(tuple(q.shape))
        out = _emulated(*(t.float().numpy() for t in (q, k, v)), kept)
        return torch.from_numpy(out).bfloat16()

    monkeypatch.setattr(fused_block, "scaled_attention", emulated)
    jweights = jax_block.fuse_encoder_params(variables["params"], dtype=jnp.bfloat16)
    ref = jax_block.fused_encoder_block_tiled(jnp.asarray(x), jnp.asarray(keep), jweights, 1,
                                              batch_tile=2, ffn_chunks=2, interpret=True)
    out = fused_encoder_block_tiled(torch.from_numpy(x), torch.from_numpy(keep),
                                    fuse_encoder_params(block.eval(), dtype=torch.bfloat16), 1,
                                    batch_tile=2, ffn_chunks=2)
    assert calls == [(batch, length, 1, d_model)]
    err = np.abs(out.float().numpy() - np.asarray(ref, dtype=f32))
    assert err.max() < 1e-2 and np.median(err) < 1e-6, (err.max(), np.median(err))


def _smem_at(depth: int, stages: int) -> int:
    """``wgmma_smem_at<depth>(stages)``, its expression parsed from the
    source and evaluated with the source's constants."""
    body = re.search(r"constexpr size_t wgmma_smem_at\(int S\) \{\s*return (.*?);\n\}", WIDE,
                     re.S).group(1)
    expr = " ".join(re.sub(r"\(size_t\)", "", body).split())
    expr = expr.replace("wgmma_qboxes<DP>()", str((depth + 63) // 64))
    box = _constant(WIDE, "kWgmmaBox")
    names = dict(kWgmmaBox=box, kWgmmaStage=_constant(WIDE, "kWgmmaStage", kWgmmaBox=box),
                 kAttnMaxLen=_constant(ATTN, "kAttnMaxLen"), S=stages)
    return eval(expr.replace("/", "//"), {}, names)


def test_two_pass_deep_shared_memory_fits_every_depth():
    """The kernel launches with the one-pass wgmma kernels' layout
    (``wgmma_smem_bytes``: Q's two 64-row groups, ``wgmma_stages`` ring
    stages, the barriers and the key mask's bits): at every padded depth
    past 128 (``PADDED_DEPTHS``) it fits in ``kPaddedSmemMax`` with at least
    two stages, and at least as many as the V pieces pass 2 takes before it
    releases any (a block's output pieces, ``kTwoPassDeepPieces`` at most),
    which the kernel asserts too."""
    launcher = re.search(r"static cudaError_t launch_wgmma_kernel\(.*?\n\}", WIDE, re.S).group(0)
    assert "wgmma_smem_bytes<DP>()" in launcher
    body = re.search(r"attention_kernel_wgmma_2pass_deep\(ESV_WGMMA_PARAMS\) \{(.*?)\n\}", WIDE,
                     re.S).group(1)
    assert "constexpr int PC = P < kTwoPassDeepPieces ? P : kTwoPassDeepPieces;" in body
    assert "static_assert(S >= PC," in body
    limit = _constant(WIDE, "kPaddedSmemMax")
    per_block = _constant(WIDE, "kTwoPassDeepPieces")
    deep = [dp for dp in PADDED_DEPTHS if dp > 128]
    assert deep == list(chip_smoke.WGMMA_2PASS_DEEP_DEPTHS)
    for depth in deep:
        stages = _constant(WIDE, "kWgmmaStages")
        while stages > 2 and _smem_at(depth, stages) > limit:
            stages -= 1
        assert _smem_at(depth, stages) <= limit, depth
        assert stages >= min(len(_pieces(depth)), per_block), depth
    assert all(padded_depth(d) == d for d in deep)


def test_two_pass_deep_shared_variant_ring_holds_every_v_piece():
    """The layout the kernel was timed against (``twopass_deep_shared`` in
    ``measure/attention_variants.py``: past depth 256 in rows of whole
    16-byte chunks, two warpgroups on 64 rows) takes all P of a tile's V
    pieces in pass 2 before it releases any: its patched source asserts
    that the ring holds them, and at every depth it takes (B) at,
    ``wgmma_stages`` leaves at least P stages."""
    patched = variant_sources(TWOPASS_DEEP_VARIANTS, "twopass_deep_shared")["attention_wide.cuh"]
    assert "static_assert(S >= (kShared ? P : PC)," in patched
    assert "return DP > 256 && !kNarrow;" in patched
    limit = _constant(WIDE, "kPaddedSmemMax")
    for depth in (dp for dp in PADDED_DEPTHS if dp > 256):
        stages = _constant(WIDE, "kWgmmaStages")
        while stages > 2 and _smem_at(depth, stages) > limit:
            stages -= 1
        assert stages >= len(_pieces(depth)), depth
