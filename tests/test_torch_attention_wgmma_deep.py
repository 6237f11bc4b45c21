"""K1's one-pass bf16 wgmma kernel at the padded depths past 128
(``attention_kernel_wgmma`` at 160-256, ``attention_kernel_wgmma_deep`` at
288-512, in ``csrc/attention_wide.cuh``) on the CPU.

The kernels run on the card only.  Here:

* the shared memory of every depth the C sources instantiate them at (Q's
  64-column boxes, the ring's stages, the mbarriers and the key mask's bits,
  by ``wgmma_smem_at``'s expression and ``wgmma_stages``' rule, parsed from
  the source) is held under the H100's 232,448 bytes a block, and the
  stage counts and bytes the launcher's comment states are held to it;
* their order of arithmetic is emulated in numpy and held against JAX's
  Pallas kernel (``_fused_attention_bhld`` through ``fused_attention``,
  interpret mode) in bf16 at D = 192, 320 and 512, B = 1, H = 2, L = 210
  with a ragged key mask, under the rule of ``chip_smoke.attention_agreement``
  (``MEAN_ULPS``), which ``chip_smoke.py`` phase 3 holds the kernels to on the
  card.  The emulation follows the kernel: Q and K zero-padded to the padded
  depth; each 64-key tile's scores summed over 16-deep slices, piece by
  piece of 128 columns (the pieces' widths parsed from the source), every
  slice added to one float32 accumulator in turn; the exact row max over
  every key; each thread's share of the sum (keys 8 n + 2 t + e of each
  tile, in tile order) added as the quad's shuffles add them; the weights
  normalised by the sum + 1e-30 (``div_by``: the correctly rounded quotient),
  rounded to bf16, and P V summed in float32, 16 keys a product.  JAX's
  output passes the same rule, and the emulation agrees with JAX's output
  within it.  The negative control, the weights rounded to bf16 before they
  are normalised (``chip_smoke.rounded_first``'s arithmetic), fails it.
"""

import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from explainable_spatial_vqa_tpu_torch.ops import _build
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import PADDED_DEPTHS, padded_depth

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its bf16 attention check; it imports nothing at the top)

torch.set_num_threads(1)

WIDE = (_build.CSRC_DIR / "attention_wide.cuh").read_text()
ATTN = (_build.CSRC_DIR / "attention.cuh").read_text()
B, H, L = 1, 2, 210
f32 = np.float32


def _constant(src: str, name: str, **names) -> int:
    """The value of ``constexpr ... name = <expr>;`` in ``src``, its
    expression evaluated with ``names``."""
    return int(eval(re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1), {}, names))


def _smem_at(depth: int, stages: int) -> int:
    """``wgmma_smem_at<depth>(stages)``, its expression parsed from the
    source and evaluated with the source's constants."""
    body = re.search(r"constexpr size_t wgmma_smem_at\(int S\) \{\s*return (.*?);\n\}", WIDE,
                     re.S).group(1)
    expr = " ".join(re.sub(r"\(size_t\)", "", body).split())
    assert "wgmma_qboxes<DP>()" in expr and re.search(r"\(DP \+ 63\) / 64", WIDE)
    expr = expr.replace("wgmma_qboxes<DP>()", str((depth + 63) // 64))
    box = _constant(WIDE, "kWgmmaBox")
    names = dict(kWgmmaBox=box, kWgmmaStage=_constant(WIDE, "kWgmmaStage", kWgmmaBox=box),
                 kAttnMaxLen=_constant(ATTN, "kAttnMaxLen"), S=stages)
    return eval(expr.replace("/", "//"), {}, names)


def _stages(depth: int) -> int:
    """``wgmma_stages<depth>()``: kWgmmaStages where they fit, else as many
    as fit, at least 2 (the loop parsed from the source)."""
    assert re.search(r"int s = kWgmmaStages;\s*while \(s > 2 && wgmma_smem_at<DP>\(s\) > "
                     r"kPaddedSmemMax\) --s;", WIDE)
    s = _constant(WIDE, "kWgmmaStages")
    while s > 2 and _smem_at(depth, s) > _constant(WIDE, "kPaddedSmemMax"):
        s -= 1
    return s


def _wgmma_depths():
    """Every depth the sources instantiate the one-pass wgmma kernel at:
    launch_attention_dim's (the exact head dims past 64, rounded up to 16;
    K3's attention at 128) and launch_attention_padded's past 128
    (ESV_K1_PAD_DEPTHS in fused_attention.cu; K3's 256, 384 and 512)."""
    src = (_build.CSRC_DIR / "fused_attention.cu").read_text()
    exact = [int(d) for d in re.search(r"#define ESV_K1_HEAD_DIMS ([\d, ]+)", src).group(1)
             .split(",")]
    padded = [int(d) for d in re.search(r"#define ESV_K1_PAD_DEPTHS ([\d, ]+)", src).group(1)
              .split(",")]
    assert padded == list(PADDED_DEPTHS)
    return sorted({(d + 15) // 16 * 16 for d in exact if d > 64} | {d for d in padded if d > 128})


def test_wgmma_shared_memory_fits_every_depth():
    """Each depth's shared memory (Q's boxes, the stages, the mbarriers, the
    mask's bits) under 232,448 bytes; 8 stages up to depth 384, 7 at 448, 6
    at 512; the bytes the launcher's comment states."""
    limit = _constant(WIDE, "kPaddedSmemMax")
    assert limit == 232448
    depths = _wgmma_depths()
    assert depths == [80, 96, 112, 128, 160, 192, 224, 256, 288, 336, 384, 448, 512]
    stages = {d: _stages(d) for d in depths}
    for d in depths:
        assert _smem_at(d, stages[d]) <= limit, (d, stages[d], _smem_at(d, stages[d]))
        assert stages[d] == _constant(WIDE, "kWgmmaStages") or _smem_at(d, stages[d] + 1) > limit
    assert {d: s for d, s in stages.items() if s != 8} == {448: 7, 512: 6}
    stated = re.search(r"// bytes: (.*?)\n\s*static_assert\(wgmma_smem_bytes<DP>\(\) <= "
                       r"kPaddedSmemMax", WIDE, re.S).group(1)
    stated = re.sub(r"\s*//\s*", " ", stated)
    for text, lo, hi in re.findall(r"([\d,]+) at (\d+)(?:-(\d+))?", stated):
        for d in (int(lo), int(hi or lo)):
            assert _smem_at(d, stages[d]) == int(text.replace(",", "")), (d, text)


def _pieces(depth: int):
    """The columns of each piece of 128 (``wgmma_width``), as the source
    defines it: 128 but the last, which takes the rest."""
    body = re.search(r"constexpr int wgmma_width\(int piece\) \{\s*return (.*?);\n\}", WIDE,
                     re.S).group(1)
    assert body == ("piece + 1 < wgmma_pieces<DP>() ? 128 : DP - 128 * "
                    "(wgmma_pieces<DP>() - 1)")
    n = (depth + 127) // 128
    return [128] * (n - 1) + [depth - 128 * (n - 1)]


def _bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to bf16 (to nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=f32)).bfloat16().float().numpy()


def _emulated_head(q, k, v, keep, round_first=False):
    """One (batch, head) of the one-pass wgmma kernel: q, k, v (L, D)
    float32 holding bf16 values, keep (L,) bool; the output rounded to bf16.
    round_first: the weights rounded before they are normalised (the
    negative control)."""
    length, d = q.shape
    depth = padded_depth(d)
    pad = ((0, 0), (0, depth - d))
    qp, kp = np.pad(q, pad), np.pad(k, pad)
    scale = f32(1.0) / np.sqrt(f32(d))
    s = np.zeros((length, length), f32)
    col = 0
    for width in _pieces(depth):  # the pieces in order, one accumulator chain
        for d0 in range(col, col + width, 16):
            part = qp[:, d0:d0 + 16].astype(np.float64) @ kp[:, d0:d0 + 16].T.astype(np.float64)
            s = (s + part.astype(f32)).astype(f32)
        col += width
    assert col == depth
    s = np.where(keep[None, :], (s * scale).astype(f32), f32(-1e30)).astype(f32)
    tiles = (length + 63) // 64
    s = np.pad(s, ((0, 0), (0, tiles * 64 - length)), constant_values=-np.inf)
    m = s.max(axis=1)  # the exact row max
    e = np.exp(s - m[:, None]).astype(f32)
    # thread t of a row's quad adds keys 64 j + 8 n + 2 t + e, j then n then e
    parts = np.zeros((length, 4), f32)
    for j in range(tiles):
        et = e[:, 64 * j:64 * (j + 1)].reshape(length, 8, 4, 2)
        for n in range(8):
            for i in range(2):
                parts = (parts + et[:, n, :, i]).astype(f32)
    total = ((parts[:, 0] + parts[:, 1]) + (parts[:, 2] + parts[:, 3])).astype(f32)
    denom = (total + f32(1e-30)).astype(f32)
    w = _bf16(e) if round_first else _bf16((e / denom[:, None]).astype(f32))
    vp = np.pad(v, ((0, tiles * 64 - length), (0, 0)))
    o = np.zeros((length, d), f32)
    for k0 in range(0, tiles * 64, 16):
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


def _inputs(d: int):
    """bf16 q, k, v (B, L, H, D) as float32 and a ragged key mask (B, L)."""
    rng = np.random.RandomState(7000 + d)
    q, k, v = (_bf16(rng.randn(B, L, H, d)) for _ in range(3))
    keep = np.ones((B, L), bool)
    keep[:, L - 13:] = rng.rand(B, 13) < 0.6  # a ragged tail, as chip_smoke.py masks
    return q, k, v, keep


@pytest.mark.parametrize("d, depth, pieces", [(192, 192, [128, 64]),
                                              (320, 336, [128, 128, 80]),
                                              (512, 512, [128, 128, 128, 128])])
def test_emulated_wgmma_deep_matches_jax(d, depth, pieces):
    """The one-pass wgmma kernel's arithmetic at a padded depth past 128,
    emulated, within the bf16 attention check of the float64 reference and
    of JAX's kernel in interpret mode; the weights rounded before they are
    normalised fail both."""
    assert padded_depth(d) == depth and _pieces(depth) == pieces
    assert chip_smoke.k1_bf16_kernel(d, L) == (chip_smoke.WGMMA_DEEP if depth > 256
                                               else chip_smoke.WGMMA)
    q, k, v, keep = _inputs(d)
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
