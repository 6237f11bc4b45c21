"""K1's rows that are not whole 16-byte chunks and its rows of at most 16
keys past padded depth 128, on the CPU.

The kernels (``csrc/attention_wide.cuh``'s wgmma kernels with their
producer's narrow copies, ``csrc/attention_padded.cuh``'s short kernels) run
on the card only.  Here:

* ``chip_smoke``'s mirror of the C routing is pinned: bf16 rows that are not
  whole 16-byte chunks, 17-256 keys, at every padded depth 160-512 take the
  wgmma kernels (``attention_kernel_wgmma`` up to depth 256,
  ``attention_kernel_wgmma_deep`` past it); rows of at most 16 keys past
  depth 128 take the short kernels in both types, in K1 and in K2's and K3's
  attention; bf16 rows past 256 keys past depth 128, of any width, take
  ``attention_kernel_wgmma_2pass_deep``; every other call takes the kernel it
  took before (the mirror before these routes, written out here);
* the short kernel's one-pass bf16 arithmetic, emulated in torch, equals the
  padded kernels' two-pass form over a single tile bit for bit (weights,
  denominators and outputs): over one tile the first pass ends with sum *
  exp(-inf) + cs = cs; and it is held against JAX's Pallas kernel
  (``_fused_attention_bhld`` through ``fused_attention``, interpret mode) at
  L = 8 and 10, D = 192, 275 and 512, masked and not, under
  ``chip_smoke.attention_agreement`` (``MEAN_ULPS``), which ``chip_smoke.py``
  phase 3 holds the kernels to on the card;
* a numpy model of the producer's narrow copies (4-byte words from the
  aligned floor of each 16-byte chunk, realigned as ``__byte_perm`` with
  selector 0x5432 does, elements past D set to zero, one 16-byte store in
  the 128-byte swizzle), its formulas tied to the source's text, builds the
  same image of Q's rows and of K's and V's tiles, piece by piece, as an
  aligned 16-byte copy of the same values (zeros past D and past L), at D =
  130, 275, 300 and 511, at every head offset mod 8 elements and at even and
  odd row strides, and reads no 4-byte word that holds no element of its
  row.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from explainable_spatial_vqa_tpu.ops.pallas_attention import fused_attention as jax_fused_attention
from explainable_spatial_vqa_tpu_torch.ops import _build
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import padded_depth

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its routing mirrors and bf16 check; it imports nothing at the top)

torch.set_num_threads(1)

WIDE = (_build.CSRC_DIR / "attention_wide.cuh").read_text()
PADDED = (_build.CSRC_DIR / "attention_padded.cuh").read_text()
f32 = torch.float32

# ---------------------------------------------------------------------------
# (a) the routing mirror
# ---------------------------------------------------------------------------


def _parent_kernel(d: int, length: int, name: str) -> str:
    """The kernel function a K1 call launched before the narrow copies and
    the short kernels: rows of whole 16-byte chunks alone on the wide
    kernels past depth 128, past 16 keys (float32 at depths other than 256
    on attention_kernel_wide_f32, which took them later); the padded and
    deep kernels at every other head dim's other calls."""
    bf16 = name == "bf16"
    if d % 8 == 0 and d <= 128:
        if not bf16:
            return "attention_kernel_f32"
        if length <= 16:
            return chip_smoke.RING
        if length > 256:
            return chip_smoke.WGMMA_2PASS
        return chip_smoke.ONE_PASS if d <= 64 else chip_smoke.WGMMA
    depth = padded_depth(d)
    wide = None
    if depth > 128 and d * (2 if bf16 else 4) % 16 == 0 and length > 16:
        if bf16:
            wide = None if length > 256 else chip_smoke.WGMMA_DEEP if depth > 256 else chip_smoke.WGMMA
        else:
            wide = chip_smoke.SPLIT_F32 if depth == 256 else chip_smoke.WIDE_F32
    if bf16:
        return wide or ("attention_kernel_deep" if d > 256 else chip_smoke.PADDED)
    return wide or (chip_smoke.DEEP_F32 if d > 256 else chip_smoke.PADDED_F32)


@pytest.mark.parametrize("length", [17, 64, 208, 210, 224, 256])
def test_bf16_rows_not_whole_chunks_take_the_wgmma_kernels(length):
    """Every head dim 129-512 whose bf16 row is not whole 16-byte chunks, at
    17-256 keys: attention_kernel_wgmma up to padded depth 256,
    attention_kernel_wgmma_deep past it; at 257 keys the two-pass wgmma
    kernel past depth 128, attention_kernel_wgmma_2pass_deep."""
    dims = [d for d in range(129, 513) if 2 * d % 16]
    assert len(dims) == 336
    for d in dims:
        want = chip_smoke.WGMMA_DEEP if padded_depth(d) > 256 else chip_smoke.WGMMA
        assert chip_smoke.k1_bf16_kernel(d, length) == want, d
        assert chip_smoke.k1_bf16_kernel(d, 257) == chip_smoke.WGMMA_2PASS_DEEP, d


@pytest.mark.parametrize("length", range(1, 17))
def test_rows_of_at_most_16_keys_past_depth_128_take_the_short_kernels(length):
    """Every head dim 129-512 at 1-16 keys in both types, and K2's and K3's
    attention at head dims 256, 384 and 512: attention_kernel_short (bf16)
    and attention_kernel_short_f32; up to depth 128 the kernels of before."""
    for d in range(1, 513):
        for name, short in (("bf16", chip_smoke.SHORT), ("fp32", chip_smoke.SHORT_F32)):
            got = chip_smoke.k1_kernel(d, length, name)
            if padded_depth(d) > 128:
                assert got == short, (d, name)
            else:
                assert got == _parent_kernel(d, length, name), (d, name)
    for d in (256, 384, 512):
        assert chip_smoke.block_attention_kernel(d, length, "bf16") == chip_smoke.SHORT
        assert chip_smoke.block_attention_kernel(d, length, "fp32") == chip_smoke.SHORT_F32


def test_every_other_call_keeps_its_kernel():
    """Outside the new routes (the short kernels, the narrow rows, and bf16
    past 256 keys past depth 128 on attention_kernel_wgmma_2pass_deep, named
    there), every head dim 1-512 at lengths around each split, in both
    types, takes the kernel it took before."""
    lengths = (1, 8, 16, 17, 64, 208, 224, 255, 256, 257, 1025, 4096)
    changed = 0
    for d in range(1, 513):
        deep_enough = padded_depth(d) > 128
        for length in lengths:
            for name in ("bf16", "fp32"):
                narrow = name == "bf16" and 2 * d % 16 and 16 < length <= 256
                if deep_enough and (length <= 16 or narrow):
                    changed += 1
                    continue
                if deep_enough and name == "bf16" and length > 256:
                    assert chip_smoke.k1_kernel(d, length, name) == chip_smoke.WGMMA_2PASS_DEEP
                    changed += 1
                    continue
                assert chip_smoke.k1_kernel(d, length, name) == _parent_kernel(d, length, name), \
                    (d, length, name)
    assert changed == 384 * 3 * 2 + 336 * 6 + 384 * 3


# ---------------------------------------------------------------------------
# (b) the short kernel's one-pass bf16 arithmetic
# ---------------------------------------------------------------------------


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(f32)


def _slice_scores(q: torch.Tensor, k: torch.Tensor, keys: int) -> torch.Tensor:
    """The scores of 16 query rows (q: (16, DP)) against ``keys`` keys (k:
    (keys, DP), rows past L zeros), as the padded kernels sum them: each of
    G warps over its slice of the depth (DG columns), each 16-deep slice's
    product (exact in float64, rounded to float32) added to a float32
    accumulator, and the G slices added in order (group_scores)."""
    dp = q.shape[1]
    g = -(-dp // 128) if dp > 128 else 1
    dg = dp // g
    total = None
    for part in range(g):
        s = torch.zeros(16, keys, dtype=f32)
        for d0 in range(part * dg, (part + 1) * dg, 16):
            prod = q[:, d0:d0 + 16].double() @ k[:keys, d0:d0 + 16].double().T
            s = (s + prod.float()).float()
        total = s if total is None else (total + s).float()
    return total


def _short_head(q, k, v, keep, d: int, keys: int):
    """One (batch, head) of the bf16 attention over one tile of ``keys`` keys
    (32: the padded kernel's tile, its two passes; 16: the short kernel's,
    one pass): q, k, v (L, D) float32 holding bf16 values, L <= 16, keep (L,)
    bool.  Returns the normalised weights rounded to bf16, the denominators
    and the output rounded to bf16."""
    length = q.shape[0]
    dp = padded_depth(d)
    pad = lambda x, rows: torch.nn.functional.pad(x, (0, dp - d, 0, rows - length))  # noqa: E731
    qp, kp, vp = pad(q, 16), pad(k, keys), pad(v, keys)
    s = _slice_scores(qp, kp, keys)
    scale = torch.tensor(1.0, dtype=f32) / torch.sqrt(torch.tensor(float(d), dtype=f32))
    key = torch.arange(keys)
    kept = torch.zeros(keys, dtype=torch.bool)
    kept[:length] = keep
    s = torch.where(key[None, :] >= length, torch.tensor(-float("inf")),
                    torch.where(kept[None, :], (s * scale).float(), torch.tensor(-1e30)))
    m = s.max(dim=1).values
    e = torch.exp(s - m[:, None]).float()
    # thread t of a row's quad: cs += e(8n + 2t) + e(8n + 2t + 1), n in order;
    # then the quad's shuffles: (cs_t + cs_t^1) + (cs_t^2 + cs_t^3)
    cs = torch.zeros(16, 4, dtype=f32)
    for n in range(keys // 8):
        for t in range(4):
            pair = (e[:, 8 * n + 2 * t] + e[:, 8 * n + 2 * t + 1]).float()
            cs[:, t] = (cs[:, t] + pair).float()
    cs = ((cs[:, 0] + cs[:, 1]).float() + (cs[:, 2] + cs[:, 3]).float()).float()
    if keys == 32:  # the padded kernel's first pass over its one tile: sum * exp(m - mn) + cs
        zero = torch.zeros(16, dtype=f32)
        cs = (zero * torch.exp(torch.full((16,), -float("inf")) - m) + cs).float()
    denom = (cs + torch.tensor(1e-30, dtype=f32)).float()
    w = _bf16((e / denom[:, None]).float())
    o = torch.zeros(16, dp, dtype=f32)
    for k0 in range(0, keys, 16):  # P V, 16 keys a product, into a float32 sum
        o = (o + (w[:, k0:k0 + 16].double() @ vp[k0:k0 + 16].double()).float()).float()
    return w[:length, :16], denom[:length], _bf16(o[:length, :d])


@pytest.mark.parametrize("length", [8, 10])
@pytest.mark.parametrize("d", [192, 275, 512])
@pytest.mark.parametrize("masked", [False, True])
def test_short_kernel_one_pass_equals_two_pass_and_matches_jax(length, d, masked):
    """B = 2, H = 2: the one-pass form's weights, denominators and outputs
    equal the two-pass form's bit for bit, and its outputs (and JAX's) keep
    the bf16 attention check against the float64 reference and against
    each other."""
    assert chip_smoke.k1_bf16_kernel(d, length) == chip_smoke.SHORT
    rng = np.random.RandomState(1000 * d + 10 * length + masked)
    b, h = 2, 2
    q, k, v = (torch.from_numpy(rng.randn(b, length, h, d).astype(np.float32)).bfloat16()
               for _ in range(3))
    keep = np.ones((b, length), bool)
    if masked:
        for i in range(b):
            keep[i, length - rng.randint(1, length // 2 + 1):] = False
    out = torch.zeros(b, length, h, d, dtype=f32)
    for i in range(b):
        for j in range(h):
            args = (q[i, :, j].float(), k[i, :, j].float(), v[i, :, j].float(),
                    torch.from_numpy(keep[i]), d)
            w1, den1, o1 = _short_head(*args, keys=16)
            w2, den2, o2 = _short_head(*args, keys=32)
            assert torch.equal(w1, w2) and torch.equal(den1, den2) and torch.equal(o1, o2)
            out[i, :, j] = o1
    mask = keep[:, None, None, :]
    ref = jax_fused_attention(*(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)),
                              jnp.asarray(mask), interpret=True)
    jax_out = torch.from_numpy(np.array(ref.astype(jnp.float32))).bfloat16()
    mt = torch.from_numpy(mask)
    for got, against in ((out.bfloat16(), None), (jax_out, None), (out.bfloat16(), jax_out)):
        stats = chip_smoke.attention_agreement(torch, got, q, k, v, mt, ref=against)
        assert chip_smoke.bf16_ok(stats), stats


# ---------------------------------------------------------------------------
# (c) the producer's narrow copies
# ---------------------------------------------------------------------------

BOX = 8192  # kWgmmaBox: 64 rows of 128 bytes


def test_narrow_copy_formulas_are_the_sources():
    """The model below follows these lines of attention_wide.cuh."""
    for text in (
            "const int last = valid > 0 ? ((int)(a >> 1 & 1) + min(valid, 8) - 1) / 2 : -1;",
            "for (int j = 0; j < 5; ++j) w[j] = j <= last ? __ldg(p + j) : 0u;",
            "const uint32_t y = odd ? __byte_perm(w[i], w[i + 1], 0x5432) : w[i];",
            "x[i] = 2 * i + 1 < valid ? y : 2 * i < valid ? y & 0xffffu : 0u;",
            "const int cc = tid % 16, col = 8 * (16 * cb + cc);",
            "const int row = tid / 16 + 8 * j, key = key0 + row;",
            "s = src + (long long)min(key, L - 1) * rs + col;",
            "valid = key < L ? D - col : 0;",
            "d = dst + cc / 8 * kWgmmaBox + row * 128 + ((cc % 8 ^ row % 8) << 4);",
            "s = src + (long long)min(q0 + row, L - 1) * rs + 8 * cc;",
            "valid = q0 + row < L ? D - 8 * cc : 0;",
            "return qs + (row / 64 * QB + cc / 8) * kWgmmaBox + row % 64 * 128 +"):
        assert text in WIDE, text
    assert "constexpr int kWgmmaBox = 8192;" in WIDE


def _narrow_image(mem16, d, col0, dst, row_start, valid):
    """The image the narrow copies write: each chunk from element ``src =
    row_start + col0`` of a bf16 buffer ``mem16`` (16-byte aligned at 0),
    ``valid`` elements of it below D, stored at byte ``dst``.  Returns (the
    image as bytes, whether every word read holds an element of its row)."""
    mem32 = mem16.view(np.uint32)
    src = row_start + col0
    a = 2 * src
    odd = (a >> 1) & 1
    last = np.where(valid > 0, (odd + np.minimum(valid, 8) - 1) // 2, -1)
    j = np.arange(5)
    read = j <= last[..., None]
    widx = (a & ~3)[..., None] // 4 + j
    w = np.where(read, mem32[np.where(read, widx, 0)], 0).astype(np.uint64)
    # every word read overlaps the row's bytes [2 row_start, 2 (row_start + D))
    lo, hi = 4 * widx, 4 * widx + 4
    inside = (~read) | ((hi > 2 * row_start[..., None]) & (lo < 2 * (row_start[..., None] + d)))
    out = np.zeros(src.shape + (4,), np.uint64)
    for i in range(4):
        y = np.where(odd == 1, (w[..., i] >> 16) | ((w[..., i + 1] & 0xFFFF) << 16), w[..., i])
        out[..., i] = np.where(2 * i + 1 < valid, y, np.where(2 * i < valid, y & 0xFFFF, 0))
    image = np.zeros(2 * BOX if dst.max() < 2 * BOX else int(dst.max()) + 16, np.uint8)
    words = image.view(np.uint32)
    for i in range(4):
        words[(dst // 4 + i).ravel()] = out[..., i].ravel().astype(np.uint32)
    return image, bool(inside.all())


def _reference_image(mem16, rows_ok, row_start, col0, d, dst, size):
    """The image an aligned 16-byte copy of the same values writes: the 8
    elements from column col0 of each chunk's row, zeros past D and for rows
    past L."""
    image = np.zeros(size, np.uint8)
    halves = image.view(np.uint16)
    for e in range(8):
        col = col0 + e
        val = np.where(rows_ok & (col < d), mem16[np.where(rows_ok & (col < d), row_start + col, 0)],
                       0)
        halves[(dst // 2 + e).ravel()] = val.ravel()
    return image


def _memory(d, base, rs, length, seed):
    """A bf16 buffer (random bits everywhere, so a read of a neighbour's
    element shows) holding a head whose row r starts at element base + r rs."""
    size = base + length * rs + d + 64
    size += size % 2
    return np.random.RandomState(seed).randint(0, 1 << 16, size).astype(np.uint16)


def _pieces(depth):
    n = (depth + 127) // 128
    return [128] * (n - 1) + [depth - 128 * (n - 1)]


@pytest.mark.parametrize("d", [130, 275, 300, 511])
@pytest.mark.parametrize("base", range(8))
def test_narrow_copies_build_the_aligned_copys_image(d, base):
    """Q's 128 rows (from q0 = 0 and 128, L = 210) and every piece of K's
    and V's tiles at keys 0 and 192 (18 rows below L), at row strides of 4
    heads (even) and of 4 heads plus one element (odd): the narrow copies'
    image equals the aligned copy's, and no word read lies outside its
    row."""
    depth, length = padded_depth(d), 210
    tid = np.arange(128)
    for rs in (4 * d, 4 * d + 1):
        mem16 = _memory(d, base, rs, length, d * 131 + base)
        # K's and V's tiles: thread tid takes chunk tid % 16 of rows tid / 16 + 8 j
        for cb, piece in enumerate(_pieces(depth)):
            for width in (piece // 8, 8 * ((piece + 63) // 64)):  # K's chunks, V's boxes
                for key0 in (0, 192):
                    cc = np.broadcast_to((tid % 16)[:, None], (128, 8))
                    rows = (tid // 16)[:, None] + 8 * np.arange(8)[None, :]
                    take = cc < width
                    cc, rows = cc[take], rows[take]
                    key = key0 + rows
                    col0 = 8 * (16 * cb + cc)
                    row_start = base + np.minimum(key, length - 1) * rs
                    valid = np.where(key < length, d - col0, 0)
                    dst = cc // 8 * BOX + rows * 128 + ((cc % 8 ^ rows % 8) << 4)
                    got, inside = _narrow_image(mem16, d, col0, dst, row_start, valid)
                    want = _reference_image(mem16, key < length, row_start, col0, d, dst,
                                            got.size)
                    assert inside, (rs, cb, width, key0)
                    np.testing.assert_array_equal(got, want, err_msg=f"{rs} {cb} {width} {key0}")
        # Q: chunk i = tid + 128 j, j < DP / 8, of 128 rows from q0
        qc, qb = depth // 8, (depth + 63) // 64
        for q0 in (0, 128):
            i = (tid[:, None] + 128 * np.arange(qc)[None, :]).ravel()
            rows, cc = i // qc, i % qc
            row_start = base + np.minimum(q0 + rows, length - 1) * rs
            valid = np.where(q0 + rows < length, d - 8 * cc, 0)
            dst = (rows // 64 * qb + cc // 8) * BOX + rows % 64 * 128 + ((cc % 8 ^ rows % 8) << 4)
            got, inside = _narrow_image(mem16, d, 8 * cc, dst, row_start, valid)
            want = _reference_image(mem16, q0 + rows < length, row_start, 8 * cc, d, dst,
                                    got.size)
            assert inside, (rs, q0)
            np.testing.assert_array_equal(got, want, err_msg=f"Q {rs} {q0}")
