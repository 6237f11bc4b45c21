"""The head-dim-256 attention kernels (``csrc/attention_wide.cuh``) on the CPU.

``attention_kernel_split_f32`` (float32 q, k, v: K2's attention at d_model
1024, K1 in float32 at the head dims of padded depth 256) runs on the card
only.  Here its order of arithmetic is emulated in numpy from the source's
own constants and held against JAX's Pallas kernel
(``_fused_attention_bhld`` through ``fused_attention``, interpret mode) at
D = 256, B = 2, H = 2, L = 210 with a ragged key mask, within
``chip_smoke.k1_f32_tol``, the tolerance ``chip_smoke.py`` phase 3 holds the
kernel to: each operand split once into TF32 hi and lo parts
(``ops.fused_block.split_tf32``, the rule of ``split_tf32`` in
``csrc/attention.cuh``; the tensor cores read lo's top bits), the scores as
three products per 8-deep slice summed into a fresh accumulator and added in
float32, each warp of a pair over half the depth and the halves added, the
softmax online over tiles of ``kSplitKeys`` keys, P V in 3xTF32 per 8-key
slice.  Both of the kernel's layouts are covered: K1's (B, L, H, D) and K2's
(B, L, 3d) projection buffer read with its row stride.  One TF32 pass
instead of three misses the tolerance.

Also: ``chip_smoke``'s mirrors of the C routing (``k1_kernel``,
``k1_bf16_kernel``, ``block_attention_kernel``) name the kernel functions
exactly where ``launch_attention_dim`` (the head dims 8-128: the one-pass
kernels up to ``kOnePassKeys`` keys, ``attention_kernel_wgmma`` past head
dim 64, ``attention_kernel_wgmma_2pass`` past ``kOnePassKeys`` keys) and
``launch_attention_padded`` (every other head dim: past padded depth 128 the
short kernels on rows of at most 16 keys and the wide kernels past them,
bf16 on ``attention_kernel_wgmma`` up to depth 256 and
``attention_kernel_wgmma_deep`` past it in rows of any width, float32 at
depth 256 alone in rows of whole 16-byte chunks) send calls, checked
against the names and limits parsed from the C sources.
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
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import padded_depth
from explainable_spatial_vqa_tpu_torch.ops.fused_block import split_tf32

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402  (its tolerance and routing mirrors; it imports nothing at the top)

torch.set_num_threads(1)

WIDE = (_build.CSRC_DIR / "attention_wide.cuh").read_text()
B, H, D, L = 2, 2, 256, 210


def _constant(name: str) -> str:
    return re.search(rf"constexpr \w+ {name} = ([^;]+);", WIDE).group(1)


KEYS = int(_constant("kSplitKeys"))  # the online softmax's tile
# each warp of a pair sums the scores over half the depth (8-deep slices
# 16 half .. 16 half + 15), and the pair adds the halves
assert "kh + kSplitPlane, 16 * half, 16 * half + 16, s);" in WIDE


def _split(x: np.ndarray):
    """x's TF32 split as the kernel reads it: hi (exact in TF32) and lo with
    its low 13 bits dropped, both float64."""
    flat = x.reshape(-1, x.shape[-1])
    hi, lo = (p.numpy() for p in split_tf32(torch.from_numpy(flat)).split(flat.shape[0]))
    lo = (lo.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return hi.astype(np.float64).reshape(x.shape), lo.astype(np.float64).reshape(x.shape)


def _three(a_hi, a_lo, b_hi, b_lo, one_pass: bool):
    """a b^T in 3xTF32 (lo hi + hi lo + hi hi), or one TF32 pass (hi hi)."""
    if one_pass:
        return a_hi @ b_hi.T
    return a_lo @ b_hi.T + a_hi @ b_lo.T + a_hi @ b_hi.T


def _emulated_head(q, k, v, keep, one_pass=False):
    """One (batch, head) of attention_kernel_split_f32 in the kernel's order:
    q, k, v (L, D) float32, keep (L,) bool."""
    f32 = np.float32
    (qh, ql), (kh, kl) = _split(q), _split(k)
    slices = D // 8
    sums = []
    for half in (range(slices // 2), range(slices // 2, slices)):
        s = np.zeros((L, L), f32)
        for kk in half:  # a fresh accumulator per 8-deep slice, added in float32
            sl = slice(8 * kk, 8 * kk + 8)
            s = (s + _three(qh[:, sl], ql[:, sl], kh[:, sl], kl[:, sl], one_pass).astype(f32))
        sums.append(s)
    s = sums[0] + sums[1]
    s = np.where(keep[None, :], s * f32(1.0 / np.sqrt(f32(D))), f32(-1e30)).astype(f32)
    m = np.full(L, -np.inf, f32)
    total = np.zeros(L, f32)
    o = np.zeros((L, D), f32)
    for key0 in range(0, L, KEYS):  # the online softmax, a tile at a time
        st = s[:, key0:key0 + KEYS]
        mn = np.maximum(m, st.max(1))
        alpha = np.exp(m - mn).astype(f32)
        m = mn
        p = np.exp(st - m[:, None]).astype(f32)
        total = (total * alpha + p.sum(1, dtype=np.float64).astype(f32)).astype(f32)
        o = (o * alpha[:, None]).astype(f32)
        (ph, pl), (vth, vtl) = _split(p), _split(np.ascontiguousarray(v[key0:key0 + KEYS].T))
        for n in range(0, p.shape[1], 8):  # P V, 8 keys at a time, into the running sum
            sl = slice(n, n + 8)
            o = (o + _three(ph[:, sl], pl[:, sl], vth[:, sl], vtl[:, sl], one_pass)).astype(f32)
    return (o / (total + f32(1e-30))[:, None]).astype(f32)


def _inputs(layout: str):
    """q, k, v as (B, L, H, D) float32 and the ragged key mask (B, L): from
    one (B, L, 3d) buffer for K2's layout, read as the kernel reads it (row
    r of head h of batch b at b * L * 3d + r * 3d + h * D), else drawn apart."""
    rng = np.random.RandomState(256)
    if layout == "k2":
        d = H * D
        buf = rng.randn(B, L, 3 * d).astype(np.float32)
        flat = buf.reshape(-1)
        b, r, h, c = 1, 17, 1, 5
        heads = []
        for part in range(3):  # the kernel's strided reads, column offset part * d
            t = buf[..., part * d:(part + 1) * d].reshape(B, L, H, D)
            assert t[b, r, h, c] == flat[b * L * 3 * d + r * 3 * d + part * d + h * D + c]
            heads.append(np.ascontiguousarray(t))
        q, k, v = heads
    else:
        q, k, v = (rng.randn(B, L, H, D).astype(np.float32) for _ in range(3))
    keep = np.ones((B, L), bool)
    keep[:, L - 13:] = rng.rand(B, 13) < 0.6  # a ragged tail, as chip_smoke.py masks
    return q, k, v, keep


def _emulated(q, k, v, keep, one_pass=False):
    out = np.zeros_like(q)
    for b in range(B):
        for h in range(H):
            out[b, :, h] = _emulated_head(q[b, :, h], k[b, :, h], v[b, :, h], keep[b], one_pass)
    return out


@pytest.mark.parametrize("layout", ["k1", "k2"])
def test_emulated_split_f32_matches_jax(layout):
    """The float32 kernel's arithmetic, emulated, within k1_f32_tol(210) of
    JAX's kernel in interpret mode; one TF32 pass instead of three misses
    it (the negative control)."""
    q, k, v, keep = _inputs(layout)
    ref = np.asarray(jax_fused_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                         jnp.asarray(keep[:, None, None, :]), interpret=True))
    err = float(np.abs(_emulated(q, k, v, keep) - ref).max())
    assert err <= chip_smoke.k1_f32_tol(L), err
    control = float(np.abs(_emulated(q, k, v, keep, one_pass=True) - ref).max())
    assert control > chip_smoke.k1_f32_tol(L), control


def _names():
    """kAttnKernelNames in csrc/attention.cuh, in the enum's order."""
    src = (_build.CSRC_DIR / "attention.cuh").read_text()
    body = re.search(r"kAttnKernelNames\[kAttnKernels\] = \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r'"(\w+)"', body)
    enum = re.search(r"enum AttnKernel \{(.*?)\};", src, re.S).group(1)
    kinds = [e.strip() for e in enum.split(",") if e.strip() and e.strip() != "kAttnKernels"]
    assert len(kinds) == len(names)
    return dict(zip(kinds, names))


def _wide_rule():
    """The limits of wide_takes, the kernel each branch of
    launch_attention_wide counts (the bf16 one through launch_attention_wgmma)
    and the depths where attention_padded.cuh routes to it (bf16 past depth
    128, float32 at 256 alone), parsed from the sources."""
    takes = re.search(r"static bool wide_takes\(.*?\{(.*?)\n\}", WIDE, re.S).group(1)
    # bf16 at any row width and offset up to kWgmmaMaxKeys keys; float32 in
    # rows of whole 16-byte chunks
    assert re.search(r"if \(!std::is_same<T, float>::value\) return L > 16 && L <= kWgmmaMaxKeys;",
                     takes)
    assert "L > 16" in takes and "(D * sizeof(T)) % 16 == 0" in takes
    max_keys = int(_constant("kWgmmaMaxKeys"))
    launch = re.search(r"launch_attention_wide\(.*?\n\}", WIDE, re.S).group(0)
    counted = set(re.findall(r"counted_launch\((\w+)\)", launch))
    assert "static_assert(DP == kSplitDepth" in launch and int(_constant("kSplitDepth")) == 256
    if re.search(r"return launch_attention_wgmma<DP, TO>\(", launch):
        counted |= set(_wgmma_counts()["launch_attention_wgmma"].values())
    padded = (_build.CSRC_DIR / "attention_padded.cuh").read_text()
    assert re.search(r"if constexpr \(DP > 128 && \(DP == 256 \|\| !std::is_same<T, float>::value\)\)"
                     r" \{\s*if \(wide_takes<T, TO>", padded)
    return max_keys, counted


def _short_rule():
    """launch_attention_padded's route to the short kernels, parsed from
    attention_padded.cuh: (the depth past which rows of at most the parsed
    number of keys take them, that number), checked to come before the wide
    kernels' route, and the AttnKernel each type counts."""
    padded = (_build.CSRC_DIR / "attention_padded.cuh").read_text()
    body = re.search(r"static cudaError_t launch_attention_padded\(.*?\n\}", padded, re.S).group(0)
    found = re.search(r"if constexpr \(DP > (\d+)\) \{\s*if \(L <= (\d+)\)\s*"
                      r"return launch_attention_short<DP, T, TO>", body)
    assert found and body.index("launch_attention_short") < body.index("wide_takes")
    launcher = re.search(r"static cudaError_t launch_attention_short\(.*?\n\}", padded,
                         re.S).group(0)
    counts = dict(re.findall(r"launch_short_kernel<DP, (attention_kernel_short(?:_f32)?)<TO, DG, "
                             r"G>, (\w+)>", launcher))
    assert counts == {"attention_kernel_short_f32": "kAttnKernelShortF32",
                      "attention_kernel_short": "kAttnKernelShort"}
    return int(found.group(1)), int(found.group(2))


def _wgmma_counts():
    """{launcher: {kernel function: the AttnKernel it counts}} for
    attention_wide.cuh's bf16 launchers, each a launch_wgmma_kernel of its
    kernel functions (launch_attention_wgmma: attention_kernel_wgmma up to
    the depth it parses, attention_kernel_wgmma_deep past it)"""
    out = {}
    for launcher, kernels in (("launch_attention_wgmma",
                               ("attention_kernel_wgmma_deep", "attention_kernel_wgmma")),
                              ("launch_attention_wgmma_2pass", ("attention_kernel_wgmma_2pass",)),
                              ("launch_attention_wgmma_2pass_deep",
                               ("attention_kernel_wgmma_2pass_deep",))):
        body = re.search(rf"static cudaError_t {launcher}\(.*?\n\}}", WIDE, re.S).group(0)
        out[launcher] = {}
        for kernel in kernels:
            found = re.search(rf"launch_wgmma_kernel<{kernel}<TO, DP>,[^>]*>\(\s*(\w+),", body)
            out[launcher][kernel] = found.group(1)
    return out


def _two_pass_deep_rule():
    """Whether launch_attention_padded sends every bf16 call past padded
    depth 128 that neither the short kernels nor wide_takes took (rows past
    kWgmmaMaxKeys keys) to launch_attention_wgmma_2pass_deep, ahead of the
    float32 and padded routes, parsed from attention_padded.cuh."""
    padded = (_build.CSRC_DIR / "attention_padded.cuh").read_text()
    body = re.search(r"static cudaError_t launch_attention_padded\(.*?\n\}", padded, re.S).group(0)
    found = re.search(r"if constexpr \(DP > 128 && !std::is_same<T, float>::value\) \{\s*"
                      r"(?://[^\n]*\s*)*return launch_attention_wgmma_2pass_deep<DP, TO>", body)
    return bool(found) and body.index("wide_takes") < found.start() < body.index("launch_padded_r")


def _deep_depth():
    """The depth past which launch_attention_wgmma launches
    attention_kernel_wgmma_deep, parsed from attention_wide.cuh."""
    body = re.search(r"static cudaError_t launch_attention_wgmma\(.*?\n\}", WIDE, re.S).group(0)
    found = re.search(r"if constexpr \(DP > (\d+)\)\s*return launch_wgmma_kernel<"
                      r"attention_kernel_wgmma_deep<TO, DP>", body)
    return int(found.group(1))


def _dim_rule():
    """launch_attention_dim's bf16 routing at the head dims 8-128, parsed
    from attention.cuh: one warp's ring up to 16 keys, the two-pass wgmma
    kernel past kOnePassKeys, the one-pass kernel up to a head dim and the
    one-pass wgmma kernel past it; (kOnePassKeys, that head dim)."""
    src = (_build.CSRC_DIR / "attention.cuh").read_text()
    body = re.search(r"static cudaError_t launch_attention_dim\(.*?\n\}", src, re.S).group(0)
    ring = re.search(r"if \(L <= (\d+)\)\s*return launch_attention_w<D, 1, attention_kernel<", body)
    assert ring and int(ring.group(1)) == 16
    assert re.search(r"if \(L > kOnePassKeys\)\s*return launch_attention_wgmma_2pass<DP, TO>",
                     body)
    onepass = re.search(r"if constexpr \(D <= (\d+)\)\s*return launch_attention_onepass<D, TO>",
                        body)
    assert re.search(r"else\s*return launch_attention_wgmma<DP, TO>", body)
    keys = int(re.search(r"constexpr int kOnePassKeys = (\d+);", src).group(1))
    return keys, int(onepass.group(1))


def test_routing_mirrors_name_the_c_kernels():
    """For every head dim 1-512 and lengths around each split, in both
    types, the mirrors name a kernel function of the C source's list: at the
    head dims 8-128 (multiples of 8) launch_attention_dim's (bf16: the ring
    up to 16 keys, the one-pass kernel up to kOnePassKeys at head dims up to
    64 and attention_kernel_wgmma past them, attention_kernel_wgmma_2pass
    past kOnePassKeys; float32 attention_kernel_f32), elsewhere past padded
    depth 128 the short kernels on rows of at most 16 keys, the
    attention_wide.cuh ones exactly where wide_takes sends a call (past 16
    keys: bf16 up to kWgmmaMaxKeys at every padded depth past 128, in rows of
    any width, attention_kernel_wgmma up to depth 256 and
    attention_kernel_wgmma_deep past it; float32 in rows of whole 16-byte
    chunks, attention_kernel_split_f32 at padded depth 256 and
    attention_kernel_wide_f32 at the other depths, csrc/attention_f32_wide.cuh),
    bf16 past kWgmmaMaxKeys keys at every padded depth past 128
    attention_kernel_wgmma_2pass_deep, and the padded ones otherwise (bf16 up
    to depth 128; float32 past 256 the deep one); K2's and K3's attention at
    head dims 128, 256, 384 and 512 as K1's."""
    names = _names()
    max_keys, counted = _wide_rule()
    short_depth, short_keys = _short_rule()
    assert (short_depth, short_keys) == (128, 16)
    one_pass_keys, onepass_dims = _dim_rule()
    split, wgmma = names["kAttnKernelSplitF32"], names["kAttnKernelWgmma"]
    wide_f32 = names["kAttnKernelWideF32"]
    wgmma_deep, two_pass = names["kAttnKernelWgmmaDeep"], names["kAttnKernelWgmma2Pass"]
    two_pass_deep = names["kAttnKernelWgmma2PassDeep"]
    assert counted == {"kAttnKernelSplitF32", "kAttnKernelWgmma", "kAttnKernelWgmmaDeep"}
    assert _wgmma_counts() == {
        "launch_attention_wgmma": {wgmma_deep: "kAttnKernelWgmmaDeep", wgmma: "kAttnKernelWgmma"},
        "launch_attention_wgmma_2pass": {two_pass: "kAttnKernelWgmma2Pass"},
        "launch_attention_wgmma_2pass_deep": {two_pass_deep: "kAttnKernelWgmma2PassDeep"}}
    assert _two_pass_deep_rule()
    assert "kAttnKernelDeep" not in names  # the deep bf16 kernel is no longer built
    deep_depth = _deep_depth()
    assert deep_depth == 256
    assert (split, wgmma, wgmma_deep, two_pass, two_pass_deep) == (
        chip_smoke.SPLIT_F32, chip_smoke.WGMMA, chip_smoke.WGMMA_DEEP, chip_smoke.WGMMA_2PASS,
        chip_smoke.WGMMA_2PASS_DEEP)
    assert (one_pass_keys, onepass_dims) == (max_keys, 64)

    def exact_bf16(d, length):
        if length <= 16:
            return names["kAttnKernelRing"]
        if length > one_pass_keys:
            return two_pass
        return names["kAttnKernelOnePass"] if d <= onepass_dims else wgmma

    lengths = (1, 8, 16, 17, 64, 208, 224, max_keys, max_keys + 1, 1025, 4096)
    routed = {}  # the new kernels' padded depths, each seen
    for d in range(1, 513):
        exact = d % 8 == 0 and d <= 128
        depth = padded_depth(d)
        for length in lengths:
            for kind, esize in (("bf16", 2), ("fp32", 4)):
                got = chip_smoke.k1_kernel(d, length, kind)
                assert got in names.values(), (d, length, kind, got)
                if kind == "bf16":
                    assert chip_smoke.k1_bf16_kernel(d, length) == got
                if exact:
                    assert got == (exact_bf16(d, length) if kind == "bf16"
                                   else names["kAttnKernelF32"]), (d, length, kind, got)
                    continue
                if depth > short_depth and length <= short_keys:
                    short = names["kAttnKernelShort" + ("" if kind == "bf16" else "F32")]
                    assert got == short, (d, length, kind, got)
                    routed.setdefault(got, set()).add(depth)
                    continue
                if kind == "bf16" and depth > 128 and length > max_keys:
                    assert got == two_pass_deep, (d, length, kind, got)
                    routed.setdefault(got, set()).add(depth)
                    continue
                wide = (depth > 128 and length > 16
                        and (d * esize % 16 == 0 if kind == "fp32" else length <= max_keys))
                new = ((split if depth == 256 else wide_f32) if kind == "fp32"
                       else wgmma_deep if depth > deep_depth else wgmma)
                assert (got == new) == wide, (d, length, kind, got)
                if wide:
                    routed.setdefault(got, set()).add(depth)
                elif kind == "bf16":
                    assert depth <= 128 and got == names["kAttnKernelPadded"], (d, length, got)
                else:
                    padded = "kAttnKernelDeepF32" if d > 256 else "kAttnKernelPaddedF32"
                    assert got == names[padded], (d, length, kind, got)
    past_128 = {160, 192, 224, 256, 288, 336, 384, 448, 512}
    assert routed == {split: {256}, wgmma: {160, 192, 224, 256},
                      wide_f32: {160, 192, 224, 288, 336, 384, 448, 512},
                      wgmma_deep: {288, 336, 384, 448, 512}, two_pass_deep: past_128,
                      names["kAttnKernelShort"]: past_128, names["kAttnKernelShortF32"]: past_128}
    assert (names["kAttnKernelShort"], names["kAttnKernelShortF32"]) == (chip_smoke.SHORT,
                                                                         chip_smoke.SHORT_F32)
    assert set(chip_smoke.WGMMA_DEPTHS) == {80, 96, 112, 128} | routed[wgmma]
    assert set(chip_smoke.WGMMA_DEEP_DEPTHS) == routed[wgmma_deep]
    assert set(chip_smoke.WGMMA_2PASS_DEEP_DEPTHS) == routed[two_pass_deep]
    for length in lengths:
        assert chip_smoke.block_attention_kernel(128, length, "fp32") == names["kAttnKernelF32"]
        assert chip_smoke.block_attention_kernel(128, length, "bf16") == exact_bf16(128, length)
        for kind in ("fp32", "bf16"):
            for d in (256, 384, 512):
                assert (chip_smoke.block_attention_kernel(d, length, kind)
                        == chip_smoke.k1_kernel(d, length, kind))
