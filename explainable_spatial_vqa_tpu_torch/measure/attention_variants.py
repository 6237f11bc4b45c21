"""Variants of K1's attention kernels, each built from the shipped
``csrc/`` by textual replacements (``measure.variants``) and timed beside it
on the card.

    python -m explainable_spatial_vqa_tpu_torch.measure.attention_variants
        [--rounds 6] [--iters 20] [--variants ring,warps8,...]
        [--kinds onepass,wide,past128,narrow,short,f32wide,twopass_deep]
        [--against LABEL=CSRC_DIR]

Each variant asks one question of a shipped kernel (``VARIANTS``).  Of K1's
bf16 kernels at head dims up to 128 (``csrc/attention.cuh``'s one-pass
kernel at head dims up to 64, ``csrc/attention_wide.cuh``'s wgmma kernels
past them and past 256 keys; timed at ``ONEPASS_CASES`` and
``WGMMA_CASES``, the ``fused_attention`` library):

* ``ring``: every bf16 call past 16 keys on the cp.async ring
  (``attention_kernel<bf16, bf16, D, 8>``, two passes past 224 keys;
  ``launch_attention_dim``'s route for ``esv_attention_fma_scores`` taken at
  every head dim, with the scores on the tensor cores): the kernel these
  calls took before the one-pass and wgmma kernels;
* ``warps8``: 8 warps a block (one block an SM at 218 registers a thread)
  instead of 4 (two blocks an SM);
* ``ieee_division``: each weight divided by ``/`` (the compiler's division,
  with its per-element range check and slow-path branch) instead of
  ``div_by``'s reciprocal taken once a row and one correction;
* ``fast_exp``: ``__expf`` (ex2.approx of x log2 e) instead of ``expf``;
* ``wgmma_fast_exp``: the wgmma kernels' weights from ``__expf``
  (ex2.approx of x log2 e) instead of ``expf``: how much of their time the
  softmax's instructions take;
* ``wgmma_two_pass_short``: the two-pass wgmma kernel for every bf16 call
  past 16 keys, not only past 256 (at head dims up to 64 in place of the
  one-pass kernel too);
* ``wgmma_no_softmax``: the one-pass wgmma kernel without its softmax (no
  max, exp, sum or normalisation; P V on unset fragments: wrong numbers);
* ``wgmma_unmasked``: the wgmma kernels take no key mask (wrong numbers
  where keys are masked): what the mask costs;
* ``wgmma_no_fill``: the wgmma kernels' producer arrives on each stage
  without copying Q, K or V (wrong numbers: the consumers alone);
* ``wgmma_consumers_idle``: every consumer warpgroup of the wgmma kernels
  takes and releases the stages only (wrong numbers: the producer alone).

Of the head-dim-256 kernels (``csrc/attention_wide.cuh``; timed at
``WIDE_CASES``, K1's layout and K2's and K3's (B, L, 3d) buffer, through the
``fused_block`` library's ``esv_block_attention``, the blocks' attention
alone):

* ``padded``: neither kernel, so that these calls take the padded kernels
  they took before (``attention_padded.cuh``'s
  ``attention_kernel_padded[_f32]<…, 128, 2, 4>``);
* ``full_depth_scores``: each warp of a row group's pair sums the scores
  over the whole depth itself (1.5x the products), no exchange, no pair
  barrier (the exchange buffer stays allocated, unused);
* ``rows32_keys32``: 2 row groups (32 query rows) a block and 32-key tiles
  instead of 4 and 16 (the shared memory of Q's planes goes to the ring);
* ``one_product``: only hi x hi in both float32 products, a third of the
  tensor work and half the fragment loads (wrong numbers: timed, its error
  printed);
* ``no_pv``: the float32 kernel without its P V products (wrong numbers);
* ``no_scores``: the float32 kernel without its score products (wrong
  numbers);
* ``no_fill``: the float32 kernel's loader groups release each stage
  without loading or writing it (wrong numbers: the consumers alone);
* ``consumers_idle``: every row group of the float32 kernel keeps the
  barriers only (wrong numbers: the producers alone);
* ``wgmma_stages4``: the bf16 kernel's ring at 4 stages of 16 KB, not 8.

Of the one-pass wgmma kernels at the padded depths past 128
(``attention_kernel_wgmma`` at 160-224, ``attention_kernel_wgmma_deep`` at
288-512; timed at ``PAST128_CASES`` through the ``fused_attention``
library's ``esv_attention``, beside ``scaled_dot_product_attention`` on the
same inputs in every round, each case's bound printed):

* ``wgmma_stages6``: the ring at 6 stages of 16 KB at every depth (8 up to
  depth 384, 7 at 448 and 6 at 512 as shipped): what fewer stages cost.

Of the rows that are not whole 16-byte chunks (``NARROW_CASES``: d_model
1100's fusion encoder, D = 275, in float32 on ``attention_kernel_deep_f32``'s
4-byte ``cp.async`` and in bf16 on ``attention_kernel_wgmma_deep``'s narrow
copies; the d 100 protocol's, D = 25, on the padded kernels; K2's attention
at 384 and 512, whose 16-byte copies share the changed loader), the
``fused_attention`` library's ``esv_attention``:

* ``wgmma_narrow_batch4``: the wgmma kernels' producer with the loads of 4
  chunks in flight at once instead of ``kNarrowBatch`` (2);
* ``padded_no_middle``: the deep float32 kernels copy rows that are not
  whole 16-byte chunks element by element, as the padded kernels do,
  instead of shifting each row in shared memory to copy its middle 16
  bytes at a time.

Of the float32 rows past padded depth 128 but 256 (``F32WIDE_CASES``: K2's
attention at d_model 2048 and 1536, the float32 fusion encoders at d_model
544, 768 and 1280; ``attention_kernel_wide_f32`` in
``csrc/attention_f32_wide.cuh``), the ``fused_attention`` library's
``esv_attention``, each case also by its kernel's device time
(``measure.variants.device_ms``), beside SDPA, the plain version and the
bound; the parent's ``attention_kernel_padded_f32`` and
``attention_kernel_deep_f32`` under ``--against``.  Its variants are design
probes, not shipped code:

* ``f32wide_warps12``: 12 warps a block (168 registers a thread) at every
  depth instead of 16 (128 registers) at two and four warps a row group: 4
  and 2 row groups there;
* ``f32wide_warps16``: 16 warps at three warps a row group too (the 4
  more are producers) instead of 12;
* ``f32wide_rows2``: 2 row groups (32 query rows) a block at three and four
  warps a group instead of 3 (the producers take the warps left);
* ``f32wide_rows6``: 6 row groups (96 query rows: three blocks at 208 keys)
  at two warps a group instead of 7 (112: two blocks), 4 producers;
* ``f32wide_no_fill``: the producers arrive on each stage without copying
  or splitting it (wrong numbers: the consumers alone);
* ``f32wide_consumers_idle``: every row group takes and releases the stages
  only (wrong numbers: the producers alone).

Of the bf16 rows past 256 keys at the padded depths past 128
(``TWOPASS_DEEP_CASES``: 1025-key rows at D = 192, 256, 275, 320 and 512,
K3's attention at head dim 512 on 1024 keys of a (B, L, 3d) buffer;
``attention_kernel_wgmma_2pass_deep`` in ``csrc/attention_wide.cuh``), the
``fused_attention`` library's ``esv_attention``, by device time too, beside
SDPA, the plain version and the bound; the parent's
``attention_kernel_padded`` and ``attention_kernel_deep`` under
``--against``:

* ``twopass_deep_shared``: layout (B) past depth 256 in rows of whole
  16-byte chunks, two warpgroups on the same 64 rows, each chaining a
  tile's scores over half of the pieces and holding half of the output,
  their partial scores added in shared memory, every score taken once,
  instead of the shipped layout (A), the output in column chunks of
  ``kTwoPassDeepPieces`` pieces, a block each, every block taking both
  score passes over the whole depth.

Of the rows of at most 16 keys past padded depth 128 (``SHORT_CASES``: the
box decoders at d_model 768-2048, on the short kernels), the same library;
with ``--against`` each case's output is also compared with the other
library's bit for bit (the bf16 short kernel takes one pass where the padded
kernel took two, over one tile: the same weights).  These two kinds time each
library also by its kernels' device time (``measure.variants.device_ms``,
torch.profiler), in the same rounds: a box decoder's kernel takes
microseconds and its call through ctypes more.

``--against LABEL=CSRC_DIR`` adds the libraries of the kinds asked for
(``--kinds``, all by default), built from another ``csrc/`` (the parent
commit's, unpacked by ``git archive``) with the same flags, under LABEL: a
change to the kernels timed against what it replaces in one process.

The variants compile in parallel into ``_build/attention_variants/``, and
ptxas's notes on wgmma it serialised are printed for each library.  Each
library's entry runs every case of its kind: first its largest error against
the plain version (``ops.attention.dot_product_attention``, itself timed
beside the kernels of the ``narrow`` and ``short`` kinds), then
``--rounds`` rounds of CUDA-event means over ``--iters`` calls, the libraries
in turn (reversed every other round), and the medians with the spread
(the least and largest round).  It prints one line per library and one JSON
object (every round's time).  It needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from explainable_spatial_vqa_tpu_torch.bench import emit_json
from explainable_spatial_vqa_tpu_torch.device import card_line, resolve_device
from explainable_spatial_vqa_tpu_torch.measure.variants import (
    Edit,
    build_variants,
    device_ms,
    mean_ms,
    ptxas_usage,
)
from explainable_spatial_vqa_tpu_torch.ops import _build

__all__ = ["VARIANTS", "ONEPASS_VARIANTS", "WIDE_VARIANTS", "PAST128_VARIANTS",
           "NARROW_VARIANTS", "SHORT_VARIANTS", "F32WIDE_VARIANTS", "TWOPASS_DEEP_VARIANTS",
           "ONEPASS_CASES", "WGMMA_CASES", "WIDE_CASES", "PAST128_CASES", "NARROW_CASES",
           "SHORT_CASES", "F32WIDE_CASES", "TWOPASS_DEEP_CASES", "main"]

# label, head dim, B, L, ragged key mask; H = 4, bf16
ONEPASS_CASES = (("transformer_iqap encoder", 64, 512, 243, False),
                 ("step_seq2seq encoder", 64, 512, 246, True),
                 ("hierarchical encoder", 64, 32, 196, False),
                 ("protocol d 192 fusion encoder", 48, 128, 208, True),
                 ("protocol d 96 fusion encoder", 24, 128, 208, True))
# the rows the wgmma kernels took from the ring: label, layout ("K1" or
# "block", as WIDE_CASES), head dim, B, L; H = 4, bf16, ragged key mask: the
# protocol's fusion encoder at d_model 4 D, K1 at the fusion encoder's
# length, rows past 1024 keys, K3's attention at head dim 128 (the block
# bench's rows, and past 256 keys); then the edges of their routes: the
# two-pass kernel at the narrow head dims (P V over 64 columns of V, zero
# past D) and the one-pass kernel on rows of one or a few tiles
WGMMA_CASES = tuple((f"protocol d {4 * d} fusion encoder", "K1", d, 128, 208)
                    for d in range(72, 121, 8)) + (
    ("fusion encoder L=210", "K1", 128, 128, 210),
    ("1025-key row", "K1", 128, 16, 1025),
    ("1025-key row D=64", "K1", 64, 16, 1025),
    ("K3 attention hd128 L=224", "block", 128, 128, 224),
    ("K3 attention hd128 L=304", "block", 128, 128, 304)) + tuple(
    (f"{length}-key row D={d}", "K1", d, b, length)
    for d in (8, 32, 56) for length, b in ((257, 128), (1025, 16), (4096, 2))) + tuple(
    (f"{length}-key row D={d}", "K1", d, 128, length)
    for d in (72, 128) for length in (17, 64))
# label, layout ("K1": (B, L, H, D); "block": the thirds of a (B, L, 3d)
# buffer), type of q/k/v, output type, B, L; H = 4, D = 256, ragged key mask
WIDE_CASES = (("K1 bf16 L=208", "K1", "bf16", "bf16", 128, 208),
              ("K1 fp32 L=208", "K1", "fp32", "fp32", 128, 208),
              ("K2 attention fp32 L=210, bf16 out", "block", "fp32", "bf16", 128, 210),
              ("K3 attention bf16 L=224", "block", "bf16", "bf16", 128, 224))
HEADS, WIDE_DIM = 4, 256
# the rows the one-pass wgmma kernels took from the padded and deep kernels
# past depth 128: label, layout (as WIDE_CASES), head dim, B, L, ragged key
# mask; H = 4, bf16: the executor's fusion layers at d_model 768 and 1280,
# K3's attention at d_model 2048 (the block bench's rows)
PAST128_CASES = (("d 768 encoder", "K1", 192, 128, 208, True),
                 ("d 1280 encoder", "K1", 320, 128, 208, True),
                 ("K3 attention d 2048", "block", 512, 128, 224, False))
# the rows whose loads changed when the kernels stopped copying rows that are
# not whole 16-byte chunks element by element: label, layout (as
# WIDE_CASES), type of q/k/v, output type, head dim, B, L, ragged key mask;
# H = 4
NARROW_CASES = (("d 1100 encoder", "K1", "fp32", "fp32", 275, 128, 210, True),
                ("d 1100 encoder bf16", "K1", "bf16", "bf16", 275, 128, 210, True),
                ("protocol d 100 fusion encoder", "K1", "fp32", "fp32", 25, 128, 208, True),
                ("protocol d 100 fusion encoder bf16", "K1", "bf16", "bf16", 25, 128, 208, True),
                ("K2 attention d 1536 fp32", "block", "fp32", "fp32", 384, 128, 208, True),
                ("K2 attention d 2048", "block", "fp32", "bf16", 512, 128, 210, True))
# the box decoders past padded depth 128 (rows of at most 16 keys, no mask),
# as NARROW_CASES
SHORT_CASES = (("serving d 2048 box decoder", "K1", "bf16", "bf16", 512, 128, 10, False),
               ("serving d 1280 box decoder bf16", "K1", "bf16", "bf16", 320, 128, 10, False),
               ("serving d 1024 box decoder bf16", "K1", "bf16", "bf16", 256, 128, 10, False),
               ("serving d 768 box decoder bf16", "K1", "bf16", "bf16", 192, 128, 10, False),
               ("protocol d 2048 box decoder", "K1", "fp32", "fp32", 512, 128, 8, False),
               ("protocol d 1536 box decoder", "K1", "fp32", "fp32", 384, 128, 8, False),
               ("protocol d 1024 box decoder", "K1", "fp32", "fp32", 256, 128, 8, False))
# the float32 rows attention_kernel_wide_f32 took from the padded and deep
# float32 kernels, as NARROW_CASES: K2's attention at d_model 2048 (bf16
# weights) and 1536 (float32), the float32 fusion encoders at d_model 544,
# 768 and 1280 (K1 at head dims 136, 192 and 320)
F32WIDE_CASES = (("K2 attention d 2048", "block", "fp32", "bf16", 512, 128, 210, True),
                 ("K2 attention d 1536 fp32", "block", "fp32", "fp32", 384, 128, 208, True),
                 ("d 544 encoder", "K1", "fp32", "fp32", 136, 128, 208, True),
                 ("d 768 encoder fp32", "K1", "fp32", "fp32", 192, 128, 208, True),
                 ("d 1280 encoder fp32", "K1", "fp32", "fp32", 320, 128, 208, True))
# the bf16 rows past 256 keys attention_kernel_wgmma_2pass_deep took from the
# padded and deep kernels, as NARROW_CASES: one head dim at each of five
# padded depths (192, 256, 288 in rows of 550 bytes, 336, 512) at 1025 keys,
# and K3's attention at d_model 2048 on 1024 keys
TWOPASS_DEEP_CASES = tuple(
    (f"D={d} L=1025", "K1", "bf16", "bf16", d, 16, 1025, True)
    for d in (512, 256, 192, 275, 320)) + (
    ("K3 attention d 2048 L=1024", "block", "bf16", "bf16", 512, 16, 1024, False),)
# the kinds timed by device time too, in the same rounds
DEVICE_TIMED = ("narrow", "short", "f32wide", "twopass_deep")

_DIV = ("          p[n][r] = pack_bf16x2(div_by(s[kt][n][2 * r], denom[r], inv[r]),\n"
        "                                div_by(s[kt][n][2 * r + 1], denom[r], inv[r]));\n")
_SCORES = ("      mma_3xtf32_add(s[2 * np], ahi, alo, bh0, bl0);\n"
           "      mma_3xtf32_add(s[2 * np + 1], ahi, alo, bh1, bl1);\n")
# the float32 kernel's exchange of the pair's half-depth scores
_EXCHANGE = (
    "    // the pair's halves meet: each adds the other's to its own (float\n"
    "    // addition commutes, so both hold the same sums); the buffer\n"
    "    // alternates by tile, so one pair barrier a tile suffices\n"
    "    float* mine = xs + ((grp * 2 + kt % 2) * 2 + half) * 16 * T;\n"
    "    float* other = xs + ((grp * 2 + kt % 2) * 2 + (half ^ 1)) * 16 * T;\n"
    "#pragma unroll\n"
    "    for (int n = 0; n < NT; ++n)\n"
    "#pragma unroll\n"
    "      for (int c = 0; c < 4; ++c) mine[(n * 4 + c) * 32 + lane] = s[n][c];\n"
    "    asm volatile(\"bar.sync %0, 64;\\n\" ::\"r\"(1 + grp) : \"memory\");\n"
    "#pragma unroll\n"
    "    for (int n = 0; n < NT; ++n)\n"
    "#pragma unroll\n"
    "      for (int c = 0; c < 4; ++c) s[n][c] += other[(n * 4 + c) * 32 + lane];\n")
_PV = ("      mma_3xtf32(o[2 * cp], ahi, alo, bh0, bl0);\n"
       "      mma_3xtf32(o[2 * cp + 1], ahi, alo, bh1, bl1);\n")

# name: (file, old, new) replacements, each old text found exactly once
ONEPASS_VARIANTS: Dict[str, Sequence[Edit]] = {
    "ring": (("attention.cuh", "    if constexpr (kFmaScores) {\n",
              "    if constexpr (true) {\n"),),
    "warps8": (("attention.cuh", "constexpr int kOnePassWarps = 4;",
                "constexpr int kOnePassWarps = 8;"),),
    "ieee_division": (("attention.cuh", _DIV,
                       "          p[n][r] = pack_bf16x2(s[kt][n][2 * r] / denom[r],\n"
                       "                                s[kt][n][2 * r + 1] / denom[r]);\n"),),
    "fast_exp": (("attention.cuh", "s[kt][n][c] = expf(s[kt][n][c] - m[c / 2]);",
                  "s[kt][n][c] = __expf(s[kt][n][c] - m[c / 2]);"),),
    "wgmma_fast_exp": tuple(("attention_wide.cuh", old, old.replace("expf(", "__expf(")) for old in (
        "s[j][c] = expf(s[j][c] - m[c % 4 / 2]);", "kExp ? expf(s[c] - m[r])",
        "kExp ? expf(s[c + 1] - m[r])", "sum[c % 4 / 2] += expf(s[c] - m[c % 4 / 2]);")),
    "wgmma_two_pass_short": (("attention.cuh", "      if (L > kOnePassKeys)\n"
                              "        return launch_attention_wgmma_2pass",
                              "      if (L > 16)\n        return launch_attention_wgmma_2pass"),),
    "wgmma_no_softmax": (("attention_wide.cuh", "  uint32_t p[kTiles][4][4];\n  if (active) {",
                          "  uint32_t p[kTiles][4][4];\n  if (false) {"),),
    "wgmma_unmasked": (("attention_wide.cuh",
                        "const float* mrow = mask == nullptr ? nullptr : mask + (long long)blk.b * L;",
                        "const float* mrow = nullptr;"),),
    "wgmma_no_fill": (("attention_wide.cuh", "      if (cc >= width) continue;",
                       "      if (cc >= width || true) continue;"),
                      ("attention_wide.cuh", "      const bool ok = q0 + row < L && cc < chunks;\n",
                       "      const bool ok = q0 + row < L && cc < chunks;\n"
                       "      if (ok || !ok) continue;\n")),
    "wgmma_consumers_idle": tuple(
        ("attention_wide.cuh", f"const bool active = q0 + 64 * wg < L;  // {note}\n",
         "const bool active = false;\n")
        for note in ("a warpgroup wholly past L keeps the barriers only",
                     "a warpgroup wholly past L only takes stages")),
}
WIDE_VARIANTS: Dict[str, Sequence[Edit]] = {
    "padded": (("attention_padded.cuh",
                "  if constexpr (DP > 128 && (DP == 256 || !std::is_same<T, float>::value)) {\n",
                "  if constexpr (false) {\n"),),
    "full_depth_scores": (
        ("attention_wide.cuh", "kh + kSplitPlane, 16 * half, 16 * half + 16, s);",
         "kh + kSplitPlane, 0, kSplitDepth / 8, s);"),
        ("attention_wide.cuh", _EXCHANGE, "")),
    "consumers_idle": (("attention_wide.cuh", "  const bool active = q0 + 16 * grp < L;",
                        "  const bool active = false;"),),
    "rows32_keys32": (("attention_wide.cuh", "constexpr int kSplitGroups = 4;",
                       "constexpr int kSplitGroups = 2;"),
                      ("attention_wide.cuh", "constexpr int kSplitKeys = 16;",
                       "constexpr int kSplitKeys = 32;")),
    "one_product": (("attention_wide.cuh", _SCORES,
                     "      mma_tf32(s[2 * np], ahi, bh0);\n"
                     "      mma_tf32(s[2 * np + 1], ahi, bh1);\n"),
                    ("attention_wide.cuh", _PV,
                     "      mma_tf32(o[2 * cp], ahi, bh0);\n"
                     "      mma_tf32(o[2 * cp + 1], ahi, bh1);\n")),
    "no_pv": (("attention_wide.cuh", _PV, ""),),
    "no_fill": (("attention_wide.cuh", "      mbar_wait_bounded(empty(stage), (kt & 1) ^ 1);\n",
                 "      mbar_wait_bounded(empty(stage), (kt & 1) ^ 1);\n"
                 "      mbar_arrive(full(stage));\n      continue;\n"),),
    "no_scores": (("attention_wide.cuh", _SCORES, ""),),
    "wgmma_stages4": (("attention_wide.cuh", "constexpr int kWgmmaStages = 8;",
                       "constexpr int kWgmmaStages = 4;"),),
}
PAST128_VARIANTS: Dict[str, Sequence[Edit]] = {
    "wgmma_stages6": (("attention_wide.cuh", "constexpr int kWgmmaStages = 8;",
                       "constexpr int kWgmmaStages = 6;"),),
}
NARROW_VARIANTS: Dict[str, Sequence[Edit]] = {
    "wgmma_narrow_batch4": (("attention_wide.cuh", "constexpr int kNarrowBatch = 2;",
                             "constexpr int kNarrowBatch = 4;"),),
    "padded_no_middle": (("attention_padded.cuh",
                          "  if (kNarrow && std::is_same<T, float>::value && (rs * 4) % 16 == 0 &&",
                          "  if (false && (rs * 4) % 16 == 0 &&"),),

}
SHORT_VARIANTS: Dict[str, Sequence[Edit]] = {}
_F32W = "attention_f32_wide.cuh"
_F32W_ROWS = "  return f32w_group<DP>() == 2 ? 7 : 3;"
_F32W_WARPS = "  return f32w_group<DP>() == 3 ? 12 : 16;"
F32WIDE_VARIANTS: Dict[str, Sequence[Edit]] = {
    "f32wide_warps12": ((_F32W, _F32W_WARPS, "  return 12;"),
                        (_F32W, _F32W_ROWS,
                         "  return f32w_group<DP>() == 3 ? 3 : 8 / f32w_group<DP>();")),
    "f32wide_warps16": ((_F32W, _F32W_WARPS, "  return 16;"),),
    "f32wide_rows2": ((_F32W, _F32W_ROWS, "  return f32w_group<DP>() == 2 ? 7 : 2;"),),
    "f32wide_rows6": ((_F32W, _F32W_ROWS, "  return f32w_group<DP>() == 2 ? 6 : 3;"),),
    "f32wide_no_fill": (
        (_F32W, "        if (key_of[i] < T) cp_async16(", "        if (false) cp_async16("),
        (_F32W, "    const auto split = [&](int n) {  // this thread's copies of piece n landed\n",
         "    const auto split = [&](int n) {  // this thread's copies of piece n landed\n"
         "      if (true) {\n        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(full(n % S));\n        return;\n      }\n")),
    "f32wide_consumers_idle": (
        (_F32W, "  const bool active = q0 + 16 * grp < L;  // a group wholly",
         "  const bool active = false;  // a group wholly"),),
}
_AW = "attention_wide.cuh"
# layout (B) of attention_kernel_wgmma_2pass_deep past depth 256 in rows of
# whole 16-byte chunks: a block is 64 query rows, its two warpgroups the same
# rows, warpgroup 0 the pieces [0, H) of K and of the output, warpgroup 1 [H,
# P) (H = (P + 1) / 2); each chains a tile's scores over its own pieces, the
# partial sums meet in Q's second 64-row group (not loaded), own + other
_SHARED_ROWS = (
    "template <int DP, bool kNarrow>\n"
    "__host__ __device__ constexpr bool two_pass_deep_shares_rows() {\n"
    "  return DP > 256 && !kNarrow;\n"
    "}\n"
    "template <int DP, bool kNarrow>\n"
    "__host__ __device__ constexpr int two_pass_deep_chunks() {\n"
    "  return two_pass_deep_shares_rows<DP, kNarrow>()\n"
    "             ? 1\n"
    "             : (wgmma_pieces<DP>() + kTwoPassDeepPieces - 1) / kTwoPassDeepPieces;\n"
    "}\n"
    "template <int DP, bool kNarrow>\n"
    "__host__ __device__ constexpr int two_pass_deep_rows() {\n"
    "  return two_pass_deep_shares_rows<DP, kNarrow>() ? 64 : kWgmmaRows;\n"
    "}\n")
_SHARED_SCORES = (
    "    if constexpr (kShared) {  // own + other, the same sum in both warpgroups\n"
    "      float* mine = xs + wg * 32 * 128;\n"
    "      const float* other = xs + (wg ^ 1) * 32 * 128;\n"
    "#pragma unroll\n"
    "      for (int c = 0; c < 32; ++c) mine[c * 128 + tid] = s[c];\n"
    "      asm volatile(\"bar.sync 1, 256;\\n\" ::: \"memory\");\n"
    "#pragma unroll\n"
    "      for (int c = 0; c < 32; ++c) s[c] += other[c * 128 + tid];\n"
    "      asm volatile(\"bar.sync 1, 256;\\n\" ::: \"memory\");  // read before the next tile's\n"
    "    }\n")
TWOPASS_DEEP_VARIANTS: Dict[str, Sequence[Edit]] = {
    "twopass_deep_shared": (
        (_AW, "template <int DP, bool kNarrow>\n__device__ __forceinline__ void wgmma_copy_q(",
         "template <int DP, bool kNarrow, int kRows = kWgmmaRows>\n"
         "__device__ __forceinline__ void wgmma_copy_q("),
        (_AW, "    narrow_copy(QC, [&](int j,", "    narrow_copy(kRows * QC / 128, [&](int j,"),
        (_AW, "for (int i = tid; i < 128 * QC; i += 128) {",
         "for (int i = tid; i < kRows * QC; i += 128) {"),
        (_AW, "void wgmma_scores(float (&s)[32], uint32_t qw, uint32_t kst, int dh) {",
         "void wgmma_scores(float (&s)[32], uint32_t qw, uint32_t kst, int dh,\n"
         "                                             int first = 0) {"),
        (_AW, "32 * (kk % 4)), dh > 0 || kk > 0);", "32 * (kk % 4)), dh > first || kk > 0);"),
        (_AW, "template <int DP>\n__host__ __device__ constexpr int two_pass_deep_chunks() {\n"
              "  return (wgmma_pieces<DP>() + kTwoPassDeepPieces - 1) / kTwoPassDeepPieces;\n}\n",
         _SHARED_ROWS),
        (_AW, "template <int DP, bool kNarrow>\n"
              "__device__ __forceinline__ void wgmma_two_pass_produce(",
         "template <int DP, bool kNarrow, int kRows>\n"
         "__device__ __forceinline__ void wgmma_two_pass_produce("),
        (_AW, "  wgmma_copy_q<DP, kNarrow>(blk.qs, q, rs, q0, L, D, tid);",
         "  wgmma_copy_q<DP, kNarrow, kRows>(blk.qs, q, rs, q0, L, D, tid);"),
        (_AW, "  constexpr int C = two_pass_deep_chunks<DP>();\n  // the output pieces a block holds\n"
              "  constexpr int PC = P < kTwoPassDeepPieces ? P : kTwoPassDeepPieces;\n"
              "  static_assert(S >= PC,",
         "  constexpr bool kShared = two_pass_deep_shares_rows<DP, kNarrow>();\n"
         "  constexpr int C = two_pass_deep_chunks<DP, kNarrow>();\n"
         "  constexpr int R = two_pass_deep_rows<DP, kNarrow>(), H = (P + 1) / 2;\n"
         "  constexpr int PC = kShared ? H : P < kTwoPassDeepPieces ? P : kTwoPassDeepPieces;\n"
         "  static_assert(!kShared || (P > 2 && H <= 2 && 2 * 64 * 64 * 4 <= QB * kWgmmaBox),\n"
         "                \"at most two pieces a warpgroup, the exchange in Q's second rows\");\n"
         "  static_assert(S >= (kShared ? P : PC),"),
        (_AW, "  const int q0 = blockIdx.x / C * kWgmmaRows, c0 = PC * (blockIdx.x % C);\n"
              "  const int pieces = min(PC, P - c0);",
         "  const int q0 = blockIdx.x / C * R, c0 = PC * (blockIdx.x % C);\n"
         "  const int pieces = kShared ? P : min(PC, P - c0);"),
        (_AW, "    wgmma_two_pass_produce<DP, kNarrow>(blk,",
         "    wgmma_two_pass_produce<DP, kNarrow, R>(blk,"),
        (_AW, "  const int row0 = q0 + 64 * wg;\n"
              "  const bool active = row0 < L;  // else the warpgroup only takes the stages\n"
              "  const uint32_t qw = blk.qs + wg * QB * kWgmmaBox;\n",
         "  const int row0 = q0 + (kShared ? 0 : 64 * wg);\n"
         "  const int own0 = kShared && wg == 1 ? H : 0, own1 = kShared && wg == 0 ? H : P;\n"
         "  const bool active = row0 < L;  // else the warpgroup only takes the stages\n"
         "  const uint32_t qw = blk.qs + (kShared ? 0 : wg * QB * kWgmmaBox);\n"
         "  float* xs = reinterpret_cast<float*>(wgmma_smem + (blk.qs + QB * kWgmmaBox -\n"
         "                                                     smem_u32(wgmma_smem)));\n"),
        (_AW, "      if (active) wgmma_scores<DP>(s, qw, kst, dh);\n",
         "      if (active && own0 <= dh && dh < own1) wgmma_scores<DP>(s, qw, kst, dh, own0);\n"),
        (_AW, "    ring.release(ring.taken);\n"
              "    if (active) wgmma_mask(s, j * kWgmmaKeys, L, blk.keep, scale, t);\n  };\n"
              "\n  // pass 1: each row's running max and sum (wgmma_running_sum)\n"
              "  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};\n"
              "#pragma unroll 1\n  for (int j = 0; j < nt; ++j) {\n    float s[32];\n"
              "    scores(s, j);\n    if (active) wgmma_running_sum(s, m, sum);\n  }\n"
              "  float denom[2], inv[2];\n  wgmma_denominators(sum, denom, inv);\n\n"
              "  // pass 2: each tile's scores again, exp(s - max)",
         "    ring.release(ring.taken);\n" + _SHARED_SCORES +
         "    if (active) wgmma_mask(s, j * kWgmmaKeys, L, blk.keep, scale, t);\n  };\n"
         "\n  // pass 1: each row's running max and sum (wgmma_running_sum)\n"
         "  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};\n"
         "#pragma unroll 1\n  for (int j = 0; j < nt; ++j) {\n    float s[32];\n"
         "    scores(s, j);\n    if (active) wgmma_running_sum(s, m, sum);\n  }\n"
         "  float denom[2], inv[2];\n  wgmma_denominators(sum, denom, inv);\n\n"
         "  // pass 2: each tile's scores again, exp(s - max)"),
        (_AW, "    for (int i = 0; i < PC; ++i) {  // V's stages, in the producer's order\n"
              "      if (i < pieces) {\n        const uint32_t vst = ring.take();\n"
              "        if (active) wgmma_pv<2>(o[i], p, vst, j > 0);\n",
         "    for (int i = 0; i < (kShared ? P : PC); ++i) {  // V's stages, in the producer's order\n"
         "      if (kShared || i < pieces) {\n        const uint32_t vst = ring.take();\n"
         "        const bool own = !kShared || (i < H) == (wg == 0);\n"
         "        if (active && own) wgmma_pv<2>(o[kShared && i >= H ? i - H : i], p, vst, j > 0);\n"),
        (_AW, "    if (i < pieces)\n"
              "      wgmma_store<2, kNarrow>(op, out_rs, row0 + 16 * warp + g, L, D, 128 * (c0 + i),",
         "    if (kShared ? own0 + i < own1 : i < pieces)\n"
         "      wgmma_store<2, kNarrow>(op, out_rs, row0 + 16 * warp + g, L, D,\n"
         "                              128 * (c0 + own0 + i),"),
        (_AW, "template <auto Kernel, int DP, typename TO, int C = 1>\n",
         "template <auto Kernel, int DP, typename TO, int C = 1, int R = kWgmmaRows>\n"),
        (_AW, "  Kernel<<<dim3((L + kWgmmaRows - 1) / kWgmmaRows * C, H, B), kWgmmaThreads,",
         "  Kernel<<<dim3((L + R - 1) / R * C, H, B), kWgmmaThreads,"),
        (_AW, "  constexpr int C = two_pass_deep_chunks<DP>();  // blocks an item\n"
              "  if (!wgmma_whole_chunks(q, k, v, out, D, in_bs, in_rs, out_bs, out_rs))\n"
              "    return launch_wgmma_kernel<attention_kernel_wgmma_2pass_deep<TO, DP, true>, DP, TO, C>(",
         "  constexpr int CN = two_pass_deep_chunks<DP, true>(), RN = two_pass_deep_rows<DP, true>();\n"
         "  constexpr int C = two_pass_deep_chunks<DP, false>(), R = two_pass_deep_rows<DP, false>();\n"
         "  if (!wgmma_whole_chunks(q, k, v, out, D, in_bs, in_rs, out_bs, out_rs))\n"
         "    return launch_wgmma_kernel<attention_kernel_wgmma_2pass_deep<TO, DP, true>, DP, TO, CN,\n"
         "                               RN>("),
        (_AW, "  return launch_wgmma_kernel<attention_kernel_wgmma_2pass_deep<TO, DP>, DP, TO, C>(",
         "  return launch_wgmma_kernel<attention_kernel_wgmma_2pass_deep<TO, DP>, DP, TO, C, R>("),
    ),
}
VARIANTS: Dict[str, Sequence[Edit]] = {**ONEPASS_VARIANTS, **WIDE_VARIANTS, **PAST128_VARIANTS,
                                       **NARROW_VARIANTS, **SHORT_VARIANTS, **F32WIDE_VARIANTS,
                                       **TWOPASS_DEEP_VARIANTS}

_TYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _ragged(gen, dev, b: int, length: int):
    keep = torch.ones(b, length, dtype=torch.bool, device=dev)
    keep[:, length - 13:] = torch.rand(b, 13, generator=gen, device=dev) < 0.6
    return keep[:, None, None, :]


def _rows(gen, dev, layout: str, b: int, length: int, d: int, dtype):
    """q, k, v as (B, L, d) views: three tensors ("K1"), or the thirds of one
    (B, L, 3d) buffer ("block")."""
    if layout == "K1":
        return tuple(torch.randn(b, length, d, generator=gen, device=dev).to(dtype)
                     for _ in range(3))
    return torch.randn(b, length, 3 * d, generator=gen, device=dev).to(dtype).split(d, dim=-1)


def _onepass_inputs(dev: torch.device):
    """[(label, (q, k, v, mask, out type))] at ``ONEPASS_CASES`` (from seed
    0) and ``WGMMA_CASES`` (seed 2), bf16 q, k, v as (B, L, H * D) views
    (``ops.fused_attention.call_rows``)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for label, d_head, b, length, masked in ONEPASS_CASES:
        q, k, v = _rows(gen, dev, "K1", b, length, HEADS * d_head, torch.bfloat16)
        out.append((label, (q, k, v, _ragged(gen, dev, b, length) if masked else None,
                            torch.bfloat16)))
    gen = torch.Generator(device=dev).manual_seed(2)
    for label, layout, d_head, b, length in WGMMA_CASES:
        q, k, v = _rows(gen, dev, layout, b, length, HEADS * d_head, torch.bfloat16)
        out.append((label, (q, k, v, _ragged(gen, dev, b, length), torch.bfloat16)))
    return out


def _wide_inputs(dev: torch.device):
    """[(label, (q, k, v, mask, out type))] at ``WIDE_CASES``, from seed 1:
    q, k, v as (B, L, H * D) views (``ops.fused_attention.call_rows``)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for label, layout, name, out_name, b, length in WIDE_CASES:
        q, k, v = _rows(gen, dev, layout, b, length, HEADS * WIDE_DIM, _TYPES[name])
        out.append((label, (q, k, v, _ragged(gen, dev, b, length), _TYPES[out_name])))
    return out


def _past128_inputs(dev: torch.device):
    """[(label, (q, k, v, mask, out type))] at ``PAST128_CASES``, from seed
    3: bf16 q, k, v as (B, L, H * D) views (``ops.fused_attention.call_rows``)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    out = []
    for label, layout, d_head, b, length, masked in PAST128_CASES:
        q, k, v = _rows(gen, dev, layout, b, length, HEADS * d_head, torch.bfloat16)
        out.append((label, (q, k, v, _ragged(gen, dev, b, length) if masked else None,
                            torch.bfloat16)))
    return out


def _typed_inputs(dev: torch.device, table, seed: int):
    """[(label, (q, k, v, mask, out type))] at ``table``'s cases
    (``NARROW_CASES``, ``SHORT_CASES``), from ``seed``: q, k, v as (B, L, H *
    D) views (``ops.fused_attention.call_rows``)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for label, layout, name, out_name, d_head, b, length, masked in table:
        q, k, v = _rows(gen, dev, layout, b, length, HEADS * d_head, _TYPES[name])
        out.append((label, (q, k, v, _ragged(gen, dev, b, length) if masked else None,
                            _TYPES[out_name])))
    return out


def _sdpa_call():
    """``scaled_dot_product_attention`` as a library's call: on (B, H, L, D)
    copies of q, k and v made once per input; its (B, H, L, D) output."""
    import torch.nn.functional as F

    heads = {}

    def call(q, k, v, mask, out_dtype):
        if id(q) not in heads:
            b, length, d = q.shape
            heads[id(q)] = [t.reshape(b, length, HEADS, d // HEADS).transpose(1, 2).contiguous()
                            for t in (q, k, v)]
        return F.scaled_dot_product_attention(*heads[id(q)], attn_mask=mask)

    return call


def _bound_ms(q, mask, out_dtype=torch.bfloat16) -> float:
    """The least time of an attention call on the card: the larger of its 4
    L^2 D operations a head (bf16 at its rate; float32 as 3xTF32, three TF32
    products each) and its bytes (q, k, v, the output and the mask each
    moved once) at the memory rate."""
    from explainable_spatial_vqa_tpu_torch.device import PEAK_BYTES, PEAK_OPS

    b, length, d = q.shape
    nbytes = (3 * q.element_size() + torch.empty((), dtype=out_dtype).element_size()) \
        * b * length * d + (b * length * 4 if mask is not None else 0)
    ops = 4.0 * b * length * length * d
    t_ops = ops / PEAK_OPS["bf16"] if q.dtype == torch.bfloat16 else 3 * ops / PEAK_OPS["tf32"]
    return 1e3 * max(t_ops, nbytes / PEAK_BYTES)


def _plain(q, k, v, mask, out_dtype):
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention

    b, length, d = q.shape
    heads = [t.reshape(b, length, HEADS, d // HEADS) for t in (q, k, v)]
    return dot_product_attention(*heads, mask).reshape(b, length, d).to(out_dtype)


def main(argv: Sequence[str] = ()) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--kinds", default="onepass,wide,past128,narrow,short,f32wide,"
                                           "twopass_deep",
                        help="the kinds of cases timed (their libraries built for --against)")
    parser.add_argument("--against", default="",
                        help="LABEL=CSRC_DIR: the libraries built from that csrc/ too")
    args = parser.parse_args(list(argv))
    names = [v for v in args.variants.split(",") if v]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    dev = resolve_device("cuda")
    print(card_line(dev), flush=True)
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import bind_entry, call_rows

    out_dir = _build.BUILD_DIR / "attention_variants"
    against, _, tree = args.against.partition("=")
    libraries = {"onepass": ("fused_attention", ONEPASS_VARIANTS, "esv_attention"),
                 "wide": ("fused_block", WIDE_VARIANTS, "esv_block_attention"),
                 "past128": ("fused_attention", PAST128_VARIANTS, "esv_attention"),
                 "narrow": ("fused_attention", NARROW_VARIANTS, "esv_attention"),
                 "short": ("fused_attention", SHORT_VARIANTS, "esv_attention"),
                 "f32wide": ("fused_attention", F32WIDE_VARIANTS, "esv_attention"),
                 "twopass_deep": ("fused_attention", TWOPASS_DEEP_VARIANTS, "esv_attention")}
    kinds = {kind: [n for n in names if n in libraries[kind][1]]
             for kind in args.kinds.split(",") if kind}
    calls: Dict[str, Dict[str, object]] = {}
    built_against: Dict[str, ctypes.CDLL] = {}  # by library: two kinds may share one
    for kind, chosen in kinds.items():
        if not chosen and not args.against:
            continue
        library, variants, entry = libraries[kind]
        libs = {"shipped": _build.load(library)}
        logs = {"shipped": (_build.BUILD_DIR / f"{library}.log").read_text()}
        also = ({against: (library, out_dir / f"{against}-{library}.so", Path(tree))}
                if args.against and library not in built_against else None)
        for name, (path, log) in build_variants(library, variants, chosen, out_dir,
                                                also=also).items():
            libs[name], logs[name] = ctypes.CDLL(str(path)), log
        if args.against:
            libs[against] = built_against.setdefault(library, libs.get(against))
        for name, log in logs.items():  # ptxas's notes on wgmma it serialised, and why
            notes = sorted({line.split("Potential Performance Loss: ")[-1].strip()
                            for line in log.splitlines() if "serialized" in line})
            spills = {fn: spill for fn, (_, spill) in ptxas_usage(log).items()
                      if spill and "attention_kernel" in fn}
            print(f"{name} ({library}): ptxas serialised wgmma in {len(notes)} functions"
                  + "".join(f"\n  {note}" for note in notes)
                  + f"; attention kernels that spill: {spills or 'none'}", flush=True)
        for name, lib in libs.items():
            calls.setdefault(name, {})[kind] = (
                lambda q, k, v, mask, out_dtype, fn=bind_entry(lib, entry): call_rows(
                    fn, q, k, v, mask, HEADS, out_dtype))
        if kind in ("past128",) + DEVICE_TIMED:
            calls.setdefault("scaled_dot_product_attention", {})[kind] = _sdpa_call()
        if kind in DEVICE_TIMED:  # the port's plain version, which the kernels must beat
            calls.setdefault("plain", {})[kind] = _plain
    if not calls:
        raise ValueError("nothing to time: name a variant or --against")
    inputs = {"onepass": _onepass_inputs, "wide": _wide_inputs, "past128": _past128_inputs,
              "narrow": lambda d: _typed_inputs(d, NARROW_CASES, 4),
              "short": lambda d: _typed_inputs(d, SHORT_CASES, 5),
              "f32wide": lambda d: _typed_inputs(d, F32WIDE_CASES, 6),
              "twopass_deep": lambda d: _typed_inputs(d, TWOPASS_DEEP_CASES, 7)}
    cases = {kind: inputs[kind](dev) if kind in calls["shipped"] else [] for kind in inputs}
    errors: Dict[str, Dict[str, float]] = {name: {} for name in calls}
    outputs: Dict[str, Dict[str, torch.Tensor]] = {name: {} for name in calls}
    for name, by_kind in calls.items():
        for kind, call in by_kind.items():
            for case, args_ in cases[kind]:
                out, ref = call(*args_), _plain(*args_)
                out = out.transpose(1, 2).reshape(ref.shape) if out.dim() == 4 else out
                errors[name][case] = float((out.float() - ref.float()).abs().max())
                if kind == "short":
                    outputs[name][case] = out
    if args.against and cases["short"]:  # the short kernels against the padded ones, bit for bit
        same = {case: bool(torch.equal(outputs["shipped"][case], outputs[against][case]))
                for case, _ in cases["short"]}
        print(f"shipped against {against}, bit for bit: " + "; ".join(
            f"{case} {'equal' if ok else 'DIFFERENT'}" for case, ok in same.items()), flush=True)
    del outputs
    times: Dict[str, Dict[str, List[float]]] = {
        label: {name: [] for kind in by_kind for name, _ in cases[kind]}
        for label, by_kind in calls.items()}
    device: Dict[str, Dict[str, List[Optional[float]]]] = {
        label: {name: [] for kind in by_kind if kind in DEVICE_TIMED for name, _ in cases[kind]}
        for label, by_kind in calls.items()}
    order = list(calls)
    for r in range(args.rounds):
        for label in order if r % 2 == 0 else order[::-1]:
            for kind, call in calls[label].items():
                for name, args_ in cases[kind]:
                    times[label][name].append(mean_ms(lambda: call(*args_), args.iters))
                    if kind in DEVICE_TIMED:  # SDPA, plain: every kernel of the call
                        ms = device_ms(lambda: call(*args_), args.iters,
                                       "" if label in ("scaled_dot_product_attention", "plain")
                                       else "attention_kernel")
                        device[label][name].append(ms)  # None: the profile saw none
    result = {}
    for label in order:
        result[label] = {name: dict(ms=statistics.median(ts), spread_ms=[min(ts), max(ts)],
                                    rounds_ms=ts, max_abs_err=errors[label][name])
                         for name, ts in times[label].items()}
        for name, seen in device[label].items():
            ts = [t for t in seen if t is not None]
            if ts:
                result[label][name].update(device_ms=statistics.median(ts),
                                           device_spread_ms=[min(ts), max(ts)],
                                           device_rounds_ms=ts,
                                           device_rounds_unseen=len(seen) - len(ts))
        print(f"{label}: " + "; ".join(
            f"{name} {v['ms']:.4f} ms ({v['spread_ms'][0]:.4f}-{v['spread_ms'][1]:.4f})"
            + (f", device {v['device_ms']:.4f} ms ({v['device_spread_ms'][0]:.4f}-"
               f"{v['device_spread_ms'][1]:.4f})" if "device_ms" in v else "")
            + f", max_abs_err {v['max_abs_err']:.3g} against the plain version"
            for name, v in result[label].items()), flush=True)
    bounds = {case: _bound_ms(args_[0], args_[3], args_[4])
              for kind in ("past128",) + DEVICE_TIMED for case, args_ in cases[kind]}
    if bounds:
        print("bounds: " + "; ".join(f"{case} {ms:.4f} ms" for case, ms in bounds.items()),
              flush=True)
    return emit_json(dict(card=card_line(dev), rounds=args.rounds, iters=args.iters,
                          onepass_cases=[dict(label=c[0], D=c[1], B=c[2], L=c[3], ragged=c[4],
                                              H=HEADS) for c in ONEPASS_CASES],
                          wgmma_cases=[dict(label=c[0], layout=c[1], D=c[2], B=c[3], L=c[4],
                                            H=HEADS, ragged=True) for c in WGMMA_CASES],
                          wide_cases=[dict(label=c[0], layout=c[1], type=c[2], out=c[3], B=c[4],
                                           L=c[5], H=HEADS, D=WIDE_DIM, ragged=True)
                                      for c in WIDE_CASES],
                          past128_cases=[dict(label=c[0], layout=c[1], D=c[2], B=c[3], L=c[4],
                                              H=HEADS, ragged=c[5], bound_ms=bounds.get(c[0]))
                                         for c in PAST128_CASES],
                          **{f"{kind}_cases": [dict(label=c[0], layout=c[1], type=c[2], out=c[3],
                                                    D=c[4], B=c[5], L=c[6], H=HEADS, ragged=c[7],
                                                    bound_ms=bounds.get(c[0])) for c in table]
                             for kind, table in (("narrow", NARROW_CASES),
                                                 ("short", SHORT_CASES),
                                                 ("f32wide", F32WIDE_CASES),
                                                 ("twopass_deep", TWOPASS_DEEP_CASES))},
                          variants=result))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
