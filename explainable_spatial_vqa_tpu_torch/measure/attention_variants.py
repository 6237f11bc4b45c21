"""Variants of K1's attention kernels, each built from the shipped
``csrc/`` by textual replacements (``measure.variants``) and timed beside it
on the card.

    python -m explainable_spatial_vqa_tpu_torch.measure.attention_variants
        [--rounds 6] [--iters 20] [--variants ring,warps8,...]

Each variant asks one question of a shipped kernel (``VARIANTS``).  Of the
one-pass bf16 kernel at head dims up to 64 (``attention_kernel_onepass`` in
``csrc/attention.cuh``; timed at ``ONEPASS_CASES``, the ``fused_attention``
library):

* ``ring``: no one-pass kernel, so that these calls take the cp.async ring
  (``attention_kernel<bf16, bf16, D, 8>``, two passes past 224 keys), the
  kernel they took before the one-pass kernel was added;
* ``warps8``: 8 warps a block (one block an SM at 218 registers a thread)
  instead of 4 (two blocks an SM);
* ``ieee_division``: each weight divided by ``/`` (the compiler's division,
  with its per-element range check and slow-path branch) instead of
  ``div_by``'s reciprocal taken once a row and one correction;
* ``fast_exp``: ``__expf`` (ex2.approx of x log2 e) instead of ``expf``.

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

The variants compile in parallel into ``_build/attention_variants/``.  Each
library's entry runs every case of its kind: first its largest error against
the plain version (``ops.attention.dot_product_attention``), then
``--rounds`` rounds of CUDA-event means over ``--iters`` calls, the libraries
in turn (reversed every other round), and the medians.  It prints one line
per library and one JSON object (every round's time).  It needs a card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
from typing import Dict, List, Sequence

import torch

from explainable_spatial_vqa_tpu_torch.bench import emit_json
from explainable_spatial_vqa_tpu_torch.device import card_line, resolve_device
from explainable_spatial_vqa_tpu_torch.measure.variants import Edit, build_variants, mean_ms
from explainable_spatial_vqa_tpu_torch.ops import _build

__all__ = ["VARIANTS", "ONEPASS_VARIANTS", "WIDE_VARIANTS", "ONEPASS_CASES", "WIDE_CASES",
           "main"]

# label, head dim, B, L, ragged key mask; H = 4, bf16
ONEPASS_CASES = (("transformer_iqap encoder", 64, 512, 243, False),
                 ("step_seq2seq encoder", 64, 512, 246, True),
                 ("hierarchical encoder", 64, 32, 196, False),
                 ("protocol d 192 fusion encoder", 48, 128, 208, True),
                 ("protocol d 96 fusion encoder", 24, 128, 208, True))
# label, layout ("K1": (B, L, H, D); "block": the thirds of a (B, L, 3d)
# buffer), type of q/k/v, output type, B, L; H = 4, D = 256, ragged key mask
WIDE_CASES = (("K1 bf16 L=208", "K1", "bf16", "bf16", 128, 208),
              ("K1 fp32 L=208", "K1", "fp32", "fp32", 128, 208),
              ("K2 attention fp32 L=210, bf16 out", "block", "fp32", "bf16", 128, 210),
              ("K3 attention bf16 L=224", "block", "bf16", "bf16", 128, 224))
HEADS, WIDE_DIM = 4, 256

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
    "ring": (("attention.cuh", "    if constexpr (D <= 64 && !kFmaScores) {",
              "    if constexpr (false) {"),),
    "warps8": (("attention.cuh", "constexpr int kOnePassWarps = 4;",
                "constexpr int kOnePassWarps = 8;"),),
    "ieee_division": (("attention.cuh", _DIV,
                       "          p[n][r] = pack_bf16x2(s[kt][n][2 * r] / denom[r],\n"
                       "                                s[kt][n][2 * r + 1] / denom[r]);\n"),),
    "fast_exp": (("attention.cuh", "s[kt][n][c] = expf(s[kt][n][c] - m[c / 2]);",
                  "s[kt][n][c] = __expf(s[kt][n][c] - m[c / 2]);"),),
}
WIDE_VARIANTS: Dict[str, Sequence[Edit]] = {
    "padded": (("attention_padded.cuh", "  if constexpr (DP == 256) {\n",
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
VARIANTS: Dict[str, Sequence[Edit]] = {**ONEPASS_VARIANTS, **WIDE_VARIANTS}

_TYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _onepass_inputs(dev: torch.device):
    """[(label, (q, k, v, mask))] at ``ONEPASS_CASES``, from seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for label, d_head, b, length, masked in ONEPASS_CASES:
        q, k, v = (torch.randn(b, length, HEADS, d_head, generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        mask = None
        if masked:
            keep = torch.ones(b, length, dtype=torch.bool, device=dev)
            keep[:, length - 13:] = torch.rand(b, 13, generator=gen, device=dev) < 0.6
            mask = keep[:, None, None, :]
        out.append((label, (q, k, v, mask)))
    return out


def _wide_inputs(dev: torch.device):
    """[(label, (q, k, v, mask, out type))] at ``WIDE_CASES``, from seed 1:
    q, k, v as (B, L, H * D) views (``ops.fused_attention.call_rows``)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    d = HEADS * WIDE_DIM
    out = []
    for label, layout, name, out_name, b, length in WIDE_CASES:
        if layout == "K1":
            q, k, v = (torch.randn(b, length, d, generator=gen, device=dev).to(_TYPES[name])
                       for _ in range(3))
        else:
            qkv = torch.randn(b, length, 3 * d, generator=gen, device=dev).to(_TYPES[name])
            q, k, v = qkv.split(d, dim=-1)
        keep = torch.ones(b, length, dtype=torch.bool, device=dev)
        keep[:, length - 13:] = torch.rand(b, 13, generator=gen, device=dev) < 0.6
        out.append((label, (q, k, v, keep[:, None, None, :], _TYPES[out_name])))
    return out


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
    args = parser.parse_args(list(argv))
    names = [v for v in args.variants.split(",") if v]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    dev = resolve_device("cuda")
    print(card_line(dev), flush=True)
    from explainable_spatial_vqa_tpu_torch.ops.attention import scaled_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
        bind_entry,
        call_entry,
        call_rows,
    )

    out_dir = _build.BUILD_DIR / "attention_variants"
    kinds = {"onepass": [n for n in names if n in ONEPASS_VARIANTS],
             "wide": [n for n in names if n in WIDE_VARIANTS]}
    libraries = {"onepass": ("fused_attention", ONEPASS_VARIANTS, "esv_attention"),
                 "wide": ("fused_block", WIDE_VARIANTS, "esv_block_attention")}
    calls: Dict[str, Dict[str, object]] = {}
    for kind, chosen in kinds.items():
        if not chosen:
            continue
        library, variants, entry = libraries[kind]
        libs = {"shipped": _build.load(library)}
        for name, (path, _) in build_variants(library, variants, chosen, out_dir).items():
            libs[name] = ctypes.CDLL(str(path))
        for label, lib in libs.items():
            fn = bind_entry(lib, entry)
            calls.setdefault(label, {})[kind] = (
                functools.partial(call_entry, fn) if kind == "onepass"
                else lambda q, k, v, mask, out_dtype, fn=fn: call_rows(fn, q, k, v, mask, HEADS,
                                                                        out_dtype))
    cases = {"onepass": _onepass_inputs(dev) if kinds["onepass"] else [],
             "wide": _wide_inputs(dev) if kinds["wide"] else []}
    plain = {"onepass": lambda q, k, v, mask: scaled_attention(q, k, v, mask, bf16_scores=False),
             "wide": _plain}
    errors: Dict[str, Dict[str, float]] = {label: {} for label in calls}
    for label, by_kind in calls.items():
        for kind, call in by_kind.items():
            for name, args_ in cases[kind]:
                out, ref = call(*args_), plain[kind](*args_)
                errors[label][name] = float((out.float() - ref.float()).abs().max())
    times: Dict[str, Dict[str, List[float]]] = {
        label: {name: [] for kind in by_kind for name, _ in cases[kind]}
        for label, by_kind in calls.items()}
    order = list(calls)
    for r in range(args.rounds):
        for label in order if r % 2 == 0 else order[::-1]:
            for kind, call in calls[label].items():
                for name, args_ in cases[kind]:
                    times[label][name].append(mean_ms(lambda: call(*args_), args.iters))
    result = {}
    for label in order:
        result[label] = {name: dict(ms=statistics.median(ts), rounds_ms=ts,
                                    max_abs_err=errors[label][name])
                         for name, ts in times[label].items()}
        print(f"{label}: " + "; ".join(
            f"{name} {v['ms']:.4f} ms, max_abs_err {v['max_abs_err']:.3g} against the plain "
            f"version" for name, v in result[label].items()), flush=True)
    return emit_json(dict(card=card_line(dev), rounds=args.rounds, iters=args.iters,
                          onepass_cases=[dict(label=c[0], D=c[1], B=c[2], L=c[3], ragged=c[4],
                                              H=HEADS) for c in ONEPASS_CASES],
                          wide_cases=[dict(label=c[0], layout=c[1], type=c[2], out=c[3], B=c[4],
                                           L=c[5], H=HEADS, D=WIDE_DIM, ragged=True)
                                      for c in WIDE_CASES],
                          variants=result))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
