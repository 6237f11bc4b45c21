"""Variants of the float32 block GEMM (``gemm_tf32_wgmma`` in
``csrc/fused_block.cu``), each built from the shipped source by a textual
patch and timed beside it on the card; and the block library as another
checkout builds it, timed beside the shipped one.

    python -m explainable_spatial_vqa_tpu_torch.measure.gemm_variants
        [--rounds 4] [--iters 20] [--variants long_chain,one_product,...]
        [--against LABEL=CSRC_DIR]

Each variant asks one question of the shipped kernel (``VARIANTS``):

* ``long_chain``: no fresh accumulator per 32-deep slice, all of K summed
  by the tensor cores (what the slices cost in time and save in error);
* ``one_product``: only a_hi w_hi, a third of the tensor work on the same
  bytes (wrong numbers: timed, its error printed);
* ``no_lo_loads``: W_lo not loaded and W_hi read in its place, two thirds
  of the bytes for the same tensor work (wrong numbers likewise).

``--against LABEL=CSRC_DIR`` adds ``fused_block`` built from another
checkout's ``csrc/`` directory (say, the parent commit's, unpacked by ``git
archive``), with the same flags, under LABEL: a change to the block library
timed against what it replaces in one process.

The variants compile in parallel (``measure.variants``: each a patched copy
of ``csrc/``, built with the package's flags) into ``_build/variants/``, and
each library's GEMM functions' registers and spilled bytes are printed from
ptxas's report.  K2's four products in float32 (B*L = 128 x 210, d 512, ffn
2048; the weights split once) and in bf16 (``gemm_bf16_wgmma``), and K2 in
float32 at the fusion encoder's shape, run through ``block_gemm`` and
``fused_encoder_block`` with each library swapped in for ``fused_block``,
and K2 (L=210) and K3 (L=224, ``batch_tile=2, ffn_chunks=2``) at head dim
256 (B=128, d_model 1024, 4 heads, ffn 4096, ragged), in bf16 and in
float32, and K3 in bf16 at head dim 128 (d_model 512, ffn 2048) at L = 224
and 304 (its attention one pass and two).  First each one's largest error against
the plain version, as a share of max|ref|, then ``--rounds`` rounds of
CUDA-event means over ``--iters`` calls, the libraries in turn (reversed
every other round), and the medians.  It prints one line per library and
one JSON object (every round's time).  It needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import statistics
from pathlib import Path
from typing import Dict, Iterator, List, Sequence

import torch

from explainable_spatial_vqa_tpu_torch.bench import emit_json
from explainable_spatial_vqa_tpu_torch.device import card_line, resolve_device
from explainable_spatial_vqa_tpu_torch.measure.variants import (
    Edit,
    build_variants,
    mean_ms,
    ptxas_usage,
)
from explainable_spatial_vqa_tpu_torch.ops import _build

__all__ = ["VARIANTS", "PRODUCTS", "main"]

# K2's four products at the fusion encoder's shape: name, N, K, ReLU
PRODUCTS = (("qkv", 1536, 512, False), ("out", 512, 512, False), ("ffn1", 2048, 512, True),
            ("ffn2", 512, 2048, False))
ROWS, D, FFN, HEADS, LENGTH = 128 * 210, 512, 2048, 4, 210
# K2 and K3 at head dim 256: block, L, B, d_model, ffn
BLOCKS_HD256 = (("K2", 210, 128, 1024, 4096), ("K3", 224, 128, 1024, 4096))
# K3 in bf16 at head dim 128: L, B (d_model 512, ffn 2048)
K3_HD128 = ((224, 128), (304, 128))

_PRODUCTS_3 = (
    "          wgmma_m64n128k8_tf32(part, lo[kk], sw128_desc(whi + 32 * kk), kk > 0 ? 1 : 0);\n"
    "          wgmma_m64n128k8_tf32(part, hi[kk], sw128_desc(wlo + 32 * kk), 1);\n"
    "          wgmma_m64n128k8_tf32(part, hi[kk], sw128_desc(whi + 32 * kk), 1);\n")

# name: (file, old, new) replacements, each old text found exactly once
VARIANTS: Dict[str, Sequence[Edit]] = {
    "long_chain": (
        ("fused_block.cu",
         "        float part[64];\n        fence_operands(part);\n        wgmma_fence();\n",
         "        fence_operands(acc);\n        wgmma_fence();\n"),
        ("fused_block.cu", _PRODUCTS_3,
         _PRODUCTS_3.replace("(part,", "(acc,").replace("kk > 0 ? 1 : 0", "1")),
        ("fused_block.cu",
         "        wgmma_wait<0>();\n        fence_operands(part);\n"
         "        if (tid == 0) mbar_arrive(empty(stage));\n"
         "#pragma unroll\n        for (int e = 0; e < 64; ++e) acc[e] += part[e];\n",
         "        wgmma_wait<0>();\n        fence_operands(acc);\n"
         "        if (tid == 0) mbar_arrive(empty(stage));\n"),
    ),
    "one_product": (("fused_block.cu", _PRODUCTS_3,
                     "          wgmma_m64n128k8_tf32(part, hi[kk], "
                     "sw128_desc(whi + 32 * kk), kk > 0 ? 1 : 0);\n"),),
    "no_lo_loads": (
        ("fused_block.cu", "mbar_expect_tx(full(stage), 3 * kTf32Bytes);",
         "mbar_expect_tx(full(stage), 2 * kTf32Bytes);"),
        ("fused_block.cu",
         "          tma_load_2d(lo_ring + stage * kTf32Bytes, &tma_wlo, full(stage), "
         "ks * kTf32BK, n0);\n", ""),
        ("fused_block.cu", "wlo = lo_ring + stage * kTf32Bytes;", "wlo = whi;"),
    ),
}


@contextlib.contextmanager
def _loaded(lib: ctypes.CDLL) -> Iterator[None]:
    """``lib`` in place of the built ``fused_block`` library for the block."""
    kept = _build.load("fused_block")
    _build._LIBS["fused_block"] = lib
    try:
        yield
    finally:
        _build._LIBS["fused_block"] = kept


def _cases(dev: torch.device):
    """[(name, call, reference)]: K2's four products in float32 and in bf16,
    K2 in float32, K2 and K3 at ``BLOCKS_HD256``, and K3 at ``K3_HD128``."""
    from explainable_spatial_vqa_tpu_torch.ops.block_gemm import block_gemm, block_gemm_plain
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        BlockWeights,
        fused_encoder_block,
        fused_encoder_block_plain,
        fused_encoder_block_tiled,
        fused_encoder_block_tiled_plain,
        split_block_weights,
        split_tf32,
    )

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def block_inputs(b, length, d, ffn, dtype):
        """A ragged key mask, weights (matrices in ``dtype``) and x in ``dtype``."""
        w = BlockWeights(randn(3 * d, d, scale=d ** -0.5, dtype=dtype), randn(3 * d, scale=0.02),
                         randn(d, d, scale=d ** -0.5, dtype=dtype), randn(d, scale=0.02),
                         randn(ffn, d, scale=d ** -0.5, dtype=dtype), randn(ffn, scale=0.02),
                         randn(d, ffn, scale=ffn ** -0.5, dtype=dtype), randn(d, scale=0.02),
                         1 + randn(d, scale=0.1), randn(d, scale=0.1), 1 + randn(d, scale=0.1),
                         randn(d, scale=0.1))
        keep = torch.ones(b, length, dtype=torch.bool, device=dev)
        keep[:, length - 13:] = torch.rand(b, 13, generator=gen, device=dev) < 0.6
        return keep, w, randn(b, length, d, dtype=dtype)

    cases = []
    for name, n, k, relu in PRODUCTS:
        a, w, bias = randn(ROWS, k), randn(n, k, scale=k ** -0.5), randn(n, scale=0.02)
        split = split_tf32(w)
        cases.append((name, lambda a=a, w=w, b=bias, r=relu, s=split: block_gemm(a, w, b, r,
                                                                                  split=s),
                      block_gemm_plain(a, w, bias, relu)))
    for name, n, k, relu in PRODUCTS:
        a, w = randn(ROWS, k, dtype=torch.bfloat16), randn(n, k, scale=k ** -0.5,
                                                           dtype=torch.bfloat16)
        bias = randn(n, scale=0.02)
        cases.append((f"{name} bf16", lambda a=a, w=w, b=bias, r=relu: block_gemm(a, w, b, r),
                      block_gemm_plain(a, w, bias, relu)))
    keep, w, x = block_inputs(ROWS // LENGTH, LENGTH, D, FFN, torch.float32)
    split = split_block_weights(w)
    cases.append(("K2", lambda x=x, keep=keep, w=w, s=split: fused_encoder_block(
        x, keep, w, HEADS, split=s), fused_encoder_block_plain(x, keep, w, HEADS)))
    for block, length, b, d, ffn in BLOCKS_HD256:
        kernel, plain = ((fused_encoder_block, fused_encoder_block_plain) if block == "K2" else
                         (fused_encoder_block_tiled, fused_encoder_block_tiled_plain))
        tiling = {} if block == "K2" else dict(batch_tile=2, ffn_chunks=2)
        for dtype, label in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
            keep, w, x = block_inputs(b, length, d, ffn, dtype)
            split = split_block_weights(w)
            cases.append((f"{block} hd256 {label}",
                          lambda x=x, keep=keep, w=w, s=split, k=kernel, t=tiling: k(
                              x, keep, w, HEADS, split=s, **t),
                          plain(x, keep, w, HEADS, **tiling)))
    for length, b in K3_HD128:
        keep, w, x = block_inputs(b, length, D, FFN, torch.bfloat16)
        cases.append((f"K3 hd128 bf16 L={length}",
                      lambda x=x, keep=keep, w=w: fused_encoder_block_tiled(
                          x, keep, w, HEADS, batch_tile=2, ffn_chunks=2),
                      fused_encoder_block_tiled_plain(x, keep, w, HEADS, batch_tile=2,
                                                      ffn_chunks=2)))
    return cases


def main(argv: Sequence[str] = ()) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--against", default="",
                        help="LABEL=CSRC_DIR: fused_block built from that csrc/ too")
    args = parser.parse_args(list(argv))
    names = [v for v in args.variants.split(",") if v]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(dev), flush=True)
    libs = {"shipped": _build.load("fused_block")}
    logs = {"shipped": (_build.BUILD_DIR / "fused_block.log").read_text()}
    out_dir = _build.BUILD_DIR / "variants"
    jobs = {}
    if args.against:
        label, _, tree = args.against.partition("=")
        out_dir.mkdir(parents=True, exist_ok=True)
        jobs[label] = ("fused_block", out_dir / f"{label}.so", Path(tree))
    built = build_variants("fused_block", VARIANTS, names, out_dir, also=jobs)
    for name, (path, log) in built.items():
        libs[name], logs[name] = ctypes.CDLL(str(path)), log
    for label, log in logs.items():
        print(f"{label} GEMM functions (ptxas): " + "; ".join(
            f"{fn} {regs} registers, {spill} bytes spilled"
            for fn, (regs, spill) in sorted(ptxas_usage(log).items()) if "gemm_" in fn),
            flush=True)
    cases = _cases(dev)
    errors: Dict[str, Dict[str, float]] = {}
    for label, lib in libs.items():
        with _loaded(lib):
            errors[label] = {}
            for name, call, ref in cases:
                out = call()
                torch.cuda.synchronize()
                errors[label][name] = float((out - ref).abs().max() / ref.abs().max())
    times: Dict[str, Dict[str, List[float]]] = {l: {c[0]: [] for c in cases} for l in libs}
    order = list(libs)
    for r in range(args.rounds):
        for label in order if r % 2 == 0 else order[::-1]:
            with _loaded(libs[label]):
                for name, call, _ in cases:
                    times[label][name].append(mean_ms(call, args.iters))
    result = {}
    for label in order:
        result[label] = {name: dict(ms=statistics.median(ts), rounds_ms=ts,
                                    rel_err=errors[label][name])
                         for name, ts in times[label].items()}
        print(f"{label}: " + "; ".join(
            f"{name} {v['ms']:.4f} ms, err {v['rel_err']:.3g} of max|ref|"
            for name, v in result[label].items()), flush=True)
    return emit_json(dict(card=card_line(dev), rounds=args.rounds, iters=args.iters,
                          variants=result))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
