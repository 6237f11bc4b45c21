"""Variants of the float32 block GEMM (``gemm_tf32_wgmma`` in
``csrc/fused_block.cu``), each built from the shipped source by a textual
patch and timed beside it on the card.

    python -m explainable_spatial_vqa_tpu_torch.measure.gemm_variants
        [--rounds 4] [--iters 20] [--variants long_chain,one_product,...]

Each variant asks one question of the shipped kernel (``VARIANTS``):

* ``long_chain``: no fresh accumulator per 32-deep slice, all of K summed
  by the tensor cores (what the slices cost in time and save in error);
* ``one_product``: only a_hi w_hi, a third of the tensor work on the same
  bytes (wrong numbers: timed, its error printed);
* ``no_lo_loads``: W_lo not loaded and W_hi read in its place, two thirds
  of the bytes for the same tensor work (wrong numbers likewise).

The variants compile in parallel (``nvcc`` with the package's flags and
``-I csrc``) into ``_build/variants/``.  K2's four products in float32 (B*L
= 128 x 210, d 512, ffn 2048; the weights split once) and K2 in float32 at
the fusion encoder's shape run through ``block_gemm`` and
``fused_encoder_block`` with each library swapped in for ``fused_block``:
first each one's largest error against the plain version, as a share of
max|ref|, then ``--rounds`` rounds of CUDA-event means over ``--iters``
calls, the libraries in turn (reversed every other round), and the medians.
It prints one line per library and one JSON object (every round's time).
It needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import statistics
import subprocess
from pathlib import Path
from typing import Dict, Iterator, List, Sequence

import torch

from explainable_spatial_vqa_tpu_torch.bench import emit_json
from explainable_spatial_vqa_tpu_torch.device import card_line, resolve_device
from explainable_spatial_vqa_tpu_torch.ops import _build

__all__ = ["VARIANTS", "PRODUCTS", "variant_source", "build_variants", "main"]

# K2's four products at the fusion encoder's shape: name, N, K, ReLU
PRODUCTS = (("qkv", 1536, 512, False), ("out", 512, 512, False), ("ffn1", 2048, 512, True),
            ("ffn2", 512, 2048, False))
ROWS, D, FFN, HEADS, LENGTH = 128 * 210, 512, 2048, 4, 210

_PRODUCTS_3 = (
    "          wgmma_m64n128k8_tf32(part, lo[kk], sw128_desc(whi + 32 * kk), kk > 0 ? 1 : 0);\n"
    "          wgmma_m64n128k8_tf32(part, hi[kk], sw128_desc(wlo + 32 * kk), 1);\n"
    "          wgmma_m64n128k8_tf32(part, hi[kk], sw128_desc(whi + 32 * kk), 1);\n")

# name: (old, new) replacements, each old text found exactly once in the source
VARIANTS: Dict[str, tuple] = {
    "long_chain": (
        ("        float part[64];\n        fence_operands(part);\n        wgmma_fence();\n",
         "        fence_operands(acc);\n        wgmma_fence();\n"),
        (_PRODUCTS_3, _PRODUCTS_3.replace("(part,", "(acc,").replace("kk > 0 ? 1 : 0", "1")),
        ("        wgmma_wait<0>();\n        fence_operands(part);\n"
         "        if (tid == 0) mbar_arrive(empty(stage));\n"
         "#pragma unroll\n        for (int e = 0; e < 64; ++e) acc[e] += part[e];\n",
         "        wgmma_wait<0>();\n        fence_operands(acc);\n"
         "        if (tid == 0) mbar_arrive(empty(stage));\n"),
    ),
    "one_product": ((_PRODUCTS_3, "          wgmma_m64n128k8_tf32(part, hi[kk], "
                                  "sw128_desc(whi + 32 * kk), kk > 0 ? 1 : 0);\n"),),
    "no_lo_loads": (
        ("mbar_expect_tx(full(stage), 3 * kTf32Bytes);",
         "mbar_expect_tx(full(stage), 2 * kTf32Bytes);"),
        ("          tma_load_2d(lo_ring + stage * kTf32Bytes, &tma_wlo, full(stage), "
         "ks * kTf32BK, n0);\n", ""),
        ("wlo = lo_ring + stage * kTf32Bytes;", "wlo = whi;"),
    ),
}


def variant_source(name: str, source: str) -> str:
    """``source`` (``csrc/fused_block.cu``'s text) with variant ``name``'s
    replacements; raises ValueError where one does not match exactly once."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} occurs {source.count(old)} times "
                             f"in fused_block.cu, not once")
        source = source.replace(old, new)
    return source


def build_variants(names: Sequence[str], out_dir: Path) -> Dict[str, Path]:
    """Compile each variant of ``fused_block.cu`` into ``out_dir``, all at
    once; {name: library}.  Raises with the compiler's output on a failure."""
    source = (_build.CSRC_DIR / "fused_block.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(name, source))
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o",
               str(out_dir / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    failed = []
    for name, proc in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{output[-4000:]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: out_dir / f"{name}.so" for name in names}


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
    """[(name, call, reference)]: K2's four float32 products and K2 in float32."""
    from explainable_spatial_vqa_tpu_torch.ops.block_gemm import block_gemm, block_gemm_plain
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        BlockWeights,
        fused_encoder_block,
        fused_encoder_block_plain,
        split_block_weights,
        split_tf32,
    )

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    cases = []
    for name, n, k, relu in PRODUCTS:
        a, w, bias = randn(ROWS, k), randn(n, k, scale=k ** -0.5), randn(n, scale=0.02)
        split = split_tf32(w)
        cases.append((name, lambda a=a, w=w, b=bias, r=relu, s=split: block_gemm(a, w, b, r,
                                                                                  split=s),
                      block_gemm_plain(a, w, bias, relu)))
    w = BlockWeights(randn(3 * D, D, scale=D ** -0.5), randn(3 * D, scale=0.02),
                     randn(D, D, scale=D ** -0.5), randn(D, scale=0.02),
                     randn(FFN, D, scale=D ** -0.5), randn(FFN, scale=0.02),
                     randn(D, FFN, scale=FFN ** -0.5), randn(D, scale=0.02),
                     1 + randn(D, scale=0.1), randn(D, scale=0.1), 1 + randn(D, scale=0.1),
                     randn(D, scale=0.1))
    x = randn(ROWS // LENGTH, LENGTH, D)
    keep = torch.ones(ROWS // LENGTH, LENGTH, dtype=torch.bool, device=dev)
    keep[:, LENGTH - 13:] = torch.rand(ROWS // LENGTH, 13, generator=gen, device=dev) < 0.6
    split = split_block_weights(w)
    cases.append(("K2", lambda: fused_encoder_block(x, keep, w, HEADS, split=split),
                  fused_encoder_block_plain(x, keep, w, HEADS)))
    return cases


def _mean_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv: Sequence[str] = ()) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    args = parser.parse_args(list(argv))
    names = [v for v in args.variants.split(",") if v]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise ValueError(f"unknown variants {unknown}; known: {sorted(VARIANTS)}")
    dev = resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card_line(dev), flush=True)
    libs = {"shipped": _build.load("fused_block")}
    for name, path in build_variants(names, _build.BUILD_DIR / "variants").items():
        libs[name] = ctypes.CDLL(str(path))
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
                    times[label][name].append(_mean_ms(call, args.iters))
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
