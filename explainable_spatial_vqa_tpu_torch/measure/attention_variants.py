"""Variants of K1's one-pass bf16 kernel (``attention_kernel_onepass`` in
``csrc/attention.cuh``), each built from the shipped source by a textual
patch and timed beside it on the card.

    python -m explainable_spatial_vqa_tpu_torch.measure.attention_variants
        [--rounds 6] [--iters 20] [--variants ring,warps8,ieee_division,fast_exp]

Each variant asks one question of the shipped kernel (``VARIANTS``):

* ``ring``: no one-pass kernel, so that these calls take the cp.async ring
  (``attention_kernel<bf16, bf16, D, 8>``, two passes past 224 keys), the
  kernel they took before the one-pass kernel was added;
* ``warps8``: 8 warps a block (one block an SM at 218 registers a thread)
  instead of 4 (two blocks an SM);
* ``ieee_division``: each weight divided by ``/`` (the compiler's division,
  with its per-element range check and slow-path branch) instead of
  ``div_by``'s reciprocal taken once a row and one correction;
* ``fast_exp``: ``__expf`` (ex2.approx of x log2 e) instead of ``expf``.

The variants compile in parallel (``_build.compile_libraries``: every unit
of ``fused_attention.cu``, its C entries and each group of head dims, with
the package's flags and ``-I csrc``) into ``_build/attention_variants/``.  Each library's
``esv_attention`` runs K1 at the models' bf16 encoder shapes (``CASES``: the
Transformer IQAP's, the step seq2seq's and ``HierarchicalGenerator``'s at
head dim 64, the CoGenT protocol's fusion encoders at 48 and 24) through
the wrapper's ctypes call (``ops.fused_attention.call_entry``): first its largest
error against the plain version, then ``--rounds`` rounds of CUDA-event
means over ``--iters`` calls, the libraries in turn (reversed every other
round), and the medians.  It prints one line per library and one JSON object
(every round's time).  It needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import statistics
from pathlib import Path
from typing import Dict, List, Sequence

import torch

from explainable_spatial_vqa_tpu_torch.bench import emit_json
from explainable_spatial_vqa_tpu_torch.device import card_line, resolve_device
from explainable_spatial_vqa_tpu_torch.ops import _build

__all__ = ["VARIANTS", "CASES", "variant_source", "build_variants", "main"]

# label, head dim, B, L, ragged key mask; H = 4, bf16
CASES = (("transformer_iqap encoder", 64, 512, 243, False),
         ("step_seq2seq encoder", 64, 512, 246, True),
         ("hierarchical encoder", 64, 32, 196, False),
         ("protocol d 192 fusion encoder", 48, 128, 208, True),
         ("protocol d 96 fusion encoder", 24, 128, 208, True))
HEADS = 4

_DIV = ("          p[n][r] = pack_bf16x2(div_by(s[kt][n][2 * r], denom[r], inv[r]),\n"
        "                                div_by(s[kt][n][2 * r + 1], denom[r], inv[r]));\n")

# name: (old, new) replacements in attention.cuh, each old text found exactly once
VARIANTS: Dict[str, tuple] = {
    "ring": (("    if constexpr (D <= 64 && !kFmaScores) {", "    if constexpr (false) {"),),
    "warps8": (("constexpr int kOnePassWarps = 4;", "constexpr int kOnePassWarps = 8;"),),
    "ieee_division": ((_DIV, "          p[n][r] = pack_bf16x2(s[kt][n][2 * r] / denom[r],\n"
                             "                                s[kt][n][2 * r + 1] / denom[r]);\n"),),
    "fast_exp": (("s[kt][n][c] = expf(s[kt][n][c] - m[c / 2]);",
                  "s[kt][n][c] = __expf(s[kt][n][c] - m[c / 2]);"),),
}


def variant_source(name: str, source: str) -> str:
    """``source`` (``csrc/attention.cuh``'s text) with variant ``name``'s
    replacements; raises ValueError where one does not match exactly once."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} occurs {source.count(old)} times "
                             f"in attention.cuh, not once")
        source = source.replace(old, new)
    return source


def build_variants(names: Sequence[str], out_dir: Path) -> Dict[str, Path]:
    """Compile the ``fused_attention`` library (``fused_attention.cu`` with
    its head-dim units, ``_build.units``) against each variant's
    ``attention.cuh`` into ``out_dir``, every unit of every variant at once;
    {name: library}.  Raises with the compiler's output on a failure."""
    header = (_build.CSRC_DIR / "attention.cuh").read_text()
    unit = (_build.CSRC_DIR / "fused_attention.cu").read_text()
    jobs = {}
    for name in names:
        src_dir = out_dir / name  # its attention.cuh found first, common.cuh through -I
        src_dir.mkdir(parents=True, exist_ok=True)
        (src_dir / "attention.cuh").write_text(variant_source(name, header))
        (src_dir / "fused_attention.cu").write_text(unit)
        jobs[name] = ("fused_attention", out_dir / f"{name}.so", src_dir)
    _build.compile_libraries(jobs, include=[_build.CSRC_DIR])
    return {name: path for name, (_, path, _) in jobs.items()}


def _inputs(dev: torch.device):
    """[(label, (q, k, v, mask))] at ``CASES``, from seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for label, d_head, b, length, masked in CASES:
        q, k, v = (torch.randn(b, length, HEADS, d_head, generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        mask = None
        if masked:
            keep = torch.ones(b, length, dtype=torch.bool, device=dev)
            keep[:, length - 13:] = torch.rand(b, 13, generator=gen, device=dev) < 0.6
            mask = keep[:, None, None, :]
        out.append((label, (q, k, v, mask)))
    return out


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
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import bind_entry, call_entry

    libs = {"shipped": _build.load("fused_attention")}
    for name, path in build_variants(names, _build.BUILD_DIR / "attention_variants").items():
        libs[name] = ctypes.CDLL(str(path))
    calls = {label: functools.partial(call_entry, bind_entry(lib)) for label, lib in libs.items()}
    cases = _inputs(dev)
    errors: Dict[str, Dict[str, float]] = {label: {} for label in calls}
    for label, call in calls.items():
        for name, args_ in cases:
            out = call(*args_)
            ref = scaled_attention(*args_, bf16_scores=False)
            errors[label][name] = float((out.float() - ref.float()).abs().max())
    times: Dict[str, Dict[str, List[float]]] = {l: {c[0]: [] for c in cases} for l in calls}
    order = list(calls)
    for r in range(args.rounds):
        for label in order if r % 2 == 0 else order[::-1]:
            for name, args_ in cases:
                times[label][name].append(_mean_ms(lambda: calls[label](*args_), args.iters))
    result = {}
    for label in order:
        result[label] = {name: dict(ms=statistics.median(ts), rounds_ms=ts,
                                    max_abs_err=errors[label][name])
                         for name, ts in times[label].items()}
        print(f"{label}: " + "; ".join(
            f"{name} {v['ms']:.4f} ms, max_abs_err {v['max_abs_err']:.3g} against the plain "
            f"version" for name, v in result[label].items()), flush=True)
    return emit_json(dict(card=card_line(dev), rounds=args.rounds, iters=args.iters,
                          cases=[dict(label=c[0], D=c[1], B=c[2], L=c[3], ragged=c[4], H=HEADS)
                                 for c in CASES],
                          variants=result))


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
