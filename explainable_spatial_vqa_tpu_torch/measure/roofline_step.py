"""The composite matmul bound of one executor chain step at serving shapes,
the counterpart of ``scripts/roofline_step.py``.

    python -m explainable_spatial_vqa_tpu_torch.measure.roofline_step
        [--batch 128] [--iters 16] [--device cuda|cpu]

One chain step's products fall into 15 classes (:func:`matmul_classes`,
``roofline_step.py:109-126``), each with its count per step.  Each class is
timed alone in bf16 with ``torch.matmul``: ``--iters`` chained applications
(each application's left operand is the last one's output, cut or widened
back to its K columns without a copy) between two CUDA events, the best of
3; the sum of class time x count is the composite matmul bound.  In the port
four products of the fusion encoder run inside K2 (``fused_encoder_block``),
on its own GEMM (``ops.block_gemm``, the kernel ``esv_block_gemm``): QKV
(N=3d), the out product, FFN-up with its ReLU (bf16 out) and FFN-down.  They
are timed again through that GEMM, ``--iters`` launches on the same operands
(its float32 output cannot feed the next launch without a cast), and stand
in a second column for the classes "enc QKVO", "enc FFN-up" and "enc
FFN-dn".  Then the measured depth-12 chain step (``chained_forward`` with
every chain 12 deep, CUDA events, best of 3) and its non-matmul overhead
over each bound.  It prints the markdown table, then one JSON object (the
JAX script prints the table only).
"""

from __future__ import annotations

import argparse
import math
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch

from explainable_spatial_vqa_tpu_torch.bench import best_seconds, build_pipeline, emit_json
from explainable_spatial_vqa_tpu_torch.bench_data import synth_questions
from explainable_spatial_vqa_tpu_torch.device import card_line, chip_peak_flops, resolve_device
from explainable_spatial_vqa_tpu_torch.infer.chain import chained_forward
from explainable_spatial_vqa_tpu_torch.ops.block_gemm import block_gemm

__all__ = ["KEYS", "MatmulClass", "matmul_classes", "K2_PRODUCTS", "chained_matmul", "main"]

DEPTH = 12  # the measured chain step's depth
# the last line's keys: the JAX script's table and totals, with K2's GEMM
KEYS = ("batch", "iters", "peak_flops", "classes", "k2_gemm_ms", "gflop_per_step",
        "composite_bound_ms", "composite_bound_k2_ms", "measured_step_ms",
        "non_matmul_overhead_ms")


class MatmulClass(NamedTuple):
    name: str
    m: int
    k: int
    n: int
    batch: int  # 1: one (m, k) x (k, n) product; else a batched product
    mult: int  # applications per chain step

    @property
    def flops(self) -> float:
        return 2.0 * self.batch * self.m * self.k * self.n


def matmul_classes(cfg, B: int) -> List[MatmulClass]:
    """One chain step's products at batch ``B`` with their counts per step,
    the JAX script's 15 classes (``roofline_step.py:109-126``)."""
    d, H, Q = cfg.d_model, cfg.num_heads, cfg.num_queries
    L = 1 + cfg.num_image_tokens + cfg.max_input_boxes + 3
    hd, ffn = d // H, 4 * d
    EL, DL = cfg.encoder_layers, cfg.box_decoder_layers
    S = cfg.max_input_boxes
    return [
        MatmulClass("enc QKVO  (BL,d)x(d,d)", B * L, d, d, 1, 4 * EL),
        MatmulClass(f"enc scores (B·H){L}x{hd}x{L}", L, hd, L, B * H, EL),
        MatmulClass(f"enc apply  (B·H){L}x{L}x{hd}", L, L, hd, B * H, EL),
        MatmulClass("enc FFN-up (BL,d)x(d,4d)", B * L, d, ffn, 1, EL),
        MatmulClass("enc FFN-dn (BL,4d)x(4d,d)", B * L, ffn, d, 1, EL),
        MatmulClass("dec self QKVO (BQ,d)x(d,d)", B * Q, d, d, 1, 4 * DL),
        MatmulClass(f"dec self attn (B·H){Q}x{hd}x{Q}", Q, hd, Q, B * H, 2 * DL),
        MatmulClass("dec cross q/out (BQ,d)x(d,d)", B * Q, d, d, 1, 2 * DL),
        MatmulClass("dec cross k+v (BL,d)x(d,d)", B * L, d, d, 1, 2 * DL),
        MatmulClass(f"dec cross scr (B·H){Q}x{hd}x{L}", Q, hd, L, B * H, DL),
        MatmulClass(f"dec cross apl (B·H){Q}x{L}x{hd}", Q, L, hd, B * H, DL),
        MatmulClass("dec FFN-up (BQ,d)x(d,4d)", B * Q, d, ffn, 1, DL),
        MatmulClass("dec FFN-dn (BQ,4d)x(4d,d)", B * Q, ffn, d, 1, DL),
        MatmulClass("box MLP L1 (B·10,4)x(4,d)", B * S, 4, d, 1, 1),
        MatmulClass("box MLP L2 (B·10,d)x(d,d)", B * S, d, d, 1, 1),
    ]


# K2's four products per encoder layer: name, N, K, ReLU, output type, and
# the class each stands in for
K2_PRODUCTS = (("qkv", 3, 1, False, torch.float32, "enc QKVO"),
               ("out", 1, 1, False, torch.float32, "enc QKVO"),
               ("ffn1", 4, 1, True, torch.bfloat16, "enc FFN-up"),
               ("ffn2", 1, 4, False, torch.float32, "enc FFN-dn"))


def chained_matmul(c: MatmulClass, device: torch.device,
                   dtype: torch.dtype = torch.bfloat16) -> Callable[[int], torch.Tensor]:
    """``run(iters)``: ``iters`` chained products of class ``c``.  The right
    operand is non-uniform ((i mod 13) * 0.02 / k, so values stay finite);
    the left is the last output cut to its first k columns (n >= k, a view)
    or written into the first n columns of a (m, k) buffer (n < k,
    alternating two buffers)."""
    lead = (c.batch,) if c.batch > 1 else ()
    rhs = ((torch.arange(c.batch * c.k * c.n, device=device) % 13).reshape(lead + (c.k, c.n))
           * (0.02 / c.k)).to(dtype)
    bufs = [torch.ones(lead + (c.m, c.k), dtype=dtype, device=device) for _ in range(2)]

    def run(iters: int) -> torch.Tensor:
        x = bufs[0]
        for i in range(iters):
            if c.n >= c.k:
                x = torch.matmul(x, rhs)[..., :c.k]
            else:
                nxt = bufs[(i + 1) % 2]
                torch.matmul(x, rhs, out=nxt[..., :c.n])
                x = nxt
        return x

    return run


def _timed(run: Callable[[int], object], iters: int, device: torch.device) -> float:
    """Best seconds per application over 3 runs of ``iters``, after a warm-up."""
    return best_seconds(lambda: run(iters), device, repeats=3) / iters


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    B = args.batch
    peak = chip_peak_flops(dev)
    print(card_line(dev), flush=True)

    pipe = build_pipeline(device=dev)
    cfg = pipe.exe_cfg
    d, L = cfg.d_model, 1 + cfg.num_image_tokens + cfg.max_input_boxes + 3
    print(f"\nshapes: B={B} L={L} d={d} H={cfg.num_heads} ffn={4 * d} Q={cfg.num_queries} "
          f"encoder x{cfg.encoder_layers} decoder x{cfg.box_decoder_layers}; peak "
          f"{peak / 1e12:.0f} TFLOP/s\n", flush=True)
    rows = []
    total_t = total_f = 0.0
    with torch.no_grad():
        for c in matmul_classes(cfg, B):
            t = _timed(chained_matmul(c, dev), args.iters, dev)
            rows.append(dict(name=c.name, mult=c.mult, gflop_per_step=c.flops * c.mult / 1e9,
                             ms_per_step=t * c.mult * 1e3, pct_peak=c.flops / t / peak * 100,
                             k2_ms_per_step=None))
            total_t += t * c.mult
            total_f += c.flops * c.mult
            print(f"  {c.name:36s} x{c.mult:2d}  {t * 1e3:7.3f} ms/app  "
                  f"{c.flops / t / 1e12:6.1f} TFLOP/s  ({c.flops / t / peak * 100:4.1f}% peak)",
                  flush=True)

        # K2's products through its own GEMM, at the fusion encoder's rows
        gen = torch.Generator(device="cpu").manual_seed(0)
        k2_ms = {}
        for name, n_mult, k_mult, relu, out_dtype, _cls in K2_PRODUCTS:
            n, k = n_mult * d, k_mult * d
            a = torch.randn(B * L, k, generator=gen).to(device=dev, dtype=torch.bfloat16)
            w = (torch.randn(n, k, generator=gen) / math.sqrt(k)).to(device=dev,
                                                                    dtype=torch.bfloat16)
            bias = torch.zeros(n, device=dev)

            def run(iters, a=a, w=w, bias=bias, relu=relu, out_dtype=out_dtype):
                for _ in range(iters):
                    y = block_gemm(a, w, bias, relu, out_dtype)
                return y

            t = _timed(run, args.iters, dev)
            k2_ms[name] = t * 1e3
            print(f"  K2 GEMM {name:5s} ({B * L},{k})x({k},{n}){' ReLU' if relu else ''}: "
                  f"{t * 1e3:7.3f} ms/app  {2.0 * B * L * k * n / t / 1e12:6.1f} TFLOP/s",
                  flush=True)
    by_class = {}
    for name, *_rest, cls in K2_PRODUCTS:
        by_class[cls] = by_class.get(cls, 0.0) + k2_ms[name] * cfg.encoder_layers
    total_k2 = 0.0
    for row in rows:
        cls = next((c for c in by_class if row["name"].startswith(c + " ")), None)
        if cls is not None:
            row["k2_ms_per_step"] = by_class[cls]
        total_k2 += row["ms_per_step"] if cls is None else by_class[cls]
    total_k2 /= 1e3

    print(f"\ncomposite matmul bound: {total_t * 1e3:.2f} ms/step ({total_f / 1e9:.1f} GFLOP -> "
          f"{total_f / total_t / 1e12:.1f} TFLOP/s, {total_f / total_t / peak * 100:.1f}% of "
          f"peak); with K2's GEMM for its products {total_k2 * 1e3:.2f} ms/step", flush=True)

    # the measured chain step: chained_forward with every chain DEPTH deep
    features, _questions, chains = synth_questions(B, cfg)
    img = torch.from_numpy(features[chains.image_index[:B] % features.shape[0]]).to(dev)
    fns = torch.from_numpy(chains.functions[:B, :DEPTH]).to(device=dev, dtype=torch.long)
    deps = torch.from_numpy(chains.deps[:B, :DEPTH]).to(device=dev, dtype=torch.long)
    nsteps = torch.full((B,), DEPTH, dtype=torch.long, device=dev)

    def full():
        state = chained_forward(pipe.executor, img, fns, deps, nsteps, cfg, DEPTH)
        return state.box_cache.float().sum()

    per_step = best_seconds(full, dev, repeats=3) / DEPTH
    print(f"measured chain step ({DEPTH} steps): {per_step * 1e3:.2f} ms/step "
          f"({total_f / per_step / 1e12:.1f} TFLOP/s, {total_f / per_step / peak * 100:.1f}% "
          f"of peak)")
    print(f"non-matmul overhead: {(per_step - total_t) * 1e3:.2f} ms/step "
          f"({(per_step / total_t - 1) * 100:.1f}% over the composite bound; "
          f"{(per_step - total_k2) * 1e3:.2f} ms/step over the bound with K2's GEMM)")

    print("\n| class | x | GFLOP/step | ms/step | % peak | K2 GEMM ms/step |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        k2 = "" if r["k2_ms_per_step"] is None else f"{r['k2_ms_per_step']:.3f}"
        print(f"| {r['name']} | {r['mult']} | {r['gflop_per_step']:.2f} | "
              f"{r['ms_per_step']:.3f} | {r['pct_peak']:.1f} | {k2} |")
    print(f"| **composite bound** | | {total_f / 1e9:.1f} | {total_t * 1e3:.2f} "
          f"| {total_f / total_t / peak * 100:.1f} | {total_k2 * 1e3:.2f} |")
    print(f"| **measured step** | | {total_f / 1e9:.1f} | {per_step * 1e3:.2f} "
          f"| {total_f / per_step / peak * 100:.1f} | |", flush=True)

    result = {"batch": B, "iters": args.iters, "peak_flops": peak, "classes": rows,
              "k2_gemm_ms": k2_ms, "gflop_per_step": total_f / 1e9,
              "composite_bound_ms": total_t * 1e3, "composite_bound_k2_ms": total_k2 * 1e3,
              "measured_step_ms": per_step * 1e3,
              "non_matmul_overhead_ms": (per_step - total_t) * 1e3}
    return emit_json(result)


if __name__ == "__main__":
    main()
