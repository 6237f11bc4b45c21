#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py        (from the root of a checkout; needs one CUDA card)

Phases, each printing its own line; the first failure exits non-zero with no
result:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``explainable_spatial_vqa_tpu_torch/csrc`` with
   ``nvcc`` into ``explainable_spatial_vqa_tpu_torch/_build/``;
3. each kernel against its plain PyTorch version on the card, in bf16 and in
   float32 (TF32 off), with each error beside its tolerance: K1; K2 at the
   fusion encoder's shape; K3 at the block bench's (L=224, ``batch_tile=2,
   ffn_chunks=2``).  In bf16, every element and the mean error are held
   (``bf16_agreement``), and each block kernel's check has a negative control
   that must fail it: the other block kernel's plain version (K3 rounds q, k
   and v to bf16, K2 keeps them float32);
4. times at those shapes: kernel, plain version, one PyTorch library call
   computing the same function (a yardstick the port never calls), and the
   least time the card could take (its bound);
5. the block-bench path: ``bench_block.main`` at B=128, which launches K3
   through its entry point beside K2 and the unfused ``EncoderBlock``;
6. the main path at full width (bench.py's widths, bf16, ``box_roi`` and
   per-function thresholds): ``InferencePipeline.run`` end to end through the
   128-slot pool on synthetic questions, timed over a few repeats.  The
   generator's random weights emit programs that mostly do not parse, so the
   generator runs at its full cost and the pipeline is handed the synthetic
   CLEVR-shaped programs, which it decodes, parses and executes.  Checks every
   program and answer and that the kernels carried the executor; then one
   more run under ``torch.profiler`` for the card's busy share, the host's
   waits on the card and the kernels by device time;
7. the same pipeline in the ``"sorted"`` (the default) and ``"bucketed"``
   chain modes: questions/s over the same repeats and how many answers agree
   with the pool's;
8. one float32 executor forward on the card against the same module on the CPU;
9. the chain modes in float32 on 64 of the questions: ``"sorted"``,
   ``"bucketed"`` and ``"pool"`` must give equal answers;
10. the ``executor_roi_sim_count`` configuration (``roi_sim`` with 4 match
    maps and ``count_embed``, random non-zero weights): a float32 forward on
    the card against the CPU, and one ``"sorted"`` pipeline run in bf16.

The line before the last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
The script imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: tensor-core bf16, CUDA-core float32, HBM3.
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12

MAIN_QUESTIONS = 512
SLOTS = 128  # the pool's default, as InferencePipeline.run uses it
REPEATS = 5  # of the timed InferencePipeline.run
MODE_QUESTIONS = 64  # of the float32 comparison of the chain modes
K3_TILING = dict(batch_tile=2, ffn_chunks=2)


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    sys.exit(1)


def say(message: str) -> None:
    print(message, flush=True)


def timed_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(ops: dict, nbytes: float):
    """The larger of the operations' time (each type's count, {"bf16": n, ...},
    over that type's peak rate, summed) and the bytes over the memory rate, in
    ms, and which of the two it is."""
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items()) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def device_profile(torch, fn):
    """Run ``fn`` once under torch.profiler: (wall s, (share of the wall time in
    which a kernel or copy ran on the card, [(name, device ms)] by time, the
    number of times the host waited for the card)), or None for the profile
    when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return wall, None
    busy, end = 0.0, -math.inf
    for start, stop in spans:  # union of the device intervals, in us
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(((n, us / 1e3) for n, us in by_name.items()), key=lambda t: -t[1])
    syncs = sum(1 for e in prof.events()
                if e.device_type != DeviceType.CUDA and "Synchronize" in e.name)
    return wall, (busy / 1e6 / wall, top, syncs)


MEAN_ULPS = 0.05  # bf16 check: the largest mean error, in ulps of the reference


def bf16_agreement(torch, out, ref) -> dict:
    """How far a bf16 output lies from its bf16 plain version.

    The kernel and the plain version round the same float32 values, summed
    in another order, so an element differs only where a rounding, in it or
    in an operand on its way, fell on the other side: rarely, by one or two
    ulps of the element, and through a row's LayerNorm by about an ulp of a
    typical element.  So every element must be within 2 ulp(|ref|) +
    ulp(rms(ref)), and the mean error within ``MEAN_ULPS`` of the mean
    ulp(|ref|): other arithmetic (q, k, v rounded to bf16, say) moves most
    elements a little, and shows in the mean before it does in the largest.
    Returns the largest error, the largest excess over the element-wise
    limit, and the mean error in ulps."""
    ref = ref.float()
    err = (out.float() - ref).abs()
    _, exp = torch.frexp(ref)
    ulp = torch.where(ref == 0, 0.0, torch.ldexp(torch.ones_like(ref), exp - 8))
    _, rms_exp = torch.frexp(ref.square().mean().sqrt())
    limit = 2 * ulp + 2.0 ** (int(rms_exp) - 8)
    return dict(max_abs=float(err.max()), excess=float((err - limit).max()),
                mean_ulps=float(err.mean() / ulp.mean()))


def bf16_ok(stats: dict) -> bool:
    return stats["excess"] <= 0 and stats["mean_ulps"] <= MEAN_ULPS


def bf16_text(stats: dict) -> str:
    return (f"max_abs_err {stats['max_abs']:.3g}, largest excess over 2 ulp(|ref|) + "
            f"ulp(rms) {stats['excess']:.3g} (tol 0), mean error {stats['mean_ulps']:.4f} ulp "
            f"(tol {MEAN_ULPS})")


def qkv_rounding(torch, x, keep, w, heads) -> None:
    """K3 rounds its float32 QKV sums to bf16, and a key or value rounded the
    other way moves the attention of every query of its sequence, so the
    kernel adds its tensor-core slices with Kahan's compensation.  Check on
    the kernel's own q/k/v (its scratch) that it rounds no more of them the
    other way from the float64 sum than float32 sums (cuBLAS, TF32 off) do."""
    from explainable_spatial_vqa_tpu_torch.ops import fused_block
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import DTYPE_CODES

    batch, length, d = x.shape
    rows, ffn, wdt = batch * length, w.ffn1.shape[0], w.qkv.dtype
    scratch = [torch.empty(rows, 3 * d, dtype=wdt, device=x.device),
               torch.empty(rows, d, dtype=wdt, device=x.device),
               torch.empty(rows, d, device=x.device), torch.empty(rows, d, device=x.device),
               torch.empty(rows // K3_TILING["ffn_chunks"], ffn, dtype=wdt, device=x.device)]
    fused_block._launch(fused_block.fused_encoder_block_tiled, "esv_encoder_block_tiled", x, keep,
                        w, scratch, (batch, length, d, heads, ffn, K3_TILING["ffn_chunks"],
                                     DTYPE_CODES[x.dtype], DTYPE_CODES[wdt]))
    xr = x.reshape(rows, d)
    exact = ((xr.double() @ w.qkv.double().t()).float() + w.qkv_bias).to(wdt)
    f32 = (xr.float() @ w.qkv.float().t() + w.qkv_bias).to(wdt)
    kernel_share = float((scratch[0] != exact).float().mean())
    f32_share = float((f32 != exact).float().mean())
    say(f"phase 3 K3 q/k/v rounded to bf16 the other way from the float64 sum: kernel "
        f"{kernel_share:.2e} of them, float32 sums {f32_share:.2e}")
    if not kernel_share <= f32_share:
        fail("K3's QKV sums round more q/k/v the other way than float32 sums do")


def postfix_ids(chains, token_ids: dict, function_ids: dict, length: int):
    """Each chain's program as the generator spells one: its nodes in postfix
    order (children first, then the node), <END>, then <NULL> padding."""
    import numpy as np

    names = {i: name for name, i in function_ids.items()}
    out = np.zeros((len(chains.num_steps), length), np.int64)
    for i, steps in enumerate(chains.num_steps):
        order = []

        def visit(step):
            for dep in chains.deps[i, step]:
                if dep >= 0:
                    visit(dep)
            order.append(step)

        visit(steps - 1)
        ids = [token_ids[names[chains.functions[i, s]]] for s in order] + [token_ids["<END>"]]
        out[i, :min(len(ids), length)] = ids[:length]
    return out


def main() -> None:
    if not (REPO / "explainable_spatial_vqa_tpu_torch" / "csrc").is_dir():
        fail(f"no checkout of the repository next to {Path(__file__).name}")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from explainable_spatial_vqa_tpu_torch.ops import _build
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        BlockWeights,
        fused_encoder_block,
        fused_encoder_block_plain,
        fused_encoder_block_tiled,
        fused_encoder_block_tiled_plain,
    )

    dev = torch.device("cuda")

    # ---- 1. the card ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi.stdout.strip().splitlines()[0])
    say(f"phase 1 torch {torch.__version__}, CUDA {torch.version.cuda}, Python "
        f"{sys.version.split()[0]}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    libs = _build.build(["fused_attention", "fused_block"])
    build_s = time.perf_counter() - t0
    regs, spills = [], []
    for name in libs:
        for line in (_build.BUILD_DIR / f"{name}.log").read_text().splitlines():
            if "registers" in line:
                regs.append(int(line.split("Used")[1].split("registers")[0]))
            if "spill stores" in line:
                spills.append(int(line.split("bytes spill stores")[0].split(",")[-1]))
    say(f"phase 2 build: {build_s:.1f} s for {', '.join(sorted(libs))} "
        f"({len(regs)} kernels, at most {max(regs)} registers, {max(spills)} bytes spilled)")

    # ---- 3 and 4. kernels against their plain versions; times ----
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def ragged_keep(batch, length, tail):
        """Key mask keeping all but a random subset of the last ``tail`` keys."""
        keep = torch.ones(batch, length, dtype=torch.bool, device=dev)
        keep[:, length - tail:] = torch.rand(batch, tail, generator=gen, device=dev) < 0.6
        return keep

    results = {}
    names = {torch.bfloat16: "bf16", torch.float32: "fp32"}

    # K1 at the box decoder's shape (L=10, no mask: the main path) and the fusion
    # encoder's (L=210, ragged masks), bf16 and fp32
    b, h, d_head = SLOTS, 4, 128
    for length, masked in ((10, False), (10, True), (210, True)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (randn(b, length, h, d_head, dtype=dtype) for _ in range(3))
            mask = ragged_keep(b, length, min(length, 13))[:, None, None, :] if masked else None
            out = fused_attention(q, k, v, mask)
            ref = dot_product_attention(q, k, v, mask)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            head = (f"phase 3 K1 fused_attention {names[dtype]} B={b} H={h} L={length} "
                    f"D={d_head} mask={'ragged' if masked else 'none'}:")
            if dtype == torch.bfloat16:
                stats = bf16_agreement(torch, out, ref)
                say(f"{head} {bf16_text(stats)}")
                ok = bf16_ok(stats)
            else:
                say(f"{head} max_abs_err {err:.3g} (tol 1e-5)")
                ok = err <= 1e-5
            if not ok:
                fail("K1 disagrees with its plain version")
            if not (dtype == torch.bfloat16 and (length, masked) in ((10, False), (210, True))):
                continue  # time the main path's calls: bf16, L=10 unmasked and L=210 masked
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            ms = timed_ms(torch, lambda: fused_attention(q, k, v, mask))
            plain = timed_ms(torch, lambda: dot_product_attention(q, k, v, mask))
            lib = timed_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
            elems = b * length * h * d_head
            bnd, by = bound_ms({"bf16": 4.0 * b * h * length * length * d_head},
                               4 * elems * 2 + (b * length * 4 if masked else 0))
            say(f"phase 4 K1 fused_attention bf16 L={length}: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms, bound {bnd:.4f} ms "
                f"({by})")
            results[f"K1_L{length}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                                            bound_by=by, library_ms=lib)

    # K2 at the fusion encoder's shape and K3 at the block bench's, bf16 and
    # fp32.  Each block kernel's bf16 check has a negative control, the other
    # kernel's plain version: K3's arithmetic rounds q, k and v to bf16 after
    # the bias, K2's keeps them float32; the check must see the difference.
    def k3(x, keep, w, h):
        return fused_encoder_block_tiled(x, keep, w, h, **K3_TILING)

    def k3_plain(x, keep, w, h):
        return fused_encoder_block_tiled_plain(x, keep, w, h, **K3_TILING)

    d, ffn = 512, 2048
    blocks = (
        # name, kernel, plain, control, L, attention on float32 q/k/v
        ("K2", "fused_encoder_block", fused_encoder_block, fused_encoder_block_plain, k3_plain,
         210, True),
        ("K3", f"fused_encoder_block_tiled {K3_TILING}", k3, k3_plain, fused_encoder_block_plain,
         224, False),
    )
    for key, label, kernel, plain_fn, control_fn, length, f32_attention in blocks:
        keep = ragged_keep(b, length, 13)
        for dtype in (torch.bfloat16, torch.float32):
            w = BlockWeights(
                randn(3 * d, d, scale=d ** -0.5, dtype=dtype), randn(3 * d, scale=0.02),
                randn(d, d, scale=d ** -0.5, dtype=dtype), randn(d, scale=0.02),
                randn(ffn, d, scale=d ** -0.5, dtype=dtype), randn(ffn, scale=0.02),
                randn(d, ffn, scale=ffn ** -0.5, dtype=dtype), randn(d, scale=0.02),
                1 + randn(d, scale=0.1), randn(d, scale=0.1), 1 + randn(d, scale=0.1),
                randn(d, scale=0.1))
            x = randn(b, length, d, dtype=dtype)
            out = kernel(x, keep, w, h)
            ref = plain_fn(x, keep, w, h)
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            head = (f"phase 3 {key} {label} {names[dtype]} B={b} L={length} d={d} H={h} "
                    f"ffn={ffn} mask=ragged:")
            if dtype == torch.bfloat16:
                stats = bf16_agreement(torch, out, ref)
                say(f"{head} {bf16_text(stats)}")
                if not bf16_ok(stats):
                    fail(f"{key} disagrees with its plain version")
                control = bf16_agreement(torch, control_fn(x, keep, w, h), ref)
                other = "K3" if key == "K2" else "K2"
                say(f"phase 3 {key} negative control, {other}'s plain version "
                    f"({'bf16' if key == 'K2' else 'float32'} q/k/v): {bf16_text(control)}: "
                    f"{'passes' if bf16_ok(control) else 'fails'}")
                if bf16_ok(control):
                    fail(f"the bf16 check cannot tell {other}'s arithmetic from {key}'s")
                if key == "K3":
                    qkv_rounding(torch, x, keep, w, h)
            else:
                # sums of up to 2048 products taken in another order, through
                # four chained products and two LayerNorms
                say(f"{head} max_abs_err {err:.3g} (tol 1e-4)")
                if not err <= 1e-4:
                    fail(f"{key} disagrees with its plain version")
            layer = torch.nn.TransformerEncoderLayer(
                d, h, ffn, dropout=0.0, activation="relu", batch_first=True, norm_first=False,
                layer_norm_eps=1e-6).eval()
            with torch.no_grad():
                layer.self_attn.in_proj_weight.copy_(w.qkv.float())
                layer.self_attn.in_proj_bias.copy_(w.qkv_bias)
                layer.self_attn.out_proj.weight.copy_(w.out.float())
                layer.self_attn.out_proj.bias.copy_(w.out_bias)
                layer.linear1.weight.copy_(w.ffn1.float())
                layer.linear1.bias.copy_(w.ffn1_bias)
                layer.linear2.weight.copy_(w.ffn2.float())
                layer.linear2.bias.copy_(w.ffn2_bias)
                layer.norm1.weight.copy_(w.ln1_scale)
                layer.norm1.bias.copy_(w.ln1_bias)
                layer.norm2.weight.copy_(w.ln2_scale)
                layer.norm2.bias.copy_(w.ln2_bias)
            layer = layer.to(device=dev, dtype=dtype)
            pad = ~keep

            def library():
                with torch.no_grad():
                    return layer(x, src_key_padding_mask=pad)

            lib_out = library()
            lib_err = (bf16_text(bf16_agreement(torch, lib_out, ref)) if dtype == torch.bfloat16
                       else f"max_abs_err {float((lib_out - ref).abs().max()):.3g}")
            del lib_out
            ms = timed_ms(torch, lambda: kernel(x, keep, w, h), iters=10)
            plain = timed_ms(torch, lambda: plain_fn(x, keep, w, h), iters=10)
            lib = timed_ms(torch, library, iters=10)
            esize = 2 if dtype == torch.bfloat16 else 4
            rows = b * length
            # the four products in the weights' type; the attention at the
            # float32 rate on K2's float32 q, k, v, in the weights' type on K3's
            gemm_ops = rows * (2.0 * d * 3 * d + 2 * d * d + 4 * d * ffn)
            attn_ops = 4.0 * b * h * length * length * (d // h)
            ops = {names[dtype]: gemm_ops}
            attn_type = "fp32" if f32_attention else names[dtype]
            ops[attn_type] = ops.get(attn_type, 0.0) + attn_ops
            nbytes = (2 * rows * d * esize + (4 * d * d + 2 * d * ffn) * esize
                      + (3 * d + d + ffn + d + 4 * d) * 4 + rows * 4)
            bnd, by = bound_ms(ops, nbytes)
            say(f"phase 4 {key} {label} {names[dtype]} L={length}: kernel {ms:.3f} ms, plain "
                f"{plain:.3f} ms, nn.TransformerEncoderLayer {lib:.3f} ms (against the plain "
                f"version: {lib_err}), bound {bnd:.4f} ms ({by}; {gemm_ops / 1e9:.1f} GFLOP of "
                f"products at the {names[dtype]} rate {gemm_ops / PEAK_OPS[names[dtype]] * 1e3:.4f}"
                f" ms, {attn_ops / 1e9:.1f} GFLOP of attention at the {attn_type} rate), "
                f"{(gemm_ops + attn_ops) / ms / 1e9:.1f} TFLOP/s")
            results[f"{key}_{names[dtype]}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                                    bound_ms=bnd, bound_by=by, library_ms=lib)
            del layer, x, out, ref, w
    torch.cuda.empty_cache()
    main_path(torch, np, dev, results)


def main_path(torch, np, dev, results) -> None:
    """Phases 5 to 10, then the result lines."""
    from explainable_spatial_vqa_tpu_torch import bench_block
    from explainable_spatial_vqa_tpu_torch.bench_data import FUNCTION_IDS, synth_questions
    from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, GeneratorConfig
    from explainable_spatial_vqa_tpu_torch.infer.chain import ExecutorChainRunner
    from explainable_spatial_vqa_tpu_torch.infer.pipeline import (
        InferencePipeline,
        decode_program_ids,
        programs_to_chains,
    )
    from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
    from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        fused_encoder_block,
        fused_encoder_block_tiled,
    )

    wrappers = {w.__name__: w for w in (fused_attention, fused_encoder_block,
                                        fused_encoder_block_tiled)}

    def counted(fn):
        """``fn()`` with every launch count set to 0 just before it, and the
        counts just after: (its value, {kernel: launches})."""
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        value = fn()
        return value, {name: w.launches for name, w in wrappers.items()}

    class ScriptedPrograms(torch.nn.Module):
        """The generator, whose random weights emit programs that mostly do not
        parse: runs its greedy decode on the card at its full cost, then hands
        the pipeline the synthetic programs instead, which parse into
        CLEVR-shaped chains."""

        def __init__(self, generator, program_ids):
            super().__init__()
            self.generator = generator
            self.program_ids = program_ids

        def generate(self, questions):
            decoded = self.generator.generate(questions)
            return torch.as_tensor(self.program_ids, device=decoded.device)

    # ---- 5. the block-bench path: K3 through its entry point ----
    bench_rows, bench_launches = counted(
        lambda: bench_block.main(["--batches", "128", "--iters", "5"]))
    say("phase 5 block bench, bench_block.main --batches 128 --iters 5 (bf16, L=224, no mask): "
        + "; ".join(f"{name} {ms:.3f} ms {tflops:.1f} TFLOP/s"
                    for _b, name, ms, tflops in bench_rows)
        + f"; launches {bench_launches}")
    if not bench_launches["fused_encoder_block_tiled"] > 0:
        fail("the block bench did not launch K3")

    # ---- 6. the main path at full width ----
    gen_cfg = GeneratorConfig(vocab_size=96, program_vocab_size=45, program_len=27)
    exe_cfg = ExecutorConfig(vocab_size=64, token_classes=32, box_roi=True)
    dtype = torch.bfloat16
    generator = init_parameters(ProgramGenerator(gen_cfg, dtype, device=dev), seed=1)
    executor = init_parameters(ProgramExecutor(exe_cfg, dtype, device=dev), seed=2)
    thresholds = np.random.RandomState(3).uniform(0.3, 0.7, exe_cfg.vocab_size).astype(np.float32)
    runner = ExecutorChainRunner(executor, exe_cfg, max_steps=27, conf_thresholds=thresholds,
                                 device=dev)
    idx_to_token = dict(enumerate(["<NULL>", "<START>", "<END>"] + sorted(FUNCTION_IDS)))
    token_ids = {t: i for i, t in idx_to_token.items()}
    features, questions, chains = synth_questions(MAIN_QUESTIONS, exe_cfg, max_steps=27, seed=0)
    scripted = postfix_ids(chains, token_ids, FUNCTION_IDS, gen_cfg.program_len)
    pipeline = InferencePipeline(ScriptedPrograms(generator, scripted), runner, idx_to_token,
                                 FUNCTION_IDS, device=dev)
    features_dev = torch.from_numpy(features).to(dev)
    questions_dev = torch.from_numpy(questions).to(dev)
    forwards = [0]

    def count_forwards(module, *_):
        forwards[0] += 1

    def repeats(mode):
        """``REPEATS`` timed runs of the pipeline in ``mode`` after a warm-up
        (the first call also sets up cuBLAS and the allocator's pools): the
        results, the host-clock seconds of each (run returns numpy, so its
        work is done), the executor forwards and the launches."""
        pipeline.run(questions, features_dev, chains.image_index, chain_mode=mode)
        forwards[0] = 0
        seconds = []

        def timed_runs():
            out = []
            for _ in range(REPEATS):
                t0 = time.perf_counter()
                out.append(pipeline.run(questions, features_dev, chains.image_index,
                                        chain_mode=mode))
                seconds.append(time.perf_counter() - t0)
            return out

        runs, counts = counted(timed_runs)
        return runs, seconds, forwards[0], counts

    def launch_checks(counts, n_forwards, cfg):
        return {
            "K2 launches == 3 x executor forwards": (
                counts["fused_encoder_block"] == cfg.encoder_layers * n_forwards),
            "K1 launches == 2 x executor forwards (box decoder self-attention)": (
                counts["fused_attention"] == cfg.box_decoder_layers * n_forwards > 0),
        }

    def median(seconds):
        return sorted(seconds)[len(seconds) // 2]

    hook = executor.register_forward_hook(count_forwards)
    results_run, run_s, main_forwards, launches = repeats("pool")
    result = results_run[0]

    # the same work in its parts, once, for where the time goes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    program_ids = generator.generate(questions_dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    parsed = programs_to_chains(decode_program_ids(scripted, idx_to_token), chains.image_index,
                                FUNCTION_IDS, runner.max_steps)
    t2 = time.perf_counter()
    out = runner.run_pool(features_dev, parsed)  # the pipeline's default: SLOTS
    t3 = time.perf_counter()

    n = MAIN_QUESTIONS
    useful = int(chains.num_steps.sum())
    iterations = main_forwards // REPEATS
    checks = {
        "the generator's ids (N, 27) in the program vocabulary": (
            tuple(program_ids.shape) == (n, 27) and 0 <= int(program_ids.min())
            and int(program_ids.max()) < gen_cfg.program_vocab_size),
        "every program parses into its chain: same depth and functions, none cut": (
            np.array_equal(parsed.num_steps, chains.num_steps)
            and np.array_equal(np.sort(parsed.functions, 1), np.sort(chains.functions, 1))
            and all(r.truncated == 0 and np.array_equal(r.program_ids, scripted)
                    for r in results_run)),
        "every answer equal across repeats and to run_pool on the parsed chains": all(
            np.array_equal(r.answers, out["final_tokens"])
            and np.array_equal(r.answer_valid, out["final_is_token"]) for r in results_run),
        "one answer per question in the token vocabulary": (
            out["final_tokens"].shape == (n,) and 0 <= out["final_tokens"].min()
            and out["final_tokens"].max() < exe_cfg.token_classes),
        "finite boxes and confidences in [0, 1]": all(
            np.isfinite(out[k]).all() and 0 <= out[k].min() and out[k].max() <= 1
            for k in ("box_cache", "conf_cache")),
        "pool iterations cover every chain step": (
            iterations * REPEATS == main_forwards and iterations >= math.ceil(useful / SLOTS)),
        **launch_checks(launches, main_forwards, exe_cfg),
    }
    say(f"phase 6 main path: InferencePipeline.run (pool, {SLOTS} slots) on {n} questions, "
        f"{useful} chain steps (mean depth {useful / n:.2f}), {REPEATS} repeats: median "
        f"{median(run_s):.3f} s = {n / median(run_s):.1f} questions/s (all, s: "
        f"{', '.join(f'{t:.3f}' for t in run_s)}); its parts, once: generate {t1 - t0:.3f} s, "
        f"decode + parse {t2 - t1:.3f} s, run_pool {t3 - t2:.3f} s; {iterations} pool "
        f"iterations; {int(result.answer_valid.sum())} token answers, "
        f"{int(out['token_branch'].sum())} steps routed to the token branch; launches "
        f"{launches} for {main_forwards} executor forwards")
    for name, ok in checks.items():
        if not ok:
            fail(f"main path check failed: {name}")

    # where the time goes: one more run under the profiler (its counts of
    # launches are not the main path's and are not read)
    wall, prof = device_profile(
        torch, lambda: pipeline.run(questions, features_dev, chains.image_index,
                                    chain_mode="pool"))
    if prof is None:
        say(f"phase 6 profile: InferencePipeline.run {wall:.3f} s under the profiler; device "
            f"time not measured (the profiler saw no device activity)")
    else:
        busy, top, syncs = prof
        total = sum(ms for _, ms in top)
        say(f"phase 6 profile: InferencePipeline.run {wall:.3f} s under the profiler, device "
            f"busy {busy:.3f} of it ({total:.1f} ms of kernels and copies), {syncs} host waits "
            f"on the card ({syncs / iterations:.2f} per pool iteration); by device time: "
            + "; ".join(f"{name[:70]} {ms:.1f} ms" for name, ms in top[:10]))

    # ---- 7. the sorted (default) and bucketed chain modes, bf16 ----
    for mode in ("sorted", "bucketed"):
        runs, seconds, mode_forwards, counts = repeats(mode)
        agree = int(np.sum((runs[0].answers == result.answers)
                           & (runs[0].answer_valid == result.answer_valid)))
        say(f"phase 7 {mode}: InferencePipeline.run on {n} questions, {REPEATS} repeats: median "
            f"{median(seconds):.3f} s = {n / median(seconds):.1f} questions/s (all, s: "
            f"{', '.join(f'{t:.3f}' for t in seconds)}); {mode_forwards // REPEATS} executor "
            f"forwards per run; {agree} of {n} answers agree with the pool's (bf16: batches of "
            f"other sizes may round differently); launches {counts}")
        mode_checks = {
            "every answer equal across repeats": all(
                np.array_equal(r.answers, runs[0].answers)
                and np.array_equal(r.answer_valid, runs[0].answer_valid) for r in runs),
            "one answer per question in the token vocabulary": (
                runs[0].answers.shape == (n,) and 0 <= runs[0].answers.min()
                and runs[0].answers.max() < exe_cfg.token_classes),
            **launch_checks(counts, mode_forwards, exe_cfg),
        }
        for name, ok in mode_checks.items():
            if not ok:
                fail(f"{mode} check failed: {name}")
    hook.remove()
    del runner, pipeline, executor
    torch.cuda.empty_cache()

    # ---- 8. float32 forward on the card against the CPU ----
    rng = np.random.RandomState(5)
    lo = rng.rand(4, exe_cfg.max_input_boxes, 2) * 0.6
    inputs = [
        rng.rand(4, exe_cfg.num_image_tokens, exe_cfg.image_feature_dim).astype(np.float32),
        np.concatenate([lo, lo + rng.rand(4, exe_cfg.max_input_boxes, 2) * 0.4], -1).astype(
            np.float32),
        rng.rand(4, exe_cfg.max_input_boxes) < 0.5,
        rng.randint(0, exe_cfg.vocab_size, (4, 3)),
        np.array([[1, 1, 0], [1, 0, 1], [1, 1, 1], [1, 0, 0]], bool),
    ]

    def card_vs_cpu(model):
        """The largest difference over every output of one float32 forward
        on the card and on the CPU (only the order of sums differs)."""
        cpu_model = copy.deepcopy(model).to("cpu")
        with torch.no_grad():
            on_card = model(*(torch.from_numpy(a).to(dev) for a in inputs))
            on_cpu = cpu_model(*(torch.from_numpy(a) for a in inputs))
        return max(float((on_card[k].cpu() - on_cpu[k]).abs().max()) for k in on_cpu), on_cpu

    executor = init_parameters(ProgramExecutor(exe_cfg, torch.float32, device=dev), seed=4).eval()
    worst, on_cpu = card_vs_cpu(executor)
    say(f"phase 8 fp32 executor forward, card vs CPU: max_abs_err {worst:.3g} (tol 1e-4) over "
        f"{', '.join(sorted(on_cpu))}")
    if not worst <= 1e-4:
        fail(f"fp32 forward on the card disagrees with the CPU: {worst}")

    # ---- 9. the chain modes agree in float32 ----
    m_features, m_questions, m_chains = synth_questions(MODE_QUESTIONS, exe_cfg, max_steps=27,
                                                        seed=6)
    m_runner = ExecutorChainRunner(executor, exe_cfg, max_steps=27, conf_thresholds=thresholds,
                                   device=dev)
    m_pipeline = InferencePipeline(
        ScriptedPrograms(generator, postfix_ids(m_chains, token_ids, FUNCTION_IDS,
                                                gen_cfg.program_len)),
        m_runner, idx_to_token, FUNCTION_IDS, device=dev)
    m_features_dev = torch.from_numpy(m_features).to(dev)
    by_mode = {mode: m_pipeline.run(m_questions, m_features_dev, m_chains.image_index,
                                    chain_mode=mode) for mode in ("sorted", "bucketed", "pool")}
    per_question = m_features_dev[torch.as_tensor(m_chains.image_index, device=dev).long()]
    steps = {"sorted": m_runner.run_sorted(per_question, m_chains),
             "bucketed": m_runner.run_bucketed(per_question, m_chains),
             "pool": m_runner.run_pool(m_features_dev, m_chains)}
    pool_answers, pool_steps = by_mode["pool"], steps["pool"]
    answers_equal = all(np.array_equal(r.answers, pool_answers.answers)
                        and np.array_equal(r.answer_valid, pool_answers.answer_valid)
                        for r in by_mode.values())
    decisions_equal = all(np.array_equal(o[k], pool_steps[k]) for o in steps.values()
                          for k in ("token_branch", "token_cache", "box_mask"))
    box_err = max(float(np.abs(o[k] - pool_steps[k]).max()) for o in steps.values()
                  for k in ("box_cache", "conf_cache"))
    say(f"phase 9 fp32 chain modes on {MODE_QUESTIONS} questions "
        f"({int(m_chains.num_steps.sum())} steps): sorted, bucketed and pool answers "
        f"{'equal' if answers_equal else 'DIFFER'} ({int(pool_answers.answer_valid.sum())} token "
        f"answers); per-step decisions (routing, tokens, box masks: "
        f"{int(pool_steps['token_branch'].sum())} token steps, "
        f"{int(pool_steps['box_mask'].sum())} confident boxes) "
        f"{'equal' if decisions_equal else 'DIFFER'}; boxes and confidences within "
        f"{box_err:.3g} (tol 1e-4)")
    if not (answers_equal and decisions_equal and box_err <= 1e-4):
        fail("the chain modes disagree in float32")
    del executor, m_runner, m_pipeline, m_features_dev, per_question
    torch.cuda.empty_cache()

    # ---- 10. the executor_roi_sim_count configuration ----
    rs_cfg = ExecutorConfig(vocab_size=64, token_classes=32, box_roi=True, roi_sim=True,
                            roi_sim_heads=4, count_embed=True)
    rs_executor = init_parameters(ProgramExecutor(rs_cfg, torch.float32, device=dev),
                                  seed=7).eval()
    if not (rs_executor.sim_embed.weight.abs().sum() > 0
            and rs_executor.count_embed.weight.abs().sum() > 0):
        fail("the roi_sim and count_embed channels are zero")
    worst, on_cpu = card_vs_cpu(rs_executor)
    say(f"phase 10 executor_roi_sim_count fp32 forward, card vs CPU: max_abs_err {worst:.3g} "
        f"(tol 1e-4) over {', '.join(sorted(on_cpu))}")
    if not worst <= 1e-4:
        fail(f"the roi_sim_count forward on the card disagrees with the CPU: {worst}")
    del rs_executor
    rs_executor = init_parameters(ProgramExecutor(rs_cfg, dtype, device=dev), seed=7)
    rs_runner = ExecutorChainRunner(rs_executor, rs_cfg, max_steps=27,
                                    conf_thresholds=thresholds, device=dev)
    rs_pipeline = InferencePipeline(ScriptedPrograms(generator, scripted), rs_runner,
                                    idx_to_token, FUNCTION_IDS, device=dev)
    forwards[0] = 0
    hook = rs_executor.register_forward_hook(count_forwards)
    t0 = time.perf_counter()
    rs_result, rs_counts = counted(
        lambda: rs_pipeline.run(questions, features_dev, chains.image_index))
    rs_s = time.perf_counter() - t0
    hook.remove()
    say(f"phase 10 executor_roi_sim_count bf16: InferencePipeline.run (default mode, sorted) on "
        f"{n} questions, one run with no warm-up: {rs_s:.3f} s; {forwards[0]} executor "
        f"forwards; {int(rs_result.answer_valid.sum())} token answers; launches {rs_counts}")
    rs_checks = {
        "one answer per question in the token vocabulary": (
            rs_result.answers.shape == (n,) and 0 <= rs_result.answers.min()
            and rs_result.answers.max() < rs_cfg.token_classes),
        **launch_checks(rs_counts, forwards[0], rs_cfg),
    }
    for name, ok in rs_checks.items():
        if not ok:
            fail(f"executor_roi_sim_count check failed: {name}")

    sources = (
        ("fused_attention", "explainable_spatial_vqa_tpu_torch/csrc/fused_attention.cu",
         "explainable_spatial_vqa_tpu/ops/pallas_attention.py:45", "K1_L10", launches),
        ("fused_encoder_block", "explainable_spatial_vqa_tpu_torch/csrc/fused_block.cu",
         "explainable_spatial_vqa_tpu/ops/pallas_block.py:113", "K2_bf16", launches),
        ("fused_encoder_block_tiled", "explainable_spatial_vqa_tpu_torch/csrc/fused_block.cu",
         "explainable_spatial_vqa_tpu/ops/pallas_block.py:197", "K3_bf16", bench_launches),
    )
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep, launches=counts[name],
                    **results[key]) for name, src, rep, key, counts in sources]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
