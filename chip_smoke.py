#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py        (from the root of a checkout; needs one CUDA card)

Phases, each printing its own line; the first failure exits non-zero with no
result:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``explainable_spatial_vqa_tpu_torch/csrc`` with
   ``nvcc`` into ``explainable_spatial_vqa_tpu_torch/_build/``;
3. each kernel against its plain PyTorch version on the card, in bf16 and in
   float32 (TF32 off), with each error beside its tolerance; in bf16, every
   element and the mean error are held (``bf16_agreement``), and K2's plain
   version with bf16 q/k/v, a negative control, must fail that check;
4. times at the main path's shapes: kernel, plain version, one PyTorch library
   call computing the same function (a yardstick the port never calls), and
   the least time the card could take (its bound);
5. the main path at full width (bench.py's widths, bf16, ``box_roi`` and
   per-function thresholds): ``InferencePipeline.run`` end to end through the
   128-slot pool on synthetic questions, timed over a few repeats.  The
   generator's random weights emit programs that mostly do not parse, so the
   generator runs at its full cost and the pipeline is handed the synthetic
   CLEVR-shaped programs, which it decodes, parses and executes.  Checks every
   program and answer and that the kernels carried the executor; then one
   more run under ``torch.profiler`` for the card's busy share, the host's
   waits on the card and the kernels by device time;
6. one float32 executor forward on the card against the same module on the CPU.

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
from unittest import mock

REPO = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet, dense: tensor-core bf16, CUDA-core float32, HBM3.
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12

MAIN_QUESTIONS = 512
SLOTS = 128  # the pool's default, as InferencePipeline.run uses it
REPEATS = 5  # of the timed InferencePipeline.run


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
    from explainable_spatial_vqa_tpu_torch.ops import fused_block as fused_block_module
    from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
        BlockWeights,
        fused_encoder_block,
        fused_encoder_block_plain,
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

    # K2 at the fusion encoder's shape, bf16 and fp32
    d, ffn, length = 512, 2048, 210
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
        out = fused_encoder_block(x, keep, w, h)
        ref = fused_encoder_block_plain(x, keep, w, h)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        head = (f"phase 3 K2 fused_encoder_block {names[dtype]} B={b} L={length} d={d} H={h} "
                f"ffn={ffn} mask=ragged:")
        if dtype == torch.bfloat16:
            stats = bf16_agreement(torch, out, ref)
            say(f"{head} {bf16_text(stats)}")
            if not bf16_ok(stats):
                fail("K2 disagrees with its plain version")
            # negative control: the plain version with q, k and v rounded to
            # bf16 before the attention (the tiled TPU kernel's arithmetic, not
            # _block_kernel's) must fail the same check
            def rounded_qkv(q, k, v, mask):
                return dot_product_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), mask)

            with mock.patch.object(fused_block_module, "dot_product_attention", rounded_qkv):
                control = bf16_agreement(torch, fused_encoder_block_plain(x, keep, w, h), ref)
            say(f"phase 3 K2 negative control, plain version with bf16 q/k/v: "
                f"{bf16_text(control)}: {'passes' if bf16_ok(control) else 'fails'}")
            if bf16_ok(control):
                fail("the bf16 check cannot tell bf16 q/k/v from K2's float32 q/k/v")
        else:
            # sums of up to 2048 products taken in another order, through four
            # chained products and two LayerNorms
            say(f"{head} max_abs_err {err:.3g} (tol 1e-4)")
            if not err <= 1e-4:
                fail("K2 disagrees with its plain version")
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
        ms = timed_ms(torch, lambda: fused_encoder_block(x, keep, w, h), iters=10)
        plain = timed_ms(torch, lambda: fused_encoder_block_plain(x, keep, w, h), iters=10)
        lib = timed_ms(torch, library, iters=10)
        esize = 2 if dtype == torch.bfloat16 else 4
        rows = b * length
        # the four products in the weights' type; the attention on float32 q, k, v
        # (as _block_kernel computes it) at the float32 rate
        gemm_ops = rows * (2.0 * d * 3 * d + 2 * d * d + 4 * d * ffn)
        attn_ops = 4.0 * b * h * length * length * (d // h)
        ops = {names[dtype]: gemm_ops}
        ops["fp32"] = ops.get("fp32", 0.0) + attn_ops
        nbytes = (2 * rows * d * esize + (4 * d * d + 2 * d * ffn) * esize
                  + (3 * d + d + ffn + d + 4 * d) * 4 + rows * 4)
        bnd, by = bound_ms(ops, nbytes)
        say(f"phase 4 K2 fused_encoder_block {names[dtype]}: kernel {ms:.3f} ms, plain "
            f"{plain:.3f} ms, nn.TransformerEncoderLayer {lib:.3f} ms (against the plain "
            f"version: {lib_err}), bound {bnd:.4f} ms ({by}; products alone at the "
            f"{names[dtype]} rate {gemm_ops / PEAK_OPS[names[dtype]] * 1e3:.4f} ms), "
            f"{(gemm_ops + attn_ops) / ms / 1e9:.1f} TFLOP/s")
        results[f"K2_{names[dtype]}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                             bound_ms=bnd, bound_by=by, library_ms=lib)
        del layer, x, out, ref, w
    torch.cuda.empty_cache()
    main_path(torch, np, dev, results)


def main_path(torch, np, dev, results) -> None:
    """Phases 5 and 6, then the result lines."""
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
    from explainable_spatial_vqa_tpu_torch.ops.fused_block import fused_encoder_block

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

    # ---- 5. the main path at full width ----
    gen_cfg = GeneratorConfig(vocab_size=96, program_vocab_size=45, program_len=27)
    exe_cfg = ExecutorConfig(vocab_size=64, token_classes=32, box_roi=True)
    dtype = torch.bfloat16
    generator = init_parameters(ProgramGenerator(gen_cfg, dtype, device=dev), seed=1)
    executor = init_parameters(ProgramExecutor(exe_cfg, dtype, device=dev), seed=2)
    thresholds = np.random.RandomState(3).uniform(0.3, 0.7, exe_cfg.vocab_size).astype(np.float32)
    runner = ExecutorChainRunner(executor, exe_cfg, max_steps=27, conf_thresholds=thresholds,
                                 device=dev)
    idx_to_token = dict(enumerate(["<NULL>", "<START>", "<END>"] + sorted(FUNCTION_IDS)))
    features, questions, chains = synth_questions(MAIN_QUESTIONS, exe_cfg, max_steps=27, seed=0)
    scripted = postfix_ids(chains, {t: i for i, t in idx_to_token.items()}, FUNCTION_IDS,
                           gen_cfg.program_len)
    pipeline = InferencePipeline(ScriptedPrograms(generator, scripted), runner, idx_to_token,
                                 FUNCTION_IDS, device=dev)
    features_dev = torch.from_numpy(features).to(dev)
    questions_dev = torch.from_numpy(questions).to(dev)

    def run():
        return pipeline.run(questions, features_dev, chains.image_index, chain_mode="pool")

    run()  # warm-up: the first call also sets up cuBLAS and the allocator's pools
    forwards = [0]
    hook = executor.register_forward_hook(lambda *_: forwards.__setitem__(0, forwards[0] + 1))
    torch.cuda.synchronize()
    fused_attention.launches = 0
    fused_encoder_block.launches = 0
    results_run, run_s = [], []  # host clock; run() returns numpy, so its work is done
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        results_run.append(run())
        run_s.append(time.perf_counter() - t0)
    launches = {"fused_attention": fused_attention.launches,
                "fused_encoder_block": fused_encoder_block.launches}
    main_forwards = forwards[0]
    hook.remove()
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
        "K2 launches == 3 x executor forwards": (
            launches["fused_encoder_block"] == exe_cfg.encoder_layers * main_forwards),
        "K1 launches == 2 x executor forwards (box decoder self-attention)": (
            launches["fused_attention"] == exe_cfg.box_decoder_layers * main_forwards > 0),
    }
    ordered = sorted(run_s)
    say(f"phase 5 main path: InferencePipeline.run (pool, {SLOTS} slots) on {n} questions, "
        f"{useful} chain steps (mean depth {useful / n:.2f}), {REPEATS} repeats: median "
        f"{ordered[REPEATS // 2]:.3f} s = {n / ordered[REPEATS // 2]:.1f} questions/s (all, s: "
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
    wall, prof = device_profile(torch, run)
    if prof is None:
        say(f"phase 5 profile: InferencePipeline.run {wall:.3f} s under the profiler; device "
            f"time not measured (the profiler saw no device activity)")
    else:
        busy, top, syncs = prof
        total = sum(ms for _, ms in top)
        say(f"phase 5 profile: InferencePipeline.run {wall:.3f} s under the profiler, device "
            f"busy {busy:.3f} of it ({total:.1f} ms of kernels and copies), {syncs} host waits "
            f"on the card ({syncs / iterations:.2f} per pool iteration); by device time: "
            + "; ".join(f"{name[:70]} {ms:.1f} ms" for name, ms in top[:10]))
    del generator, runner, pipeline, executor, features_dev
    torch.cuda.empty_cache()

    # ---- 6. float32 forward on the card against the CPU ----
    executor = init_parameters(ProgramExecutor(exe_cfg, torch.float32, device=dev), seed=4).eval()
    cpu_executor = copy.deepcopy(executor).to("cpu")
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
    with torch.no_grad():
        on_card = executor(*(torch.from_numpy(a).to(dev) for a in inputs))
        on_cpu = cpu_executor(*(torch.from_numpy(a) for a in inputs))
    worst = max(float((on_card[k].cpu() - on_cpu[k]).abs().max()) for k in on_cpu)
    # float32 on both sides; only the order of sums differs
    say(f"phase 6 fp32 executor forward, card vs CPU: max_abs_err {worst:.3g} (tol 1e-4) over "
        f"{', '.join(sorted(on_cpu))}")
    if not worst <= 1e-4:
        fail(f"fp32 forward on the card disagrees with the CPU: {worst}")

    sources = {"K1": ("fused_attention", "explainable_spatial_vqa_tpu_torch/csrc/fused_attention.cu",
                      "explainable_spatial_vqa_tpu/ops/pallas_attention.py:45", "K1_L10"),
               "K2": ("fused_encoder_block", "explainable_spatial_vqa_tpu_torch/csrc/fused_block.cu",
                      "explainable_spatial_vqa_tpu/ops/pallas_block.py:113", "K2_bf16")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
                    **results[key]) for name, src, rep, key in sources.values()]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
