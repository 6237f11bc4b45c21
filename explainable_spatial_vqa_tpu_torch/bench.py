"""End-to-end serving throughput of the port, the counterpart of the root
``bench.py``: CLEVR-shaped QA pairs per second on one card.

    python -m explainable_spatial_vqa_tpu_torch.bench [--device cuda|cpu]

Knobs, as in bench.py: ``BENCH_N`` (questions, 1024), ``BENCH_BATCH`` (slots
or batch rows, 128), ``BENCH_BASELINE_N`` (questions of the reference-style
loop, 32), ``BENCH_MODE`` (``pool`` or ``sorted``), ``BENCH_REPEATS`` (timed
runs after a warm-up, 2), ``BENCH_DTYPE`` (``bf16`` or ``fp32``),
``BENCH_PEAK_TFLOPS`` (the card's dense bf16 peak where
``device.CARD_PEAKS`` does not know it).

The measured path: the program generator's greedy decode of every question
at once (27 tokens; the generator cannot know a chain's depth before it has
decoded the program), then the executor's chains over the image-feature
cache on the card, either through the continuous-batching slot pool
(``chained_forward_pool``, ``pool``) or through depth-sorted batches that
each stop at their deepest chain (``plan_sorted`` + ``chained_forward``,
``sorted``).  A run ends when the programs and the answer token caches are
on the host.  The data are bench.py's (``bench_data.synth_questions``);
the weights are random, from a seed: throughput does not depend on them.

``value`` = N / the best run's seconds.  ``vs_baseline`` = value / the
questions/s of the reference-style loop: one question at a time, one step at
a time, batch 1, float32 on the CPU.  ``mfu`` = bench.py's analytic useful
FLOPs (actual chain depths; :func:`flop_components`) / the best run's
seconds / the card's dense bf16 peak (``device.chip_peak_flops``).

Before the last line it prints the card's name and power limit, every
repeat's seconds, K1's and K2's launches in one run, the FLOPs per question
as the generator is built (its upper encoder layers take h inputs, where
bench.py's formula counts 2h), and the host CPU and threads of the baseline.
The last line is one JSON object with bench.py's keys.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import platform
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.bench_data import synth_questions
from explainable_spatial_vqa_tpu_torch.core.config import ExecutorConfig, GeneratorConfig
from explainable_spatial_vqa_tpu_torch.device import card_line, chip_peak_flops, resolve_device
from explainable_spatial_vqa_tpu_torch.infer.chain import (
    ChainState,
    chained_forward,
    chained_forward_pool,
)
from explainable_spatial_vqa_tpu_torch.infer.plan import plan_sorted
from explainable_spatial_vqa_tpu_torch.models.executor import ProgramExecutor
from explainable_spatial_vqa_tpu_torch.models.generator import ProgramGenerator
from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import fused_attention
from explainable_spatial_vqa_tpu_torch.ops.fused_block import fused_encoder_block

__all__ = ["GEN_CFG", "EXE_CFG", "Q_LEN", "KEYS", "Pipeline", "build_pipeline", "flop_components",
           "analytic_flops_per_question", "DeviceData", "to_device", "generate_all", "pool_run",
           "sorted_plan", "sorted_run", "make_run_all", "best_seconds", "time_repeats",
           "run_vectorized", "reference_question", "run_reference_style", "host_cpu",
           "emit_json", "main"]

# bench.py:49-50: hidden 512, embed 300, 3+3 LSTM layers; d 512, 4 heads, 3
# encoder layers over 1 + 196 + 10 + 3 = 210 tokens, 10 queries
GEN_CFG = GeneratorConfig(vocab_size=96, program_vocab_size=45, program_len=27)
EXE_CFG = ExecutorConfig(vocab_size=64, token_classes=32)
Q_LEN = 46  # question tokens (bench_data.synth_questions)
# the last line's keys, bench.py's (bench.py:502-519)
KEYS = ("metric", "value", "unit", "vs_baseline", "baseline_n", "baseline_qps",
        "baseline_qps_jackknife_se", "mfu", "mean_chain_depth", "max_chain_depth",
        "gflops_per_question", "truncated_programs")


@dataclass
class Pipeline:
    generator: ProgramGenerator
    gen_cfg: GeneratorConfig
    executor: ProgramExecutor
    exe_cfg: ExecutorConfig
    device: torch.device


def build_pipeline(force_fp32: bool = False, device="cuda",
                   gen_cfg: Optional[GeneratorConfig] = None,
                   exe_cfg: Optional[ExecutorConfig] = None, seed: int = 0) -> Pipeline:
    """The generator and executor at bench.py's widths (or the given configs)
    with random weights from ``seed`` (``init_parameters``), in eval mode, in
    bf16 unless ``BENCH_DTYPE=fp32`` or ``force_fp32``."""
    dev = resolve_device(device)
    gen_cfg = GEN_CFG if gen_cfg is None else gen_cfg
    exe_cfg = EXE_CFG if exe_cfg is None else exe_cfg
    use_bf16 = os.environ.get("BENCH_DTYPE", "bf16") == "bf16" and not force_fp32
    dtype = torch.bfloat16 if use_bf16 else torch.float32
    generator = init_parameters(ProgramGenerator(gen_cfg, dtype, device=dev), seed)
    executor = init_parameters(ProgramExecutor(exe_cfg, dtype, device=dev), seed + 1)
    return Pipeline(generator.eval(), gen_cfg, executor.eval(), exe_cfg, dev)


def flop_components(gen_cfg: GeneratorConfig, exe_cfg: ExecutorConfig, q_len: int = Q_LEN,
                    as_built: bool = False) -> Dict[str, int]:
    """Per-question forward FLOPs (2*MACs, matmul terms only), bench.py's
    formula (``bench.py:183-228``): {gen_encode, gen_dec_step, exe_precompute,
    exe_step}.  bench.py counts the generator encoder's upper LSTM layers with
    2h inputs; ``as_built=True`` counts them as the generator is built, with
    h inputs (each layer takes the layer below's h outputs)."""
    h, e = gen_cfg.hidden_dim, gen_cfg.embed_dim

    def lstm(cin):
        return 2 * 4 * h * (cin + h)

    upper = h if as_built else 2 * h
    enc_step = 2 * (lstm(e) + (gen_cfg.encoder_layers - 1) * lstm(upper))
    dec_step = (lstm(e) + (gen_cfg.decoder_layers - 1) * lstm(h)
                + 2 * h * gen_cfg.program_vocab_size
                + 2 * 2 * q_len * h)  # Luong dot-product scores + context

    d = exe_cfg.d_model
    L = 1 + exe_cfg.num_image_tokens + exe_cfg.max_input_boxes + 3
    ffn = 4 * d
    enc_layer = 4 * 2 * L * d * d + 2 * 2 * L * L * d + 2 * 2 * L * d * ffn
    Q = exe_cfg.num_queries
    dec_layer = (4 * 2 * Q * d * d + 2 * 2 * Q * Q * d + 2 * 2 * Q * d * d
                 + 2 * 2 * L * d * d + 2 * 2 * Q * L * d + 2 * 2 * Q * d * ffn)
    per_step = (exe_cfg.encoder_layers * enc_layer + exe_cfg.box_decoder_layers * dec_layer
                + 2 * exe_cfg.max_input_boxes * d * (4 + d))  # box MLP
    precompute = 2 * exe_cfg.num_image_tokens * exe_cfg.image_feature_dim * d
    return {"gen_encode": q_len * enc_step, "gen_dec_step": dec_step,
            "exe_precompute": precompute, "exe_step": per_step}


def analytic_flops_per_question(gen_cfg: GeneratorConfig, exe_cfg: ExecutorConfig,
                                q_len: int = Q_LEN, steps: int = 1,
                                as_built: bool = False) -> int:
    """Forward FLOPs of one question with ``steps`` chain steps, bench.py's
    useful accounting: the encode, ``steps + 2`` decode steps (at most
    program_len), the image projection and ``steps`` executor steps."""
    c = flop_components(gen_cfg, exe_cfg, q_len, as_built)
    gen = c["gen_encode"] + min(gen_cfg.program_len, steps + 2) * c["gen_dec_step"]
    return gen + c["exe_precompute"] + steps * c["exe_step"]


class DeviceData(NamedTuple):
    features: torch.Tensor  # (M, P, C) float32, the per-image cache
    questions: torch.Tensor  # (N, 46) long
    image_index: torch.Tensor  # (N,) long
    functions: torch.Tensor  # (N, S) long
    deps: torch.Tensor  # (N, S, 2) long
    num_steps: torch.Tensor  # (N,) long
    max_steps: int


def to_device(features: np.ndarray, questions: np.ndarray, chains, device) -> DeviceData:
    """The feature cache, the questions and the chains on ``device``, once
    and whole (the card takes the 82 MB cache of N=1024 in one copy)."""
    def put(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)

    return DeviceData(put(features, torch.float32), put(questions, torch.long),
                      put(chains.image_index, torch.long), put(chains.functions, torch.long),
                      put(chains.deps, torch.long), put(chains.num_steps, torch.long),
                      int(chains.functions.shape[1]))


def generate_all(pipe: Pipeline, questions: torch.Tensor) -> torch.Tensor:
    """Every question's program in one greedy decode."""
    return pipe.generator.generate(questions)


def pool_run(pipe: Pipeline, data: DeviceData, slots: int) -> ChainState:
    """Every chain through one slot pool of ``slots``."""
    return chained_forward_pool(pipe.executor, data.features, data.image_index, data.functions,
                                data.deps, data.num_steps, pipe.exe_cfg, data.max_steps,
                                slots=slots)


def sorted_plan(num_steps: np.ndarray, batch: int,
                device) -> List[Tuple[torch.Tensor, int, int, int]]:
    """``plan_sorted``'s batches as (question rows on ``device``, depth, size, real)."""
    return [(torch.from_numpy(part).to(device=device, dtype=torch.long), depth, size, real)
            for depth, size, part, real in plan_sorted(num_steps, batch)]


def sorted_run(pipe: Pipeline, data: DeviceData, plan) -> List[ChainState]:
    """Each planned batch gathered on the card and run to its own depth
    (``bench.py:298-308``)."""
    states = []
    for sel, depth, _size, _real in plan:
        images = data.features.index_select(0, data.image_index.index_select(0, sel))
        states.append(chained_forward(
            pipe.executor, images, data.functions.index_select(0, sel),
            data.deps.index_select(0, sel), data.num_steps.index_select(0, sel), pipe.exe_cfg,
            data.max_steps, active_steps=depth))
    return states


def make_run_all(mode: str, pipe: Pipeline, data: DeviceData, batch: int,
                 num_steps: np.ndarray) -> Callable[[], Tuple[np.ndarray, List[np.ndarray]]]:
    """One serving run of ``mode``: (the programs, [the answer token caches])
    on the host.  ``pool`` gives one (N, S) cache, ``sorted`` one per batch."""
    if mode == "pool":
        def run_all():
            programs = generate_all(pipe, data.questions)
            state = pool_run(pipe, data, batch)
            return programs.cpu().numpy(), [state.token_cache.cpu().numpy()]
    elif mode == "sorted":
        plan = sorted_plan(num_steps, batch, pipe.device)

        def run_all():
            programs = generate_all(pipe, data.questions)
            states = sorted_run(pipe, data, plan)
            return programs.cpu().numpy(), [s.token_cache.cpu().numpy() for s in states]
    else:
        raise ValueError(f"unknown BENCH_MODE {mode!r}")
    return run_all


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_repeats(fn: Callable, repeats: int, device: torch.device) -> List[float]:
    """Host-clock seconds of ``repeats`` calls of ``fn``, the card
    synchronized before each clock read."""
    seconds = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        seconds.append(time.perf_counter() - t0)
    return seconds


def best_seconds(fn: Callable, device: torch.device, repeats: int = 5) -> float:
    """Best of ``repeats`` calls of ``fn`` after one warm-up: on the card the
    seconds between two CUDA events around each call (the host's launches
    included where the host is slower than the card), on the CPU the host
    clock."""
    fn()
    if device.type != "cuda":
        return min(time_repeats(fn, repeats, device))
    best = math.inf
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def run_vectorized(n: int, batch: int, device="cuda", mode: str = "pool"):
    """(N / the best run's seconds, stats) of ``mode`` over ``BENCH_REPEATS``
    (2) timed runs after a warm-up run."""
    pipe = build_pipeline(device=device)
    repeats = int(os.environ.get("BENCH_REPEATS", "2"))
    features, questions, chains = synth_questions(n, pipe.exe_cfg)
    num_steps = np.asarray(chains.num_steps)
    data = to_device(features, questions, chains, pipe.device)
    run_all = make_run_all(mode, pipe, data, batch, num_steps)

    run_all()  # warm-up: cuBLAS handles, the allocator's pools, the kernels' libraries
    kernels = {"K1": fused_attention, "K2": fused_encoder_block}
    before = {name: w.launches for name, w in kernels.items()}
    seconds = time_repeats(run_all, repeats, pipe.device)
    launches = {name: (w.launches - before[name]) // repeats for name, w in kernels.items()}
    best = min(seconds)
    useful = sum(analytic_flops_per_question(pipe.gen_cfg, pipe.exe_cfg, steps=int(s))
                 for s in num_steps)
    as_built = sum(analytic_flops_per_question(pipe.gen_cfg, pipe.exe_cfg, steps=int(s),
                                               as_built=True) for s in num_steps)
    stats = {
        "seconds": seconds,
        "launches_per_run": launches,
        "mean_chain_depth": float(num_steps.mean()),
        "max_chain_depth": int(num_steps.max()),
        "useful_flops_per_question": useful / n,
        "useful_flops_per_question_as_built": as_built / n,
        "flops_per_sec": useful / best,
        "truncated_programs": chains.truncated,
    }
    return n / best, stats


def reference_question(pipe: Pipeline, features: np.ndarray, questions: np.ndarray, chains,
                       i: int) -> Tuple[bool, int]:
    """The reference algorithm on question ``i``: its program decoded alone,
    then one batch-1 executor forward per step with the dependencies' outputs
    kept in host dicts.  Returns (the last step routed to the token head, its
    token).

    Each step's inputs follow the chain runners' rule
    (``infer.chain.gather_step_inputs``): both dependencies' box sets, valid
    boxes first, cut to ``max_input_boxes``; text [function, dep0's token,
    dep1's token] with a mask for each.  bench.py's loop packs them otherwise
    (the first dependency's ten boxes fill every slot; tokens packed to the
    front), so its answers can part from its vectorized run's; these equal
    the runners', at the same cost.  Each forward projects the raw image
    features again, as bench.py's loop does."""
    cfg, dev = pipe.exe_cfg, pipe.device
    q = torch.from_numpy(questions[i:i + 1]).to(device=dev, dtype=torch.long)
    pipe.generator.generate(q)
    image = torch.from_numpy(features[chains.image_index[i]][None]).to(dev)
    box_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    token_cache: Dict[int, int] = {}
    is_token, token = False, 0
    slots, queries = cfg.max_input_boxes, cfg.num_queries
    with torch.no_grad():
        for k in range(int(chains.num_steps[i])):
            boxes = np.zeros((2 * queries, 4), np.float32)
            valid = np.zeros(2 * queries, bool)
            text = np.zeros((1, 3), np.int64)
            tmask = np.zeros((1, 3), bool)
            text[0, 0], tmask[0, 0] = chains.functions[i, k], True
            for d in range(2):
                dep = int(chains.deps[i, k, d])
                if dep in box_cache:
                    boxes[d * queries:(d + 1) * queries], valid[d * queries:(d + 1) * queries] = \
                        box_cache[dep]
                if dep in token_cache:
                    text[0, 1 + d], tmask[0, 1 + d] = token_cache[dep], True
            order = np.argsort(~valid, kind="stable")[:slots]
            out = pipe.executor(
                image, torch.from_numpy(boxes[order][None]).to(dev),
                torch.from_numpy(valid[order][None]).to(dev), torch.from_numpy(text).to(dev),
                torch.from_numpy(tmask).to(dev))
            is_token = int(torch.argmax(out["routing_logits"][0])) == 1
            if is_token:
                token = int(torch.argmax(out["token_logits"][0]))
                token_cache[k] = token
            else:
                box_cache[k] = (out["pred_boxes"][0].float().cpu().numpy(),
                                (out["pred_conf"][0] >= cfg.conf_threshold).cpu().numpy())
    return is_token, token if is_token else 0


def run_reference_style(n_questions: int, device="cpu", pipe: Optional[Pipeline] = None):
    """(questions/s, its leave-one-out jackknife SE, [(is_token, token)] per
    question) of the reference algorithm in float32 on ``device`` (the CPU,
    the reference's deployment), on bench.py's baseline questions (seed 1),
    best of two timed sweeps per question after a warm-up, as
    ``bench.py:392-471`` times it."""
    pipe = build_pipeline(force_fp32=True, device=device) if pipe is None else pipe
    features, questions, chains = synth_questions(n_questions, pipe.exe_cfg, seed=1)
    reference_question(pipe, features, questions, chains, 0)  # warm-up
    best = np.full(n_questions, np.inf)
    answers = []
    for _ in range(2):
        answers = []
        for i in range(n_questions):
            _sync(pipe.device)
            t0 = time.perf_counter()
            answers.append(reference_question(pipe, features, questions, chains, i))
            _sync(pipe.device)
            best[i] = min(best[i], time.perf_counter() - t0)
    total = float(best.sum())
    qps = n_questions / total
    # the spread of the ratio n / sum(t): question costs vary with chain depth
    loo = (n_questions - 1) / (total - best)
    se = float(np.sqrt((n_questions - 1) / n_questions * np.sum((loo - loo.mean()) ** 2)))
    return qps, se, answers


def host_cpu() -> str:
    """The host CPU's model name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def emit_json(obj) -> dict:
    """Print ``obj`` as one JSON line, every non-finite float as null (a CPU
    run has no device peak: its utilisations are not measured), and return
    what the line holds."""
    def clean(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v

    obj = clean(obj)
    print(json.dumps(obj), flush=True)
    return obj


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = int(os.environ.get("BENCH_N", "1024"))
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    baseline_n = int(os.environ.get("BENCH_BASELINE_N", "32"))
    mode = os.environ.get("BENCH_MODE", "pool")
    if mode not in ("pool", "sorted"):
        raise ValueError(f"unknown BENCH_MODE {mode!r}")
    peak = chip_peak_flops(dev)  # before the run: an unknown card raises here
    print(card_line(dev), flush=True)

    value, stats = run_vectorized(n, batch, dev, mode)
    print(f"{mode}: {n} questions, batch {batch}, {len(stats['seconds'])} timed runs (s): "
          + ", ".join(f"{s:.4f}" for s in stats["seconds"]), flush=True)
    print(f"launches in one run: K1 {stats['launches_per_run']['K1']}, "
          f"K2 {stats['launches_per_run']['K2']}", flush=True)
    print(f"GFLOP per question: {stats['useful_flops_per_question'] / 1e9:.4f} by bench.py's "
          f"formula (mfu's numerator), {stats['useful_flops_per_question_as_built'] / 1e9:.4f} "
          f"as the generator is built (its upper encoder layers take h inputs, not 2h)",
          flush=True)

    baseline, baseline_se, _answers = run_reference_style(baseline_n, "cpu")
    print(f"baseline: {baseline_n} questions, batch 1, float32 on the host CPU "
          f"({host_cpu()}, {os.cpu_count()} CPUs, torch {torch.get_num_threads()} threads): "
          f"{baseline:.3f} questions/s", flush=True)

    mode_label = {"pool": "continuous-batching slot pool", "sorted": "depth-sorted"}[mode]
    result = {
        "metric": "CLEVR val QA pairs/sec/chip end-to-end (generator+executor, "
                  f"CLEVR question-family program shapes, {mode_label})",
        "value": round(value, 2),
        "unit": "qa_pairs/sec/chip" if dev.type == "cuda" else "qa_pairs/sec on the CPU",
        "vs_baseline": round(value / baseline, 2),
        "baseline_n": baseline_n,
        "baseline_qps": round(baseline, 3),
        "baseline_qps_jackknife_se": round(baseline_se, 4),
        "mfu": round(stats["flops_per_sec"] / peak, 4),
        "mean_chain_depth": round(stats["mean_chain_depth"], 2),
        "max_chain_depth": stats["max_chain_depth"],
        "gflops_per_question": round(stats["useful_flops_per_question"] / 1e9, 2),
        "truncated_programs": stats.get("truncated_programs", 0),
    }
    return emit_json(result)


if __name__ == "__main__":
    main()
