"""The port bench's end-to-end MFU split into measured factors, the
counterpart of ``scripts/mfu_decomposition.py``.

    python -m explainable_spatial_vqa_tpu_torch.measure.mfu_decomposition [--device cuda|cpu]

It rebuilds the port bench's ``sorted`` run from the bench's own pieces
(``to_device``, ``generate_all``, ``sorted_plan``, ``sorted_run``) on
``BENCH_N`` (1024) of bench.py's questions in batches of ``BENCH_BATCH``
(128), and times three segments, each the best of ``BENCH_REPEATS`` (3)
host-clock runs after a warm-up, the card synchronized before each clock
read: the generator's decode of every question (programs on the host), the
chain batches (answer token caches on the host), and both (the bench's
run).  Then

    MFU_e2e = MFU_step                        executed chain FLOPs / chain time / peak
            x flop_efficiency                 useful / executed chain FLOPs
            x chain_time_share                chain time / total time
            x (1 + gen_useful / chain_useful) the generator's FLOPs, credited to
                                              the numerator, timed outside the chain

where useful counts each question's own depth and executed counts every
(row, step) the batches run (padding rows and steps past a row's depth).
The product equals the measured MFU by construction: what it tells is how
the factors split.  The last line is one JSON object with the JAX script's
keys.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from explainable_spatial_vqa_tpu_torch.bench import (
    build_pipeline,
    flop_components,
    generate_all,
    emit_json,
    sorted_plan,
    sorted_run,
    time_repeats,
    to_device,
)
from explainable_spatial_vqa_tpu_torch.bench_data import synth_questions
from explainable_spatial_vqa_tpu_torch.device import card_line, chip_peak_flops, resolve_device

__all__ = ["KEYS", "flop_accounting", "main"]

KEYS = ("n", "batch", "t_generator_s", "t_chain_s", "t_total_s", "useful_steps",
        "executed_steps", "mfu_step_executed", "flop_efficiency_useful_over_executed",
        "chain_time_share", "generator_numerator_credit", "generator_flop_efficiency",
        "predicted_e2e_mfu_product", "measured_e2e_mfu", "qa_per_sec", "peak_flops")


def flop_accounting(gen_cfg, exe_cfg, num_steps: np.ndarray,
                    batches: Sequence[Tuple[int, int]]) -> Dict[str, int]:
    """Useful and executed steps, rows and FLOPs of a sorted run whose
    ``batches`` are (depth, size) pairs (``mfu_decomposition.py:122-141``):
    the chain's FLOPs are one image projection per row and one executor step
    per (row, step); the generator's useful decode is ``steps + 2`` tokens
    (at most program_len) where it executes program_len."""
    c = flop_components(gen_cfg, exe_cfg)
    n = len(num_steps)
    useful_steps = int(np.sum(num_steps))
    executed_steps = sum(size * depth for depth, size in batches)
    executed_rows = sum(size for _depth, size in batches)
    return {
        "useful_steps": useful_steps,
        "executed_steps": executed_steps,
        "executed_rows": executed_rows,
        "useful_chain": useful_steps * c["exe_step"] + n * c["exe_precompute"],
        "executed_chain": executed_steps * c["exe_step"] + executed_rows * c["exe_precompute"],
        "useful_gen": n * c["gen_encode"] + int(
            np.minimum(gen_cfg.program_len, np.asarray(num_steps) + 2).sum()) * c["gen_dec_step"],
        "executed_gen": n * (c["gen_encode"] + gen_cfg.program_len * c["gen_dec_step"]),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = int(os.environ.get("BENCH_N", "1024"))
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    repeats = int(os.environ.get("BENCH_REPEATS", "3"))
    peak = chip_peak_flops(dev)
    print(card_line(dev), flush=True)

    pipe = build_pipeline(device=dev)
    gen_cfg, exe_cfg = pipe.gen_cfg, pipe.exe_cfg
    features, questions, chains = synth_questions(n, exe_cfg)
    num_steps = np.asarray(chains.num_steps)
    data = to_device(features, questions, chains, dev)
    plan = sorted_plan(num_steps, batch, dev)

    def run_gen():
        return generate_all(pipe, data.questions).cpu().numpy()

    def run_chain():
        return [s.token_cache.cpu().numpy() for s in sorted_run(pipe, data, plan)]

    def run_total():  # the port bench's sorted run
        programs = generate_all(pipe, data.questions)
        states = sorted_run(pipe, data, plan)
        return programs.cpu().numpy(), [s.token_cache.cpu().numpy() for s in states]

    times = {}
    for name, fn in (("generator", run_gen), ("chain", run_chain), ("total", run_total)):
        fn()  # warm-up
        times[name] = time_repeats(fn, repeats, dev)
        print(f"{name}: {repeats} runs (s): " + ", ".join(f"{t:.4f}" for t in times[name]),
              flush=True)
    t_gen, t_chain, t_total = (min(times[k]) for k in ("generator", "chain", "total"))

    acc = flop_accounting(gen_cfg, exe_cfg, num_steps,
                          [(depth, size) for _sel, depth, size, _real in plan])
    mfu_step = acc["executed_chain"] / t_chain / peak
    flop_eff = acc["useful_chain"] / acc["executed_chain"]
    chain_share = t_chain / t_total
    gen_credit = 1.0 + acc["useful_gen"] / acc["useful_chain"]
    mfu_e2e = (acc["useful_gen"] + acc["useful_chain"]) / t_total / peak
    result = dict(zip(KEYS, (
        n, batch, t_gen, t_chain, t_total, acc["useful_steps"], acc["executed_steps"],
        mfu_step, flop_eff, chain_share, gen_credit, acc["useful_gen"] / acc["executed_gen"],
        mfu_step * flop_eff * chain_share * gen_credit, mfu_e2e, n / t_total, peak)))
    print(f"MFU_e2e {mfu_e2e:.3f} vs product {mfu_step:.3f} (per-step) x {flop_eff:.3f} "
          f"(packing) x {chain_share:.3f} (chain share) x {gen_credit:.3f} (gen credit) = "
          f"{result['predicted_e2e_mfu_product']:.3f}", flush=True)
    return emit_json(result)


if __name__ == "__main__":
    main()
