"""Time the encoder block's kernels at the executor's widths, the port's
counterpart of ``scripts/bench_pallas_block.py``.

    python -m explainable_spatial_vqa_tpu_torch.bench_block [--iters 20]
        [--batches 128,256,512] [--tiles 2,4,8] [--d_model 512] [--heads 4]
        [--length 224]

Shapes: d=512, 4 heads, ffn 2048, L=224 (the fusion encoder's 210 tokens
padded to a multiple of 8), bf16 weights and activations, no mask, weights
drawn from seed 0; ``--d_model`` and ``--heads`` widen the block (ffn 4 d,
as at 512: d_model 1024 with 4 heads runs the blocks' attention at head dim
256); ``--length`` sets the rows' length (past 256 keys the blocks' bf16
attention at head dim 128 takes its two passes).  Rows, for each batch size:

* the port's ``EncoderBlock`` on its unfused path (train mode, dropout 0,
  under ``torch.no_grad``), the counterpart of the script's "xla bf16
  (production)" row;
* K2, ``fused_encoder_block``;
* K3, ``fused_encoder_block_tiled``, at each batch tile TB of ``--tiles`` with
  FFN chunks fc in {1, 2} for TB <= 2 and fc = TB otherwise.

Each row is timed as ``iters`` chained applications between two CUDA events,
the best of three such runs after a warm-up, and printed as ms per
application and TFLOP/s (:func:`block_flops`).  It needs a CUDA card; a
variant that fails raises.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.models.layers import EncoderBlock, init_parameters
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    fuse_encoder_params,
    fused_encoder_block,
    fused_encoder_block_tiled,
)

__all__ = ["D_MODEL", "HEADS", "FFN", "LENGTH", "block_flops", "variants", "main"]

D_MODEL, HEADS, FFN, LENGTH = 512, 4, 2048, 224

Row = Tuple[int, str, float, float]  # batch, name, ms per application, TFLOP/s


def block_flops(batch: int, d_model: int = D_MODEL, ffn: int = FFN,
                length: int = LENGTH) -> float:
    """Forward matmul FLOPs (2*MACs) of one encoder block application."""
    qkvo = 4 * 2 * length * d_model * d_model
    attn = 2 * 2 * length * length * d_model
    ffn = 2 * 2 * length * d_model * ffn
    return batch * (qkvo + attn + ffn)


def variants(tiles: Sequence[int]) -> List[Tuple[int, int]]:
    """The (batch_tile, ffn_chunks) pairs timed for K3."""
    return [(tb, fc) for tb in tiles for fc in ([1, 2] if tb <= 2 else [tb])]


def timed(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, iters: int,
          repeats: int = 3) -> float:
    """Best ms per application over ``repeats`` runs of ``iters`` chained
    applications, each between two CUDA events."""
    y = x
    for _ in range(iters):  # warm-up
        y = fn(y)
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        y = x
        start.record()
        for _ in range(iters):
            y = fn(y)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best / iters


def main(argv: Optional[Sequence[str]] = None) -> List[Row]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--batches", default="128,256,512")
    ap.add_argument("--tiles", default="2,4,8")
    ap.add_argument("--d_model", type=int, default=D_MODEL)
    ap.add_argument("--heads", type=int, default=HEADS)
    ap.add_argument("--length", type=int, default=LENGTH)
    args = ap.parse_args(argv)
    d_model, heads, ffn = args.d_model, args.heads, 4 * args.d_model

    dev = resolve_device("cuda")
    print(f"device: {torch.cuda.get_device_name(dev)}")
    block = init_parameters(EncoderBlock(d_model, heads, ffn, dropout=0.0,
                                         dtype=torch.bfloat16, device=dev), seed=0).train()
    weights = fuse_encoder_params(block, dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    rows: List[Row] = []
    with torch.no_grad():
        for batch in [int(b) for b in args.batches.split(",")]:
            x = torch.from_numpy(rng.randn(batch, args.length, d_model).astype(np.float32)).to(
                device=dev, dtype=torch.bfloat16)
            gflop = block_flops(batch, d_model, ffn, args.length) / 1e9

            def report(name, ms, batch=batch, gflop=gflop):
                rows.append((batch, name, ms, gflop / ms))
                print(f"B={batch:4d}  {name:28s} {ms:8.3f} ms  {gflop / ms:7.2f} TFLOP/s",
                      flush=True)

            report("EncoderBlock unfused bf16", timed(block, x, args.iters))
            report("K2 per-seq", timed(lambda y: fused_encoder_block(y, None, weights, heads),
                                       x, args.iters))
            for tb, fc in variants([int(t) for t in args.tiles.split(",")]):
                report(f"K3 tiled TB={tb} fc={fc}",
                       timed(lambda y, tb=tb, fc=fc: fused_encoder_block_tiled(
                           y, None, weights, heads, batch_tile=tb, ffn_chunks=fc),
                             x, args.iters))

    print("\nsummary (ms/apply):")
    for batch, name, ms, tflops in rows:
        print(f"  {batch:4d}  {name:28s} {ms:8.3f}  {tflops:7.2f}")
    return rows


if __name__ == "__main__":
    main()
