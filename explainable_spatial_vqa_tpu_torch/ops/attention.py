"""Scaled dot-product attention, the plain PyTorch path.

Port of ``explainable_spatial_vqa_tpu/ops/attention.py:39-90`` with the same
arithmetic: scores accumulate in float32, masked keys get a finite ``-1e30``
fill (so an all-masked row gives uniform weights, never NaNs), the softmax
runs in float32 with ``+1e-30`` in the denominator, and the weights are cast
to the compute type before the product with V, which accumulates in float32.
With ``ops.lowp``'s softmax opt-in, bf16 inputs' scores are rounded to bf16
before the softmax (JAX's ``ops/attention.py:66-85``).

With lowp off this is the plain version of kernel K1
(:mod:`.fused_attention`), and in any case the path of every attention call
K1 does not take: cross-attention (``Lq != Lk``) and masks other than a
key-padding mask, such as the decoders' causal mask
(:func:`make_causal_mask`) and a cached decode step's one query.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.ops.lowp import lowp_softmax_enabled

__all__ = ["dot_product_attention", "scaled_attention", "make_causal_mask", "combine_masks",
           "NEG_INF"]

NEG_INF = -1e30


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Attention over (B, T, H, D) tensors.

    q: (B, Tq, H, D); k, v: (B, Tk, H, D); mask: bool, broadcastable to
    (B, H, Tq, Tk), True = attend.  Returns (B, Tq, H, D) in q's dtype.
    """
    return scaled_attention(q, k, v, mask,
                            q.dtype == torch.bfloat16 and lowp_softmax_enabled())


def scaled_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor], bf16_scores: bool) -> torch.Tensor:
    """:func:`dot_product_attention` with the lowp rounding of the scores
    given, not read from the flag: K1's plain version takes ``False``, as K1
    computes whatever ``ops.lowp`` says."""
    dtype = q.dtype
    # 1/sqrt(D) rounded as float32 arithmetic rounds it, held as a Python
    # number so that no tensor crosses to the device (a blocking copy)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    if bf16_scores:
        # bf16-IO softmax (ops.lowp): the scores rounded to bf16 (-1e30 is
        # representable), the max/exp/sum chain in float32
        scores = scores.to(torch.bfloat16).float()
    weights = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-30)
    weights = weights.to(dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights.float(), v.float()).to(dtype)


def make_causal_mask(length: int, device=None) -> torch.Tensor:
    """(1, 1, T, T) lower-triangular boolean mask: query t attends keys <= t."""
    idx = torch.arange(length, device=device)
    return (idx[None, :] <= idx[:, None])[None, None, :, :]


def combine_masks(*masks: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """AND together broadcastable boolean masks, ignoring Nones."""
    present = [m for m in masks if m is not None]
    if not present:
        return None
    out = present[0]
    for m in present[1:]:
        out = torch.logical_and(out, m)
    return out
