"""Low-precision-IO (bf16) LayerNorm and softmax for serving, ported from
``explainable_spatial_vqa_tpu/ops/lowp.py``.

Two opt-in segments, both off by default, each keeping its accumulations
in float32:

- LayerNorm (:func:`norm_dtype`): the encoder and decoder blocks' norms
  return the block's compute type (bf16) instead of float32, computed as
  flax's ``_normalize`` computes it: float32 statistics, ``x - mean`` and
  the affine in float32, one rounding to the output type.  The parameters
  stay float32.  Every block casts its norms' outputs to the compute type
  at once, so this gives the values the float32 norm gives.
- Softmax (:func:`lowp_softmax_enabled`): in the plain attention, for bf16
  inputs, the float32 scores are rounded to bf16 and back before the
  max/exp/sum chain, as the JAX package materialises them in bf16.  K1
  (``ops.fused_attention``) is dispatched before the plain path and does not
  change.

The flags are process-wide, as in the JAX package, and read at every call
(there is no trace to clear).  What the opt-in costs or saves on the card is
measured by ``chip_smoke.py`` (phase 20.4).
"""

from __future__ import annotations

import torch

__all__ = [
    "use_lowp_norms",
    "use_lowp_softmax",
    "use_lowp_serving",
    "lowp_norms_enabled",
    "lowp_softmax_enabled",
    "norm_dtype",
]

_LOWP_NORMS = False
_LOWP_SOFTMAX = False


def use_lowp_norms(enable: bool = True) -> None:
    global _LOWP_NORMS
    _LOWP_NORMS = enable


def use_lowp_softmax(enable: bool = True) -> None:
    global _LOWP_SOFTMAX
    _LOWP_SOFTMAX = enable


def use_lowp_serving(enable: bool = True) -> None:
    """Enable/disable both bf16-IO segments (the serving configuration)."""
    use_lowp_norms(enable)
    use_lowp_softmax(enable)


def lowp_norms_enabled() -> bool:
    return _LOWP_NORMS


def lowp_softmax_enabled() -> bool:
    return _LOWP_SOFTMAX


def norm_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """LayerNorm output type: the block's compute type when lowp norms are
    enabled and it is bf16 (float32 statistics), else float32."""
    if _LOWP_NORMS and compute_dtype == torch.bfloat16:
        return torch.bfloat16
    return torch.float32
