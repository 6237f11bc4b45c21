"""The encoder block's GEMM alone, on the card.

``C = act(a rounded to w's type @ w.T + bias)`` with float32 sums, the product
that K2 and K3 (:mod:`.fused_block`) run four times per block: the left
operand rounded to the weights' type, as ``jnp.dot(a.astype(w_dtype), w,
preferred_element_type=float32) + b`` in ``ops/pallas_block.py``, bias and an
optional ReLU, the result in ``out_dtype``.  The kernel is
``esv_block_gemm`` in ``csrc/fused_block.cu``, the same code the blocks launch:
wgmma fed by TMA, which reads an operand as it lies in memory, so ``a`` is in
the weights' type (the blocks convert an ``x`` of the other type in a pass of
their own).  bf16 operands run in bf16 on the tensor cores; float32 ones in
3xTF32: ``w`` split once per call here into its TF32 hi and lo parts
(:func:`~explainable_spatial_vqa_tpu_torch.ops.fused_block.split_tf32`; pass
``split`` to reuse one), ``a`` split in registers on the card, three TF32
products a term, ~2^-22 |x| of error per operand.  It lets a product be timed
and checked apart from its block; nothing in the model calls it.
``compensated=True`` takes K3's QKV product instead (bf16 weights, no ReLU):
its sums are the float32 value of the exact sum, which the kernel approaches
with tensor-core slices added with Kahan's compensation and, for a bf16
output, reaches by taking the exact sum where the two could round apart.  A
CPU tensor runs :func:`block_gemm_plain`; a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from explainable_spatial_vqa_tpu_torch.ops import _build
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import DTYPE_CODES
from explainable_spatial_vqa_tpu_torch.ops.fused_block import split_tf32

__all__ = ["block_gemm", "block_gemm_plain", "check_gemm"]

# esv_block_gemm's: A, W, bias, C, absmax; M, N, K, the three types, relu,
# compensated; the stream
_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def block_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, relu: bool = False,
                     out_dtype: torch.dtype = torch.float32,
                     compensated: bool = False) -> torch.Tensor:
    """Plain PyTorch version: a rounded to w's type, float32 sums (with
    ``compensated``, float64 sums rounded to float32 once, as K3's plain
    version takes its QKV product), plus bias, ReLU where asked, rounded to
    ``out_dtype``."""
    a = a.to(w.dtype)
    if compensated:
        c = (a.double() @ w.double().t()).float() + bias
    else:
        c = a.float() @ w.float().t() + bias
    return (torch.relu(c) if relu else c).to(out_dtype)


def check_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               out_dtype: torch.dtype, relu: bool = False, compensated: bool = False,
               split: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError unless the kernel takes these operands: a (M, K) and
    w (N, K) in float32 or bf16, a in w's type, bias (N,) float32, out_dtype
    float32 or bf16, all contiguous on one CPU or CUDA device; TMA's rules:
    16-byte aligned bases, K and N multiples of 8 (bf16) or 4 (float32);
    ``split`` only with float32 weights, as (2N, K) float32 alongside them;
    ``compensated`` with bf16 weights and no ReLU only."""
    devices = {t.device for t in (a, w, bias)}
    if len(devices) != 1 or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"block_gemm: unsupported device(s) {sorted(map(str, devices))}")
    if (a.dtype not in DTYPE_CODES or w.dtype not in DTYPE_CODES
            or out_dtype not in DTYPE_CODES or bias.dtype != torch.float32):
        raise ValueError(f"block_gemm: a, w and out_dtype must be one of {list(DTYPE_CODES)}, "
                         f"bias float32")
    if (a.ndim != 2 or w.ndim != 2 or bias.shape != (w.shape[0],) or a.shape[1] != w.shape[1]
            or min(*a.shape, *w.shape) < 1 or a.shape[0] >= 2 ** 31):
        raise ValueError(f"block_gemm: shapes a {tuple(a.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(bias.shape)} are not (M, K), (N, K), (N,)")
    if not (a.is_contiguous() and w.is_contiguous() and bias.is_contiguous()):
        raise ValueError("block_gemm: a, w and bias must be contiguous")
    wname = "bf16" if w.dtype == torch.bfloat16 else "float32"
    if a.dtype != w.dtype:
        raise ValueError(f"block_gemm: with {wname} weights a must be {wname} too")
    multiple = 16 // w.element_size()
    if a.data_ptr() % 16 or w.data_ptr() % 16 or w.shape[1] % multiple or w.shape[0] % multiple:
        raise ValueError(f"block_gemm: with {wname} weights a and w must start on 16-byte "
                         f"boundaries and K and N be multiples of {multiple}")
    if split is not None and (
            w.dtype != torch.float32 or split.dtype != torch.float32
            or split.shape != (2 * w.shape[0], w.shape[1]) or split.device != w.device
            or not split.is_contiguous() or split.data_ptr() % 16):
        raise ValueError("block_gemm: split takes float32 weights, as a contiguous (2N, K) "
                         "float32 tensor on their device on a 16-byte boundary")
    if compensated and (w.dtype != torch.bfloat16 or relu):
        raise ValueError("block_gemm: compensated takes bf16 weights and no ReLU")


def block_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, relu: bool = False,
               out_dtype: torch.dtype = torch.float32, compensated: bool = False,
               split: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``act(a @ w.T + bias)`` as the encoder block computes it: the kernel
    on CUDA, the plain version on CPU.  ``split``: float32 ``w``'s
    :func:`split_tf32`, made here on each call where it is None."""
    check_gemm(a, w, bias, out_dtype, relu, compensated, split)
    if a.device.type == "cpu":
        return block_gemm_plain(a, w, bias, relu, out_dtype, compensated)
    if w.dtype == torch.float32:
        w = split if split is not None else split_tf32(w)
    (m, k), n = a.shape, bias.shape[0]
    out = torch.empty(m, n, dtype=out_dtype, device=a.device)
    # the correctly rounded bf16 output's scratch: the row maxima of a and w,
    # then one flag bit per element
    absmax = (torch.empty(m + n + (m * n + 31) // 32, device=a.device)
              if compensated and out_dtype == torch.bfloat16 else None)
    with torch.cuda.device(a.device):
        block_gemm.launches += 1
        status = _build.entry("fused_block", "esv_block_gemm", _ARGTYPES)(
            a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if absmax is None else absmax.data_ptr(), m, n, k, DTYPE_CODES[a.dtype],
            DTYPE_CODES[w.dtype], DTYPE_CODES[out_dtype], int(relu), int(compensated),
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(status, "esv_block_gemm")
    return out


block_gemm.launches = 0
