"""K2: one post-LN transformer encoder block on the card.

Port of ``explainable_spatial_vqa_tpu/ops/pallas_block.py`` (``_block_kernel``
via ``fused_encoder_block``, with ``fuse_encoder_params`` and ``pad_len``):

    h  = MHA(x)            (QKV projection, per-head attention, out projection)
    x1 = LN1(x + h)        (float32)
    f  = FFN(x1)           (d -> ffn -> d, ReLU)
    y  = LN2(x1 + f)       (in x's type)

Every product rounds its left operand to the weights' type and accumulates in
float32; q, k and v stay float32 into the attention, whose weights are
float32 too; LayerNorm takes float32 statistics with eps 1e-6.

The kernels are in ``csrc/fused_block.cu`` (a GEMM with a fused bias/ReLU
epilogue, the K1 attention kernel, a residual-add + LayerNorm kernel), all
launched by one C call.  :func:`fused_encoder_block_plain` is their plain
PyTorch version.  A CPU tensor runs the plain version; a CUDA tensor launches
the kernels or raises.  There is no backward: the encoder routes here only in
eval mode.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from explainable_spatial_vqa_tpu_torch.ops import _build
from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
    DTYPE_CODES,
    HEAD_DIMS,
    MAX_LEN,
    key_mask_f32,
)

__all__ = ["BlockWeights", "fuse_encoder_params", "fused_encoder_block",
           "fused_encoder_block_plain", "pad_len", "LN_EPS"]

LN_EPS = 1e-6  # flax.linen.LayerNorm default, and ops/pallas_block.py:106


def pad_len(length: int, multiple: int = 8) -> int:
    """The JAX kernel's sequence padding (``ops/pallas_block.py:109``).  The
    CUDA kernels mask the ragged edge themselves, so the port never pads."""
    return ((length + multiple - 1) // multiple) * multiple


class BlockWeights(NamedTuple):
    """One encoder block's parameters in the kernels' layout: matrices are
    (out_features, in_features) in the weight type, q/k/v stacked into one
    (3d, d) matrix; biases and LayerNorm parameters are float32."""

    qkv: torch.Tensor  # (3d, d) = [Wq; Wk; Wv]
    qkv_bias: torch.Tensor  # (3d,)
    out: torch.Tensor  # (d, d)
    out_bias: torch.Tensor  # (d,)
    ffn1: torch.Tensor  # (ffn, d)
    ffn1_bias: torch.Tensor  # (ffn,)
    ffn2: torch.Tensor  # (d, ffn)
    ffn2_bias: torch.Tensor  # (d,)
    ln1_scale: torch.Tensor
    ln1_bias: torch.Tensor
    ln2_scale: torch.Tensor
    ln2_bias: torch.Tensor


def fuse_encoder_params(block: torch.nn.Module, dtype: torch.dtype = torch.float32) -> BlockWeights:
    """Gather a :class:`~explainable_spatial_vqa_tpu_torch.models.layers.EncoderBlock`'s
    parameters into :class:`BlockWeights`, matrices cast to ``dtype``."""
    attn, ffn = block.attn, block.ffn

    def mat(*ts):
        return torch.cat([t.detach() for t in ts]).to(dtype).contiguous()

    def vec(*ts):
        return torch.cat([t.detach() for t in ts]).to(torch.float32).contiguous()

    return BlockWeights(
        qkv=mat(attn.q.weight, attn.k.weight, attn.v.weight),
        qkv_bias=vec(attn.q.bias, attn.k.bias, attn.v.bias),
        out=mat(attn.out.weight), out_bias=vec(attn.out.bias),
        ffn1=mat(ffn.fc1.weight), ffn1_bias=vec(ffn.fc1.bias),
        ffn2=mat(ffn.fc2.weight), ffn2_bias=vec(ffn.fc2.bias),
        ln1_scale=vec(block.norm1.weight), ln1_bias=vec(block.norm1.bias),
        ln2_scale=vec(block.norm2.weight), ln2_bias=vec(block.norm2.bias),
    )


def _layer_norm(t: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mean = t.mean(dim=-1, keepdim=True)
    var = torch.square(t - mean).mean(dim=-1, keepdim=True)
    return (t - mean) * torch.rsqrt(var + LN_EPS) * scale + bias


def fused_encoder_block_plain(
    x: torch.Tensor, mask: Optional[torch.Tensor], w: BlockWeights, num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of the kernels, following ``_block_kernel``'s
    arithmetic (``ops/pallas_block.py:113-160``)."""
    batch, length, d_model = x.shape
    wdt = w.qkv.dtype

    def dense(a, weight, bias):  # round a to the weight type, accumulate in float32
        return a.to(wdt).float() @ weight.float().t() + bias

    xf = x.float()
    q, k, v = dense(xf, w.qkv, w.qkv_bias).split(d_model, dim=-1)
    heads = (batch, length, num_heads, d_model // num_heads)
    key_mask = None
    if mask is not None:
        key_mask = (key_mask_f32(mask, batch, length) > 0)[:, None, None, :]
    attn = dot_product_attention(q.reshape(heads), k.reshape(heads), v.reshape(heads), key_mask)
    o = dense(attn.reshape(batch, length, d_model), w.out, w.out_bias)
    x1 = _layer_norm(xf + o, w.ln1_scale, w.ln1_bias)
    h1 = torch.relu(dense(x1, w.ffn1, w.ffn1_bias))
    f = dense(h1, w.ffn2, w.ffn2_bias)
    return _layer_norm(x1 + f, w.ln2_scale, w.ln2_bias).to(x.dtype)


def _esv_encoder_block():
    fn = _build.load("fused_block").esv_encoder_block
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_encoder_block(
    x: torch.Tensor,  # (B, L, d)
    mask: Optional[torch.Tensor],  # (B, L) bool/float key mask or None
    weights: BlockWeights,
    num_heads: int,
) -> torch.Tensor:
    """One post-LN encoder block: the kernels on CUDA, the plain version on CPU."""
    if x.device.type == "cpu":
        return fused_encoder_block_plain(x, mask, weights, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_block: unsupported device {x.device}")
    batch, length, d_model = x.shape
    wdt = weights.qkv.dtype
    ffn = weights.ffn1.shape[0]
    if x.dtype not in DTYPE_CODES or wdt not in DTYPE_CODES:
        raise ValueError(f"fused_encoder_block: x and weights must be one of {list(DTYPE_CODES)}")
    if (d_model % num_heads or d_model // num_heads not in HEAD_DIMS or length > MAX_LEN
            or batch > 65535 or batch * length > 65535 * 64):
        raise ValueError(
            f"fused_encoder_block: head dim d/H = {d_model}/{num_heads} must be one of "
            f"{HEAD_DIMS}, length {length} at most {MAX_LEN}, batch at most 65535 and "
            f"batch * length at most {65535 * 64}")
    shapes = {"qkv": (3 * d_model, d_model), "out": (d_model, d_model), "ffn1": (ffn, d_model),
              "ffn2": (d_model, ffn), "qkv_bias": (3 * d_model,), "ffn1_bias": (ffn,)}
    for name, t in weights._asdict().items():
        want_dtype = wdt if name in ("qkv", "out", "ffn1", "ffn2") else torch.float32
        want_shape = shapes.get(name, (d_model,))
        if (t.dtype != want_dtype or tuple(t.shape) != want_shape or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(
                f"fused_encoder_block: weight {name} must be a contiguous {want_shape} "
                f"{want_dtype} tensor on {x.device}")
    if not x.is_contiguous():
        raise ValueError("fused_encoder_block: x must be contiguous")
    mask_f = key_mask_f32(mask, batch, length)
    if mask_f is not None:
        mask_f = mask_f.to(x.device)
    rows = batch * length
    f32 = dict(dtype=torch.float32, device=x.device)
    qkv = torch.empty(rows, 3 * d_model, **f32)
    attn = torch.empty(rows, d_model, **f32)
    proj = torch.empty(rows, d_model, **f32)
    x1 = torch.empty(rows, d_model, **f32)
    hidden = torch.empty(rows, ffn, dtype=wdt, device=x.device)
    out = torch.empty_like(x)
    ptrs = [x, mask_f, *weights, out, qkv, attn, proj, x1, hidden]
    with torch.cuda.device(x.device):
        fused_encoder_block.launches += 1
        status = _esv_encoder_block()(
            *(None if t is None else t.data_ptr() for t in ptrs),
            batch, length, d_model, num_heads, ffn, DTYPE_CODES[x.dtype], DTYPE_CODES[wdt],
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, "esv_encoder_block")
    return out


fused_encoder_block.launches = 0
