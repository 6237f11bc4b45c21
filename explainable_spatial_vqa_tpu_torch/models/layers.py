"""Shared neural building blocks, ported from
``explainable_spatial_vqa_tpu/models/layers.py``.

As in the JAX package, parameters are float32 and every matmul-bearing
module computes in its ``dtype`` (the compute type, bfloat16 when serving):
:class:`Dense` casts its input, weight and bias to ``dtype`` (the cast weights
are kept between calls without autograd), while LayerNorm and softmax run in
float32.  LayerNorm uses eps 1e-6 (Flax's), not
PyTorch's 1e-5.

:class:`EncoderBlock` routes eligible calls (post-LN, eval mode, a key-padding
mask or none, a head dim the kernels are built for) to the fused encoder
block K2, and :class:`MultiHeadAttention` routes eligible self-attention at
such a head dim to K1, as ``_fused_eligible`` and the attention dispatch do
in the JAX package; every other width runs the plain path.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
    attention_eligible,
    fused_attention,
    head_dim_built,
)
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    LN_EPS,
    fuse_encoder_params,
    fused_encoder_block,
)

__all__ = [
    "sinusoidal_positions",
    "posemb_2d_sincos",
    "posemb_2d_sincos_at",
    "Dense",
    "LayerNorm",
    "MultiHeadAttention",
    "FeedForward",
    "EncoderBlock",
    "DecoderBlock",
    "TransformerEncoder",
    "cached_on_params",
    "eval_mode",
    "init_parameters",
]

Device = Union[str, torch.device]


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) interleaved sin/cos table."""
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    table = np.zeros((max_len, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(position * div_term)
    table[:, 1::2] = np.cos(position * div_term)
    return table


def posemb_2d_sincos(h: int, w: int, d_model: int) -> np.ndarray:
    """(h*w, d_model) 2D sine-cosine embedding: first half encodes x, second
    half y (thesis p.17)."""
    assert d_model % 2 == 0, "d_model must be even for 2D sincos"
    half = d_model // 2
    x_table = sinusoidal_positions(w, half)
    y_table = sinusoidal_positions(h, half)
    out = np.zeros((h, w, d_model), dtype=np.float32)
    out[:, :, :half] = x_table[None, :, :]
    out[:, :, half:] = y_table[:, None, :]
    return out.reshape(h * w, d_model)


def posemb_2d_sincos_at(xy: torch.Tensor, d_model: int, temperature: float = 10000.0) -> torch.Tensor:
    """Continuous 2D sincos embedding at normalized (x, y) in [0, 1], (..., 2)
    -> (..., d_model).  Coordinates scale to a nominal 14-step grid, and sin
    and cos interleave per frequency like :func:`sinusoidal_positions`, so a
    box token at (x, y) aligns channel for channel with the patch there."""
    assert d_model % 2 == 0
    half = d_model // 2
    freqs = torch.exp(
        torch.arange(0, half, 2, dtype=torch.float32, device=xy.device)
        * (-math.log(temperature) / half))
    angles = (xy[..., None] * 14.0) * freqs  # (..., 2, half/2)
    emb = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1)
    emb = emb.reshape(emb.shape[:-3] + (2, half))
    return emb.reshape(emb.shape[:-2] + (d_model,))


def cached_on_params(module: nn.Module, build):
    """``build()``, kept on ``module`` and built anew only when one of its
    parameters changes: a new tensor (``.to()``, a new ``.data``) or an
    in-place write (``load_state_dict``, ``copy_``), which bumps the
    tensor's version counter.  For values derived from the parameters that
    need no autograd graph, such as their casts in inference."""
    key = tuple((p.data_ptr(), p._version) for p in module.parameters())
    kept = module.__dict__.get("_cached_on_params")
    if kept is None or kept[0] != key:
        kept = (key, build())
        module.__dict__["_cached_on_params"] = kept
    return kept[1]


@contextlib.contextmanager
def eval_mode(module: nn.Module) -> Iterator[nn.Module]:
    """``module`` in eval mode for the ``with`` block (no dropout; the fusion
    blocks on K2 and the box decoder's self-attention on K1), each
    submodule's own mode restored after it: the deterministic passes (chained
    execution, evaluation) run so whatever mode the caller left it in."""
    modes = [(m, m.training) for m in module.modules()]
    module.eval()
    try:
        yield module
    finally:
        for m, training in modes:
            m.training = training


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters that computes in ``dtype``, like
    a Flax ``Dense(dtype=...)``.  Without autograd the cast parameters are
    kept between calls."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda", bias: bool = True):
        super().__init__(in_features, out_features, bias=bias,
                         device=resolve_device(device), dtype=torch.float32)
        self.compute_dtype = dtype

    def _cast(self):
        dt = self.compute_dtype
        return self.weight.to(dt), None if self.bias is None else self.bias.to(dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = (self._cast() if torch.is_grad_enabled()
                        else cached_on_params(self, self._cast))
        return F.linear(x.to(self.compute_dtype), weight, bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in float32 with eps 1e-6; returns float32."""

    def __init__(self, d_model: int, device: Device = "cuda"):
        super().__init__(d_model, eps=LN_EPS, device=resolve_device(device), dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float())


class MultiHeadAttention(nn.Module):
    """Multi-head attention with q/k/v/out projections of width d_model.

    Self-attention with a key-padding mask or none, at a head dim K1 is
    built for, runs on K1 in eval mode; every other call takes
    :func:`dot_product_attention`."""

    def __init__(self, d_model: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        assert d_model % num_heads == 0
        self.num_heads = num_heads
        self.q = Dense(d_model, d_model, dtype, device)
        self.k = Dense(d_model, d_model, dtype, device)
        self.v = Dense(d_model, d_model, dtype, device)
        self.out = Dense(d_model, d_model, dtype, device)

    def forward(self, query: torch.Tensor, keyvalue: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, lq, d = query.shape
        lk = keyvalue.shape[1]
        dh = d // self.num_heads
        q = self.q(query).view(b, lq, self.num_heads, dh)
        k = self.k(keyvalue).view(b, lk, self.num_heads, dh)
        v = self.v(keyvalue).view(b, lk, self.num_heads, dh)
        if (not self.training and head_dim_built(d, self.num_heads)
                and attention_eligible(q, k, mask)):
            out = fused_attention(q, k, v, mask)
        else:
            out = dot_product_attention(q, k, v, mask)
        return self.out(out.reshape(b, lq, d))


class FeedForward(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        self.fc1 = Dense(d_model, ffn_dim, dtype, device)
        self.fc2 = Dense(ffn_dim, d_model, dtype, device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.drop(torch.relu(self.fc1(x))))


class EncoderBlock(nn.Module):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, dropout: float = 0.1,
                 norm: str = "post", dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.norm = norm
        self.dtype = dtype
        self.attn = MultiHeadAttention(d_model, num_heads, dtype, device)
        self.ffn = FeedForward(d_model, ffn_dim, dropout, dtype, device)
        self.norm1 = LayerNorm(d_model, device)
        self.norm2 = LayerNorm(d_model, device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        if self.norm == "pre":
            h = self.norm1(x).to(dt)
            x = x + self.drop(self.attn(h, h, mask))
            return x + self.drop(self.ffn(self.norm2(x).to(dt)))
        if self._fused_eligible(mask):
            return self._fused_forward(x, mask)
        x = self.norm1(x + self.drop(self.attn(x, x, mask))).to(dt)
        return self.norm2(x + self.drop(self.ffn(x))).to(dt)

    def _fused_eligible(self, mask: Optional[torch.Tensor]) -> bool:
        """Route to K2 in eval mode (it has no backward) at a head dim it is
        built for, with a key-padding mask or none; post-LN is checked by the
        caller."""
        if self.training or not head_dim_built(self.d_model, self.num_heads):
            return False
        return mask is None or (mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1)

    def _fused_forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        key_mask = None if mask is None else mask[:, 0, 0, :]
        weights = cached_on_params(self, lambda: fuse_encoder_params(self, dtype=self.dtype))
        return fused_encoder_block(x.to(self.dtype).contiguous(), key_mask, weights,
                                   self.num_heads)


class DecoderBlock(nn.Module):
    """Self-attention + cross-attention + FFN, post-LN."""

    def __init__(self, d_model: int, num_heads: int, ffn_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadAttention(d_model, num_heads, dtype, device)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dtype, device)
        self.ffn = FeedForward(d_model, ffn_dim, dropout, dtype, device)
        self.norm1 = LayerNorm(d_model, device)
        self.norm2 = LayerNorm(d_model, device)
        self.norm3 = LayerNorm(d_model, device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                self_mask: Optional[torch.Tensor] = None,
                memory_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        x = self.norm1(x + self.drop(self.self_attn(x, x, self_mask))).to(dt)
        x = self.norm2(x + self.drop(self.cross_attn(x, memory, memory_mask))).to(dt)
        return self.norm3(x + self.drop(self.ffn(x))).to(dt)


class TransformerEncoder(nn.Module):
    """A stack of :class:`EncoderBlock`.  With ``remat``, a training forward
    that records a graph keeps no block's activations: the backward runs
    each block again (``torch.utils.checkpoint``, dropout replayed), trading
    compute for memory as ``nn.remat`` does in the JAX package."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, norm: str = "post", dtype: torch.dtype = torch.float32,
                 device: Device = "cuda", remat: bool = False):
        super().__init__()
        self.remat = remat
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, num_heads, ffn_dim, dropout, norm, dtype, device)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        remat = self.remat and self.training and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, mask, use_reentrant=False) if remat else block(x, mask)
        return x


def init_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a ``torch.Generator`` seeded with ``seed``:
    LayerNorm scales one and biases zero; other biases zero; embedding tables
    normal(0, 1); matrices normal with std 1/sqrt(fan_in); the rest (learned
    queries, positions, CLS) normal(0, 0.02)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        for mod in module.modules():
            for leaf, p in mod.named_parameters(recurse=False):
                if isinstance(mod, nn.LayerNorm):
                    values = torch.ones(p.shape) if leaf == "weight" else torch.zeros(p.shape)
                elif leaf.startswith("bias"):
                    values = torch.zeros(p.shape)
                elif isinstance(mod, nn.Embedding):
                    values = torch.randn(p.shape, generator=gen)
                elif p.ndim == 2 and leaf.startswith("weight"):
                    values = torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1])
                else:
                    values = torch.randn(p.shape, generator=gen) * 0.02
                p.copy_(values)
    return module
