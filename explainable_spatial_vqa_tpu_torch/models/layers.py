"""Shared neural building blocks, ported from
``explainable_spatial_vqa_tpu/models/layers.py``.

As in the JAX package, parameters are float32 and every matmul-bearing
module computes in its ``dtype`` (the compute type, bfloat16 when serving):
:class:`Dense` casts its input, weight and bias to ``dtype`` (the cast weights
are kept between calls without autograd), while LayerNorm and softmax run in
float32 (with ``ops.lowp``'s opt-in the blocks' norms return bf16 and the
plain attention rounds its scores to bf16 first).  LayerNorm uses eps 1e-6
(Flax's), not PyTorch's 1e-5.

:class:`EncoderBlock` routes eligible calls (post-LN, eval mode, a key-padding
mask or none, d_model a multiple of 128 and a head dim of
``ops.fused_block.BLOCK_HEAD_DIMS``, 128, 256, 384 and 512) to the fused encoder block
K2, as ``_fused_eligible`` does in the JAX package (d_model and head dims
that are multiples of 128); :class:`MultiHeadAttention` routes eligible
self-attention (eval mode with no autograd graph, same length, a key-padding
mask or none) to K1 at every head dim from 1 to 512
(``ops.fused_attention.HEAD_DIMS``), as JAX's attention dispatch does at
any.  Both route only rows the kernels take (``shape_built`` and
``block_shape_built``, the wrappers' own checks: 1 to ``MAX_LEN`` keys).
Every other call runs the plain path.

The decoders (:class:`TransformerDecoder`) run teacher-forced under a causal
mask, or one token at a time over explicit KV caches (``init_cache`` and
``decode_step``, as in JAX): a cache is a (B, L, H, D) K/V pair in the
compute type; step ``index`` writes its K/V at that position out of place
(``torch.where`` on a one-hot row, so autograd reaches every earlier step's
projections through the cache) and attends over the whole static cache with
the keys past ``index`` masked out.  Neither path reaches K1, but for a
teacher-forced pass over one token, whose (1, 1, 1, 1) causal mask JAX's rule
takes: a longer causal mask is not a key-padding mask, and a step's one query
is not its keys' length.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.ops.attention import dot_product_attention, make_causal_mask
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
    attention_eligible,
    fused_attention,
    head_dim_built,
    shape_built,
)
from explainable_spatial_vqa_tpu_torch.ops.fused_block import (
    LN_EPS,
    block_head_dim_built,
    block_shape_built,
    fuse_encoder_params,
    fused_encoder_block,
    split_block_weights,
)
from explainable_spatial_vqa_tpu_torch.ops.lowp import norm_dtype

__all__ = [
    "sinusoidal_positions",
    "posemb_2d_sincos",
    "posemb_2d_sincos_at",
    "Dense",
    "LayerNorm",
    "embed_or_nan",
    "PositionalEncoding",
    "MultiHeadAttention",
    "FeedForward",
    "EncoderBlock",
    "DecoderBlock",
    "TransformerEncoder",
    "TransformerDecoder",
    "KVCache",
    "cached_on_params",
    "has_sharded_params",
    "eval_mode",
    "init_parameters",
]

Device = Union[str, torch.device]
KVCache = Dict[str, torch.Tensor]  # {"k": (B, L, H, D), "v": (B, L, H, D)}


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


def has_sharded_params(module: nn.Module) -> bool:
    """Whether any parameter of ``module`` is a DTensor (split over ranks by
    ``parallel.sharding``): such a module holds no whole local weights for
    K1 or K2, and keeps no cast weights (a DTensor has no data pointer)."""
    return any(isinstance(p, DTensor) for p in module.parameters())


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


def embed_or_nan(table: nn.Embedding, ids: torch.Tensor) -> torch.Tensor:
    """``table(ids)``, with a row of NaN for an id outside the table, as
    Flax's ``Embed`` (``jnp.take`` in fill mode) returns: a token the model
    was not sized for poisons its sequence instead of raising (or asserting
    on the card)."""
    ids = ids.long()
    inside = (ids >= 0) & (ids < table.num_embeddings)
    rows = table(torch.where(inside, ids, torch.zeros_like(ids)))
    return torch.where(inside[..., None], rows, torch.full_like(rows, float("nan")))


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
        uncached = torch.is_grad_enabled() or isinstance(self.weight, DTensor)
        weight, bias = self._cast() if uncached else cached_on_params(self, self._cast)
        return F.linear(x.to(self.compute_dtype), weight, bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in float32 with eps 1e-6 and float32 parameters.  Returns
    float32, or ``dtype`` (bf16 under ``ops.lowp``'s norms): then it
    computes as flax's ``_normalize`` does, float32 statistics (the mean of
    x and of x², the variance their difference clipped at 0), ``x - mean``
    and the affine in float32, and rounds once to ``dtype``."""

    def __init__(self, d_model: int, device: Device = "cuda"):
        super().__init__(d_model, eps=LN_EPS, device=resolve_device(device), dtype=torch.float32)

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        x = x.float()
        if dtype == torch.float32:
            return super().forward(x)
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(dtype)


class PositionalEncoding(nn.Module):
    """Adds the fixed sinusoidal table, rounded to x's type first as JAX
    rounds it (a bf16 forward adds a bf16 table), from position ``offset``
    (a decode step's index; a slice past the table's end starts earlier, as
    ``lax.dynamic_slice`` clamps it).  Dropout follows the module's mode
    unless ``deterministic`` says otherwise."""

    def __init__(self, d_model: int, max_len: int = 5000, dropout: float = 0.1,
                 device: Device = "cuda"):
        super().__init__()
        self.register_buffer("table", torch.from_numpy(sinusoidal_positions(max_len, d_model))
                             .to(resolve_device(device)), persistent=False)
        self.dropout = dropout

    def forward(self, x: torch.Tensor, offset: int = 0,
                deterministic: Optional[bool] = None) -> torch.Tensor:
        length = x.shape[-2]
        start = max(0, min(offset, self.table.shape[0] - length))
        x = x + self.table[start:start + length].to(x.dtype)
        if deterministic is None:
            deterministic = not self.training
        return x if deterministic else F.dropout(x, self.dropout, training=True)


@functools.lru_cache(maxsize=None)
def _step_masks(max_len: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L) bool identity and lower triangle: row ``index`` is a cache
    step's one-hot write position and its valid keys (``<= index``)."""
    eye = torch.eye(max_len, dtype=torch.bool, device=device)
    return eye, torch.tril(torch.ones(max_len, max_len, dtype=torch.bool, device=device))


class MultiHeadAttention(nn.Module):
    """Multi-head attention with q/k/v/out projections of width d_model.

    Self-attention with a key-padding mask or none, at a head dim and a
    shape K1 takes, runs on K1 in eval mode when no autograd graph is recorded
    (the kernel has no backward: an eval forward that is differentiated
    takes the plain path, which has); every other call takes
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
        q = self._heads(self.q, query)
        k, v = self._heads(self.k, keyvalue), self._heads(self.v, keyvalue)
        if (not self.training and head_dim_built(d, self.num_heads)
                and shape_built(b, lq, q.shape[2])
                and not (q.requires_grad or k.requires_grad or v.requires_grad)
                and not has_sharded_params(self) and attention_eligible(q, k, mask)):
            out = fused_attention(q, k, v, mask)
        else:
            out = dot_product_attention(q, k, v, mask)
        return self.out(out.reshape(b, lq, -1))

    def _heads(self, proj: Dense, x: torch.Tensor) -> torch.Tensor:
        """(B, L, heads, head dim): all heads, or this rank's whole heads
        when ``parallel.sharding`` split the projection's outputs."""
        b, length, d = x.shape
        return proj(x).view(b, length, -1, d // self.num_heads)

    def project_kv(self, keyvalue: torch.Tensor) -> KVCache:
        """K/V of a sequence, computed once (a decoder's cross-attention)."""
        return {"k": self._heads(self.k, keyvalue), "v": self._heads(self.v, keyvalue)}

    def attend_precomputed(self, query: torch.Tensor, kv: KVCache,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, lq, d = query.shape
        out = dot_product_attention(self._heads(self.q, query), kv["k"], kv["v"], mask)
        return self.out(out.reshape(b, lq, -1))

    def decode_step(self, query_token: torch.Tensor, cache: KVCache,
                    index: int) -> Tuple[torch.Tensor, KVCache]:
        """query_token (B, 1, d): write its K/V at ``index`` and attend over
        the cache's keys up to it; returns ((B, 1, d), the new cache)."""
        b, _, d = query_token.shape
        eye, tril = _step_masks(cache["k"].shape[1], query_token.device)
        onehot = eye[index][None, :, None, None]
        cache = {"k": torch.where(onehot, self._heads(self.k, query_token), cache["k"]),
                 "v": torch.where(onehot, self._heads(self.v, query_token), cache["v"])}
        out = dot_product_attention(self._heads(self.q, query_token), cache["k"], cache["v"],
                                    tril[index][None, None, None, :])
        return self.out(out.reshape(b, 1, -1)), cache

    def init_cache(self, batch: int, max_len: int, device: torch.device) -> KVCache:
        d = self.q.out_features
        shape = (batch, max_len, self.num_heads, d // self.num_heads)
        dt = self.q.compute_dtype
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}


class FeedForward(nn.Module):
    def __init__(self, d_model: int, ffn_dim: int, dropout: float = 0.1,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        self.fc1 = Dense(d_model, ffn_dim, dtype, device)
        self.fc2 = Dense(ffn_dim, d_model, dtype, device)
        self.drop = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, deterministic: bool = False) -> torch.Tensor:
        h = torch.relu(self.fc1(x))
        return self.fc2(h if deterministic else self.drop(h))


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
        dt, nt = self.dtype, norm_dtype(self.dtype)
        if self.norm == "pre":
            h = self.norm1(x, nt).to(dt)
            x = x + self.drop(self.attn(h, h, mask))
            return x + self.drop(self.ffn(self.norm2(x, nt).to(dt)))
        if self._fused_eligible(x, mask):
            return self._fused_forward(x, mask)
        x = self.norm1(x + self.drop(self.attn(x, x, mask)), nt).to(dt)
        return self.norm2(x + self.drop(self.ffn(x)), nt).to(dt)

    def _fused_eligible(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> bool:
        """Route to K2 in eval mode when no autograd graph is recorded (it
        has no backward), at a head dim and a shape it is built for, with a
        key-padding mask or none, and whole local weights (a block split over ranks by
        ``parallel.sharding`` has DTensor parameters and runs the plain
        path); post-LN is checked by the caller.  ``ops.lowp`` plays no
        part, as in the JAX package."""
        if (self.training or not block_head_dim_built(self.d_model, self.num_heads)
                or not block_shape_built(x.shape[0], x.shape[1]) or has_sharded_params(self)):
            return False
        if torch.is_grad_enabled() and (x.requires_grad
                                        or any(p.requires_grad for p in self.parameters())):
            return False
        return mask is None or (mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1)

    def _fused_forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        key_mask = None if mask is None else mask[:, 0, 0, :]
        def fuse():
            weights = fuse_encoder_params(self, dtype=self.dtype)
            return weights, split_block_weights(weights)

        weights, split = cached_on_params(self, fuse)
        return fused_encoder_block(x.to(self.dtype).contiguous(), key_mask, weights,
                                   self.num_heads, split=split)


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
                memory_mask: Optional[torch.Tensor] = None,
                deterministic: bool = False) -> torch.Tensor:
        """Dropout follows the module's mode unless ``deterministic``."""
        dt, nt = self.dtype, norm_dtype(self.dtype)
        drop = (lambda t: t) if deterministic else self.drop
        x = self.norm1(x + drop(self.self_attn(x, x, self_mask)), nt).to(dt)
        x = self.norm2(x + drop(self.cross_attn(x, memory, memory_mask)), nt).to(dt)
        return self.norm3(x + drop(self.ffn(x, deterministic)), nt).to(dt)

    def init_cache(self, batch: int, max_len: int, memory: torch.Tensor) -> Dict[str, KVCache]:
        """The self-attention's KV cache and the cross-attention's K/V of ``memory``."""
        return {"self": self.self_attn.init_cache(batch, max_len, memory.device),
                "cross": self.cross_attn.project_kv(memory)}

    def decode_step(self, x: torch.Tensor, cache: Dict[str, KVCache], index: int,
                    memory_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Dict[str, KVCache]]:
        """One token (B, 1, d) through the block, with no dropout in any mode
        (JAX's ``deterministic=True``)."""
        dt, nt = self.dtype, norm_dtype(self.dtype)
        h, self_cache = self.self_attn.decode_step(x, cache["self"], index)
        x = self.norm1(x + h, nt).to(dt)
        x = self.norm2(x + self.cross_attn.attend_precomputed(x, cache["cross"],
                                                              memory_mask), nt).to(dt)
        x = self.norm3(x + self.ffn(x, deterministic=True), nt).to(dt)
        return x, {"self": self_cache, "cross": cache["cross"]}


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


class TransformerDecoder(nn.Module):
    """A stack of :class:`DecoderBlock`: teacher-forced under a causal mask,
    or one cached token at a time (``init_cache``, ``decode_step``)."""

    def __init__(self, num_layers: int, d_model: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda"):
        super().__init__()
        self.blocks = nn.ModuleList(
            DecoderBlock(d_model, num_heads, ffn_dim, dropout, dtype, device)
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, memory: torch.Tensor,
                memory_mask: Optional[torch.Tensor] = None,
                deterministic: bool = False) -> torch.Tensor:
        causal = make_causal_mask(x.shape[1], x.device)
        for block in self.blocks:
            x = block(x, memory, causal, memory_mask, deterministic)
        return x

    def init_cache(self, batch: int, max_len: int,
                   memory: torch.Tensor) -> Tuple[Dict[str, KVCache], ...]:
        return tuple(block.init_cache(batch, max_len, memory) for block in self.blocks)

    def decode_step(self, x: torch.Tensor, caches: Tuple[Dict[str, KVCache], ...], index: int,
                    memory_mask: Optional[torch.Tensor] = None):
        new_caches = []
        for block, cache in zip(self.blocks, caches):
            x, cache = block.decode_step(x, cache, index, memory_mask)
            new_caches.append(cache)
        return x, tuple(new_caches)


def init_parameters(module: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter from a ``torch.Generator`` seeded with ``seed``:
    LayerNorm scales one and biases zero; other biases zero; embedding tables
    normal(0, 1); matrices and convolution kernels normal with std
    1/sqrt(fan_in); the rest (learned queries, positions, CLS) normal(0, 0.02)."""
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
                elif p.ndim >= 2 and leaf.startswith("weight"):
                    values = torch.randn(p.shape, generator=gen) / math.sqrt(p[0].numel())
                else:
                    values = torch.randn(p.shape, generator=gen) * 0.02
                p.copy_(values)
    return module
