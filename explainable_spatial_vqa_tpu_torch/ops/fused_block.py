"""K2 and K3: one post-LN transformer encoder block on the card.

Port of ``explainable_spatial_vqa_tpu/ops/pallas_block.py``: K2 is
``_block_kernel`` via ``fused_encoder_block``, K3 is ``_tiled_kernel`` via
``fused_encoder_block_tiled``, both with ``fuse_encoder_params`` and
``pad_len``:

    h  = MHA(x)            (QKV projection, per-head attention, out projection)
    x1 = LN1(x + h)        (float32)
    f  = FFN(x1)           (d -> ffn -> d, ReLU)
    y  = LN2(x1 + f)       (in x's type)

Every product rounds its left operand to the weights' type and accumulates in
float32; LayerNorm takes float32 statistics with eps 1e-6.  On the card a
float32 product runs in 3xTF32 on the tensor cores: each operand is split
into two TF32 parts (:func:`split_tf32`), which carries ~2^-22 |x| of error
per operand, as K2's float32 attention does; it is not rounded to TF32 once.
The weights are split once, :func:`split_block_weights`, and the model keeps
the split with its fused weights (``models.layers.cached_on_params``).  The
two kernels differ in one place.  K2 keeps q, k and v float32 into the attention, whose
weights are float32 too.  K3 rounds q, k and v to the weights' type after the
bias and runs K1's arithmetic on them: float32 scores and softmax, weights
rounded to the weights' type, float32 sums.  With float32 weights the two
compute the same numbers.

K3's ``batch_tile`` and ``ffn_chunks`` keep the JAX contract and do not change
the result (every step but the attention works row by row, and the attention
works per sequence).  ``batch_tile`` is checked and otherwise unused: the
kernels tile all B*L rows at once.  ``ffn_chunks`` splits the FFN's rows into
that many pairs of launches, so the (rows, ffn) hidden scratch is that many
times smaller, as the TPU kernel keeps its hidden within VMEM.

The kernels are in ``csrc/fused_block.cu`` (a GEMM with a fused bias/ReLU
epilogue, wgmma fed by TMA: bf16 for bf16 operands, 3xTF32 for float32 ones;
the K1 attention kernel; a residual-add + LayerNorm kernel), all launched by
one C call per block:
``esv_encoder_block`` for K2, ``esv_encoder_block_tiled`` for K3.  The GEMM
alone is :func:`~explainable_spatial_vqa_tpu_torch.ops.block_gemm.block_gemm`.
:func:`fused_encoder_block_plain` and
:func:`fused_encoder_block_tiled_plain` are their plain PyTorch versions.  A
CPU tensor runs the plain version; a CUDA tensor launches the kernels or
raises.  There is no backward: the encoder routes to K2 only in eval mode,
and nothing in the model routes to K3 (``bench_block`` drives it).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional

import torch

from explainable_spatial_vqa_tpu_torch.ops import _build
from explainable_spatial_vqa_tpu_torch.ops.attention import scaled_attention
from explainable_spatial_vqa_tpu_torch.ops.fused_attention import (
    DTYPE_CODES,
    MAX_HEAD_DIM,
    MAX_LEN,
    key_mask_f32,
)

__all__ = ["BlockWeights", "SplitWeights", "block_scratch", "fuse_encoder_params",
           "fused_encoder_block", "fused_encoder_block_plain", "fused_encoder_block_tiled",
           "fused_encoder_block_tiled_plain", "split_block_weights", "split_tf32",
           "tiled_plain_after_qkv", "pad_len", "block_head_dim_built", "block_shape_built",
           "kernel_launches", "BLOCK_HEAD_DIMS", "LN_EPS"]

LN_EPS = 1e-6  # flax.linen.LayerNorm default, and ops/pallas_block.py:106
# the head dims csrc/fused_block.cu runs its attention at, the multiples of
# 128 up to MAX_HEAD_DIM (attention_padded.cuh: block_head_dim; attention.cuh's
# kernels at 128, attention_padded.cuh's at 256, its deep kernels at 384 and
# 512): the JAX package routes to its fused block where d_model and the head
# dim are multiples of 128 (models/layers.py:_fused_eligible), which at the
# presets' 4 heads up to d_model 2048 are these
BLOCK_HEAD_DIMS = tuple(range(128, MAX_HEAD_DIM + 1, 128))


def block_head_dim_built(d_model: int, num_heads: int) -> bool:
    """JAX's rule (d_model and the head dim multiples of 128) at the head
    dims K2 and K3 are built for (:data:`BLOCK_HEAD_DIMS`).  The models send
    K2 nothing else, and the wrappers raise on a CUDA tensor of another head
    dim."""
    return (d_model % 128 == 0 and d_model % num_heads == 0
            and d_model // num_heads in BLOCK_HEAD_DIMS)


def block_shape_built(batch: int, length: int) -> bool:
    """The kernels' limits past the head dim: 1 to ``MAX_LEN`` keys (the
    attention's, ``ops.fused_attention.MAX_LEN``), a batch of at most 65535
    (the attention grid's z) and at most 65535 * 64 rows.  The encoder routes
    by it and the wrappers hold their inputs to it, so the two agree."""
    return 1 <= length <= MAX_LEN and batch <= 65535 and batch * length <= 65535 * 64


def pad_len(length: int, multiple: int = 8) -> int:
    """The JAX kernel's sequence padding (``ops/pallas_block.py:109``).  The
    CUDA kernels mask the ragged edge themselves, so the port never pads."""
    return ((length + multiple - 1) // multiple) * multiple


class BlockWeights(NamedTuple):
    """One encoder block's parameters in the kernels' layout: matrices are
    (out_features, in_features) in the weight type, q/k/v stacked into one
    (3d, d) matrix; biases and LayerNorm parameters are float32.  With
    float32 matrices the kernels read their TF32 split
    (:class:`SplitWeights`), not the matrices themselves."""

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


class SplitWeights(NamedTuple):
    """The float32 matrices of a :class:`BlockWeights` as the 3xTF32 GEMM
    reads them: each (N, K) matrix as its (2N, K) :func:`split_tf32`."""

    qkv: torch.Tensor  # (6d, d)
    out: torch.Tensor  # (2d, d)
    ffn1: torch.Tensor  # (2 ffn, d)
    ffn2: torch.Tensor  # (2d, ffn)


def split_tf32(w: torch.Tensor) -> torch.Tensor:
    """A float32 (N, K) matrix as the 3xTF32 GEMM reads it: (2N, K), the hi
    parts over the lo parts.  hi is w rounded to TF32's 10 mantissa bits
    (to nearest, ties away from zero: half a TF32 ulp added to the bits,
    then the low 13 bits cleared) and lo = w - hi, exact in float32, so hi +
    lo == w and |lo| <= 2^-11 |w| for normal w; the tensor cores read the
    top bits of lo.  The rule of ``split_tf32`` in ``csrc/attention.cuh``,
    which the kernel applies to its left operand."""
    if w.dtype != torch.float32 or w.ndim != 2:
        raise ValueError(f"split_tf32: needs a float32 matrix, got {w.dtype} {tuple(w.shape)}")
    hi = ((w.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.cat([hi, w - hi])


def split_block_weights(w: BlockWeights) -> Optional[SplitWeights]:
    """The TF32 split of ``w``'s four matrices where they are float32; None
    for bf16 weights, which the kernels read as they are."""
    if w.qkv.dtype != torch.float32:
        return None
    return SplitWeights(*(split_tf32(t) for t in (w.qkv, w.out, w.ffn1, w.ffn2)))


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


def _dense(a: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """a rounded to the weights' type, times weight^T, float32 sums, plus bias."""
    return a.to(weight.dtype).float() @ weight.float().t() + bias


def _key_mask4(mask: Optional[torch.Tensor], batch: int, length: int) -> Optional[torch.Tensor]:
    if mask is None:
        return None
    return (key_mask_f32(mask, batch, length) > 0)[:, None, None, :]


def fused_encoder_block_plain(
    x: torch.Tensor, mask: Optional[torch.Tensor], w: BlockWeights, num_heads: int,
) -> torch.Tensor:
    """Plain PyTorch version of K2's kernels, following ``_block_kernel``'s
    arithmetic (``ops/pallas_block.py:113-160``)."""
    batch, length, d_model = x.shape
    xf = x.float()
    q, k, v = _dense(xf, w.qkv, w.qkv_bias).split(d_model, dim=-1)
    heads = (batch, length, num_heads, d_model // num_heads)
    attn = scaled_attention(q.reshape(heads), k.reshape(heads), v.reshape(heads),
                            _key_mask4(mask, batch, length), bf16_scores=False)
    o = _dense(attn.reshape(batch, length, d_model), w.out, w.out_bias)
    x1 = _layer_norm(xf + o, w.ln1_scale, w.ln1_bias)
    h1 = torch.relu(_dense(x1, w.ffn1, w.ffn1_bias))
    f = _dense(h1, w.ffn2, w.ffn2_bias)
    return _layer_norm(x1 + f, w.ln2_scale, w.ln2_bias).to(x.dtype)


def _check_tiled(batch: int, length: int, d_model: int, batch_tile: int,
                         ffn_chunks: int) -> None:
    """The JAX wrapper's asserts (``ops/pallas_block.py:286-289``), raised as
    ValueError."""
    if length % 8 or d_model % 128:
        raise ValueError(f"fused_encoder_block_tiled: pad L to 8 and d to 128 "
                         f"(L={length}, d={d_model})")
    if batch_tile < 1 or batch % batch_tile:
        raise ValueError(f"fused_encoder_block_tiled: batch {batch} must divide by "
                         f"batch_tile {batch_tile}")
    if ffn_chunks < 1 or (batch_tile * length) % ffn_chunks:
        raise ValueError(f"fused_encoder_block_tiled: batch_tile * L = {batch_tile * length} "
                         f"must divide by ffn_chunks {ffn_chunks}")


def fused_encoder_block_tiled_plain(
    x: torch.Tensor, mask: Optional[torch.Tensor], w: BlockWeights, num_heads: int,
    batch_tile: int = 4, ffn_chunks: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version of K3's kernels, following ``_tiled_kernel``
    (``ops/pallas_block.py:197-271``) line by line, with every tile of
    ``batch_tile`` sequences taken at once: the projections on the flattened
    rows, q/k/v rounded to the weights' type, the per-sequence attention, and
    the FFN in row chunks of ``batch_tile * L / ffn_chunks``, the TPU's.
    Like ``_tiled_kernel`` it needs only that the chunks divide the rows; the
    padding rules are the wrapper's.

    The QKV sums are taken in float64 and rounded to float32 once: the
    correctly rounded float32 dot that every float32 accumulation
    approximates.  q, k and v are rounded to the weights' type next, and a
    rounding that an order of float32 sums pushes the other way moves the
    attention of every query of the sequence; the kernel keeps its sums
    close to exact for the same reason (``csrc/fused_block.cu``)."""
    wdt = w.qkv.dtype
    xf = x.float().reshape(-1, x.shape[-1])
    qkv = ((xf.to(wdt).double() @ w.qkv.double().t()).float() + w.qkv_bias).to(wdt)
    return tiled_plain_after_qkv(x, mask, w, num_heads, qkv, batch_tile, ffn_chunks)


def tiled_plain_after_qkv(
    x: torch.Tensor, mask: Optional[torch.Tensor], w: BlockWeights, num_heads: int,
    qkv: torch.Tensor, batch_tile: int = 4, ffn_chunks: int = 1,
) -> torch.Tensor:
    """The rest of :func:`fused_encoder_block_tiled_plain` from ``qkv``, its
    q, k and v as a (B*L, 3d) tensor in the weights' type: so K3's output can
    be held against the plain arithmetic on the kernel's own q, k and v."""
    batch, length, d_model = x.shape
    wdt = w.qkv.dtype
    rows = batch * length
    xf = x.float().reshape(rows, d_model)
    q, k, v = qkv.split(d_model, dim=-1)
    heads = (batch, length, num_heads, d_model // num_heads)
    # float32 scores and softmax, weights rounded to V's type (the weights'),
    # float32 sums; rounding the output to that type here is the rounding the
    # out projection applies to it
    attn = scaled_attention(q.reshape(heads), k.reshape(heads), v.reshape(heads),
                            _key_mask4(mask, batch, length), bf16_scores=False)
    o = _dense(attn.reshape(rows, d_model), w.out, w.out_bias)
    x1 = _layer_norm(xf + o, w.ln1_scale, w.ln1_bias)
    chunk = batch_tile * length // ffn_chunks
    x1c = x1.to(wdt).reshape(rows // chunk, chunk, d_model)  # one FFN chunk per row
    h1 = torch.relu(x1c.float() @ w.ffn1.float().t() + w.ffn1_bias)
    f = (h1.to(wdt).float() @ w.ffn2.float().t()).reshape(rows, d_model) + w.ffn2_bias
    y = _layer_norm(x1 + f, w.ln2_scale, w.ln2_bias)
    return y.reshape(batch, length, d_model).to(x.dtype)


def _check_launch(name: str, x: torch.Tensor, weights: BlockWeights, num_heads: int,
                  split: Optional[SplitWeights]) -> None:
    """Raise unless the kernels take these inputs: a contiguous x and
    weights on one device, in float32 or bf16, with the shapes of
    :class:`BlockWeights`, a head dim and a shape the kernels are built for
    (:func:`block_head_dim_built`, :func:`block_shape_built`), and with
    float32 weights their split, each matrix (2N, K) float32; every base
    16-byte aligned (TMA's rule).  It reads no device memory, so it runs on
    CPU tensors too."""
    batch, length, d_model = x.shape
    wdt = weights.qkv.dtype
    ffn = weights.ffn1.shape[0]
    if x.dtype not in DTYPE_CODES or wdt not in DTYPE_CODES:
        raise ValueError(f"{name}: x and weights must be one of {list(DTYPE_CODES)}")
    if not (block_head_dim_built(d_model, num_heads) and block_shape_built(batch, length)):
        raise ValueError(
            f"{name}: d = {d_model} must be a multiple of 128 and d/H = {d_model}/{num_heads} "
            f"one of {BLOCK_HEAD_DIMS}, length {length} 1 to {MAX_LEN}, batch at most 65535 "
            f"and batch * length at most {65535 * 64}")
    shapes = {"qkv": (3 * d_model, d_model), "out": (d_model, d_model), "ffn1": (ffn, d_model),
              "ffn2": (d_model, ffn), "qkv_bias": (3 * d_model,), "ffn1_bias": (ffn,)}
    for key, t in weights._asdict().items():
        want_dtype = wdt if key in ("qkv", "out", "ffn1", "ffn2") else torch.float32
        want_shape = shapes.get(key, (d_model,))
        if (t.dtype != want_dtype or tuple(t.shape) != want_shape or t.device != x.device
                or not t.is_contiguous()):
            raise ValueError(
                f"{name}: weight {key} must be a contiguous {want_shape} "
                f"{want_dtype} tensor on {x.device}")
    splits = () if split is None else tuple(split)
    if (wdt == torch.float32) != (split is not None) or any(
            s.dtype != torch.float32 or s.shape != (2 * t.shape[0], t.shape[1])
            or s.device != x.device or not s.is_contiguous()
            for s, t in zip(splits, (weights.qkv, weights.out, weights.ffn1, weights.ffn2))):
        raise ValueError(f"{name}: float32 weights, and only they, take their split, each "
                         f"matrix a contiguous (2N, K) float32 tensor on {x.device}")
    if ffn % 8:
        raise ValueError(f"{name}: ffn {ffn} must be a multiple of 8")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if any(t.data_ptr() % 16 for t in (x, *weights, *splits)):
        raise ValueError(f"{name}: x and the weights must start on 16-byte boundaries")


def block_scratch(x: torch.Tensor, weights: BlockWeights, tiled: bool,
                  ffn_chunks: int = 1) -> List[Optional[torch.Tensor]]:
    """The scratch of one block launch, in the C interface's order: qkv
    (B*L, 3d), float32 for K2 and in the weights' type for K3; attn (B*L, d)
    in the weights' type (the out projection's rounding); proj and x1 (B*L,
    d) float32 (x1 holds a bf16 x widened for the QKV product before LN1
    where the weights are float32); x1w, x1 rounded to bf16 for FFN1's TMA
    loads (None with float32 weights, whose products read float32 operands
    and split them on the card); hidden (B*L / ffn_chunks, ffn) in the
    weights' type."""
    batch, length, d_model = x.shape
    rows, wdt, ffn = batch * length, weights.qkv.dtype, weights.ffn1.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    w = dict(dtype=wdt, device=x.device)
    return [torch.empty(rows, 3 * d_model, **(w if tiled else f32)),
            torch.empty(rows, d_model, **w),
            torch.empty(rows, d_model, **f32), torch.empty(rows, d_model, **f32),
            None if wdt == torch.float32 else torch.empty(rows, d_model, **w),
            torch.empty(rows // ffn_chunks, ffn, **w)]


@functools.lru_cache(maxsize=None)
def _launch_counters():
    return _build.launch_counters("fused_block", "esv_block_attention_kernel",
                                  "esv_block_attention_launches")


def kernel_launches() -> Dict[str, int]:
    """The attention launches of K2 and K3, by kernel function, as the block
    library counts them since it was loaded: ``attention_kernel_f32`` and
    ``attention_kernel`` at head dim 128, at 256 ``attention_kernel_split_f32``
    (K2, float32 q/k/v, past 16 keys), ``attention_kernel_wgmma`` (K3, bf16,
    17-256 keys), at 384 and 512 ``attention_kernel_wide_f32`` (K2) and
    ``attention_kernel_wgmma_deep`` (K3, 17-256 keys), at 256-512
    ``attention_kernel_wgmma_2pass_deep`` (K3 past 256 keys), and at
    256-512 ``attention_kernel_short_f32`` (K2) and ``attention_kernel_short``
    (K3) on rows of at most 16 keys
    (``launch_block_attention`` in ``csrc/attention_padded.cuh`` picks).
    Needs the library (a card and ``nvcc``)."""
    names, count = _launch_counters()
    return {n: count(i) for i, n in enumerate(names)}


def _launch(wrapper, name: str, x, mask, weights: BlockWeights, split: Optional[SplitWeights],
            scratch, ints) -> torch.Tensor:
    """Call the C entry point ``name`` once, counting the launch on ``wrapper``;
    with float32 weights the kernels read the matrices' split."""
    mask_f = key_mask_f32(mask, x.shape[0], x.shape[1])
    if mask_f is not None:
        mask_f = mask_f.to(x.device)
    out = torch.empty_like(x)
    if split is not None:
        weights = weights._replace(**split._asdict())
    ptrs = [x, mask_f, *weights, out, *scratch]
    # 21 pointers, the ints, the stream; bound once per loaded library
    fn = _build.entry("fused_block", name, (ctypes.c_void_p,) * 21 + (ctypes.c_int,) * len(ints)
                      + (ctypes.c_void_p,))
    with torch.cuda.device(x.device):
        wrapper.launches += 1
        status = fn(
            *(None if t is None else t.data_ptr() for t in ptrs), *ints,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, name)
    return out


def fused_encoder_block(
    x: torch.Tensor,  # (B, L, d)
    mask: Optional[torch.Tensor],  # (B, L) bool/float key mask or None
    weights: BlockWeights,
    num_heads: int,
    split: Optional[SplitWeights] = None,
) -> torch.Tensor:
    """K2, one post-LN encoder block: the kernels on CUDA, the plain version
    on CPU.  ``split``: float32 weights' :func:`split_block_weights`, made
    here on each call where it is None."""
    if x.device.type == "cpu":
        return fused_encoder_block_plain(x, mask, weights, num_heads)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_block: unsupported device {x.device}")
    split = split if split is not None else split_block_weights(weights)
    _check_launch("fused_encoder_block", x, weights, num_heads, split)
    batch, length, d_model = x.shape
    scratch = block_scratch(x, weights, tiled=False)
    return _launch(fused_encoder_block, "esv_encoder_block", x, mask, weights, split, scratch,
                   (batch, length, d_model, num_heads, weights.ffn1.shape[0],
                    DTYPE_CODES[x.dtype], DTYPE_CODES[weights.qkv.dtype]))


fused_encoder_block.launches = 0


def fused_encoder_block_tiled(
    x: torch.Tensor,  # (B, L, d)
    mask: Optional[torch.Tensor],  # (B, L) bool/float key mask or None
    weights: BlockWeights,
    num_heads: int,
    batch_tile: int = 4,
    ffn_chunks: int = 1,
    split: Optional[SplitWeights] = None,
) -> torch.Tensor:
    """K3, the batch-tiled block with q/k/v in the weights' type: the kernels
    on CUDA, the plain version on CPU.  Raises where the JAX wrapper asserts.
    ``split`` as for :func:`fused_encoder_block`."""
    batch, length, d_model = x.shape
    _check_tiled(batch, length, d_model, batch_tile, ffn_chunks)
    if x.device.type == "cpu":
        return fused_encoder_block_tiled_plain(x, mask, weights, num_heads, batch_tile,
                                               ffn_chunks)
    if x.device.type != "cuda":
        raise ValueError(f"fused_encoder_block_tiled: unsupported device {x.device}")
    split = split if split is not None else split_block_weights(weights)
    _check_launch("fused_encoder_block_tiled", x, weights, num_heads, split)
    scratch = block_scratch(x, weights, tiled=True, ffn_chunks=ffn_chunks)
    return _launch(fused_encoder_block_tiled, "esv_encoder_block_tiled", x, mask, weights, split,
                   scratch,
                   (batch, length, d_model, num_heads, weights.ffn1.shape[0], ffn_chunks,
                    DTYPE_CODES[x.dtype], DTYPE_CODES[weights.qkv.dtype]))


fused_encoder_block_tiled.launches = 0
