"""K1: fused masked self-attention on the card.

Port of ``explainable_spatial_vqa_tpu/ops/pallas_attention.py``
(``_fused_attention_bhld`` via ``fused_attention``).  The kernel is
``csrc/fused_attention.cu``; its plain version is
:func:`explainable_spatial_vqa_tpu_torch.ops.attention.dot_product_attention`
with ``ops.lowp``'s softmax off (``scaled_attention(..., bf16_scores=False)``),
which computes the same arithmetic.

:func:`fused_attention` takes self-attention (``Lq == Lk``) with a key-padding
mask or none, the calls :func:`attention_eligible` accepts.  A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises.  The TPU
kernel takes any head dim, and so does K1 from 1 to :data:`MAX_HEAD_DIM`
(512, :data:`HEAD_DIMS`):
every multiple of 8 up to 128 has kernels of its own
(:data:`EXACT_HEAD_DIMS`, one instantiation each), every other head dim runs
the padded kernels at its padded depth (:func:`padded_depth`, one of
:data:`PADDED_DEPTHS`, the head dim a run-time argument).  Rows take 1 to
:data:`MAX_LEN` keys, the C library's own cap.  The models route to K1
exactly where the wrapper takes the call (:func:`head_dim_built` and
:func:`shape_built`, which :func:`check_attention` applies too).  K2 and K3
have their own, narrower set (``ops.fused_block.BLOCK_HEAD_DIMS``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch

from explainable_spatial_vqa_tpu_torch.ops import _build
from explainable_spatial_vqa_tpu_torch.ops.attention import scaled_attention

__all__ = ["fused_attention", "attention_eligible", "check_attention", "head_dim_built",
           "shape_built", "padded_depth", "key_mask_f32", "kernel_launches", "bind_entry",
           "call_entry", "call_rows", "HEAD_DIMS", "EXACT_HEAD_DIMS", "PADDED_DEPTHS", "MAX_LEN",
           "MAX_HEAD_DIM", "DTYPE_CODES"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the widest head dim, csrc/attention.cuh's kAttnMaxHeadDim (the widest held
# against the plain version on the card: 4 heads of d_model 2048); K2's and
# K3's head dims are its multiples of 128 (ops.fused_block.BLOCK_HEAD_DIMS)
MAX_HEAD_DIM = 512
# K1's head dims on the card: every one from 1 to MAX_HEAD_DIM
HEAD_DIMS = tuple(range(1, MAX_HEAD_DIM + 1))
# the head dims with kernels of their own in csrc/fused_attention.cu
# (ESV_K1_HEAD_DIMS; compiled in the groups of ops._build.K1_DIM_GROUPS):
# every multiple of 8 up to 128, among them 4 heads of d_model 96 and 192
# (the CoGenT protocol's executors), 256 (the baselines, the CoT IQAP,
# HierarchicalGenerator's preset) and 512 (the thesis executor)
EXACT_HEAD_DIMS = tuple(range(8, 129, 8))
# the depths of the padded kernels (csrc/attention_padded.cuh;
# ESV_K1_PAD_DEPTHS, compiled in the groups of ops._build.K1_PAD_GROUPS),
# which take every other head dim: past 256 its deep kernels
PADDED_DEPTHS = tuple(range(16, 129, 16)) + (160, 192, 224, 256, 288, 336, 384, 448, 512)
# the longest row of keys, csrc/attention.cuh's kAttnMaxLen (the longest row
# held against the plain version on the card; no kernel needs a cap)
MAX_LEN = 4096


def padded_depth(head_dim: int) -> int:
    """The depth of the padded kernel that takes ``head_dim``
    (``attention_padded.cuh: padded_depth``): up to 128 the head dim rounded
    up to 16; past it G = ceil(head_dim / 128) warps share a row group, each
    a slice of the depth, so G times its G-th part rounded up to 16."""
    slices = -(-head_dim // 128) if head_dim > 128 else 1
    return slices * ((-(-head_dim // slices) + 15) // 16 * 16)


def head_dim_built(d_model: int, num_heads: int) -> bool:
    """True when ``d_model`` splits into ``num_heads`` heads of a dim K1
    takes (:data:`HEAD_DIMS`: 1 to :data:`MAX_HEAD_DIM`).  JAX's dispatch
    (``ops/attention.py:51-59``) has no head-dim condition: its kernel takes
    any; here every head dim a preset or a CLI width gives up to d_model
    2048 at 4 heads is one."""
    return d_model % num_heads == 0 and d_model // num_heads in HEAD_DIMS


def shape_built(batch: int, length: int, heads: int) -> bool:
    """The kernel's limits past the head dim: 1 to :data:`MAX_LEN` keys, and
    batch and heads at most 65535 (the grid's y and z).  The models route by
    it and :func:`check_attention` holds the wrapper to it, so the two agree
    on every length."""
    return 1 <= length <= MAX_LEN and batch <= 65535 and heads <= 65535


def attention_eligible(q: torch.Tensor, k: torch.Tensor, mask: Optional[torch.Tensor]) -> bool:
    """The JAX dispatch rule (``ops/attention.py:51-59``): same length for
    queries and keys, and a mask that is None or a (B, 1, 1, L) key mask."""
    key_pad_only = mask is None or (
        mask.ndim == 4 and mask.shape[1] == 1 and mask.shape[2] == 1)
    return q.shape[1] == k.shape[1] and key_pad_only


def key_mask_f32(mask: Optional[torch.Tensor], batch: int, length: int) -> Optional[torch.Tensor]:
    """A (B, L) bool/float key mask or a (B|1, 1, 1, L) one as the kernels'
    contiguous (B, L) float32 mask (keep where > 0); None stays None."""
    if mask is None:
        return None
    if mask.ndim == 4:
        mask = mask[:, 0, 0, :]
    return mask.to(torch.float32).expand(batch, length).contiguous()


def check_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ValueError unless the kernel takes these (B, L, H, D) tensors:
    one shape, dtype and device, a dtype of :data:`DTYPE_CODES`, a head dim
    of :data:`HEAD_DIMS` and a shape :func:`shape_built` takes, contiguous,
    and at a head dim of :data:`EXACT_HEAD_DIMS` 16-byte aligned (those
    kernels copy 16 bytes at a time).  Every other head dim takes any base:
    its kernels copy 16 bytes at a time where a head's rows are whole
    16-byte chunks on 16-byte boundaries, and elsewhere the wgmma kernels
    build 16-byte chunks from 4-byte words, the deep float32 and short
    kernels copy each row's 16-byte middle into a row shifted in shared
    memory, and the padded kernels load element by element."""
    b, length, heads, head_dim = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"fused_attention: {name} must match q's shape, dtype and device")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"fused_attention: dtype {q.dtype} not in {list(DTYPE_CODES)}")
    if head_dim not in HEAD_DIMS or not shape_built(b, length, heads):
        raise ValueError(
            f"fused_attention: head dim {head_dim} must be 1 to {HEAD_DIMS[-1]}, "
            f"length {length} 1 to {MAX_LEN}, batch and heads at most 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("fused_attention: q, k and v must be contiguous")
    if head_dim in EXACT_HEAD_DIMS and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("fused_attention: q, k and v must start on 16-byte boundaries")


_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_longlong,) * 4
             + (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))


def bind_entry(lib: ctypes.CDLL, entry: str = "esv_attention"):
    """``lib``'s C entry ``entry`` (``esv_attention`` or, with the same
    arguments, ``esv_attention_fma_scores``) with its argument and result
    types set."""
    return _build.bind_entry(lib, entry, _ARGTYPES)


@functools.lru_cache(maxsize=None)
def _esv_attention(entry: str = "esv_attention"):
    """The C entry ``entry`` of ``csrc/fused_attention.cu``: ``esv_attention``,
    or ``esv_attention_fma_scores`` (the ring with FMA-chain scores on the
    CUDA cores, which no wrapper launches).  Bound once, on the first call,
    after ``_build.load`` has built and loaded the library."""
    return bind_entry(_build.load("fused_attention"), entry)


def call_entry(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor]) -> torch.Tensor:
    """One call of a bound entry ``fn`` on (B, L, H, D) CUDA tensors that
    :func:`check_attention` accepts, on the current stream; the output is
    of q's type.  Raises on a status other than 0."""
    b, length, heads, head_dim = q.shape
    mask_f = key_mask_f32(mask, b, length)
    if mask_f is not None:
        mask_f = mask_f.to(q.device)
    out = torch.empty_like(q)
    strides = (length * heads * head_dim, heads * head_dim)
    code = DTYPE_CODES[q.dtype]
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask_f is None else mask_f.data_ptr(), out.data_ptr(),
                    b, heads, length, head_dim, *strides, *strides, code, code,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, fn.__name__)
    return out


def call_rows(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], heads: int, out_dtype: torch.dtype) -> torch.Tensor:
    """One call of a bound entry with ``esv_attention``'s arguments (it, or
    the block library's ``esv_block_attention``) on q, k, v given as (B, L,
    H * D) CUDA views with one batch and row stride and unit column stride:
    contiguous (B, L, H, D) tensors flattened, or the thirds of K2's and
    K3's (B, L, 3d) projection buffer.  The output is a new (B, L, H * D)
    tensor of ``out_dtype``.  Raises on a status other than 0."""
    b, length, width = q.shape
    mask_f = key_mask_f32(mask, b, length)
    if mask_f is not None:
        mask_f = mask_f.to(q.device)
    out = torch.empty(b, length, width, dtype=out_dtype, device=q.device)
    with torch.cuda.device(q.device):
        status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    None if mask_f is None else mask_f.data_ptr(), out.data_ptr(),
                    b, heads, length, width // heads, q.stride(0), q.stride(1),
                    length * width, width, DTYPE_CODES[q.dtype], DTYPE_CODES[out_dtype],
                    torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, fn.__name__)
    return out


@functools.lru_cache(maxsize=None)
def _launch_counters():
    return _build.launch_counters("fused_attention", "esv_attention_kernel",
                                  "esv_attention_launches")


def kernel_launches() -> Dict[str, int]:
    """K1's launches by kernel function, as the C library counts them since
    it was loaded: ``attention_kernel_f32``, ``attention_kernel``,
    ``attention_kernel_onepass`` (the head dims of :data:`EXACT_HEAD_DIMS`),
    ``attention_kernel_padded_f32`` (every other head dim up to 256) and
    ``attention_kernel_padded`` (bf16, every other head dim up to 128),
    ``attention_kernel_deep_f32`` (every other head dim past 256),
    ``attention_kernel_short_f32`` and ``attention_kernel_short`` (rows of
    at most 16 keys past padded depth 128: the box decoders at d_model
    768-2048), and on ``csrc/attention_wide.cuh``
    ``attention_kernel_split_f32`` (float32 at padded depth 256),
    ``attention_kernel_wgmma`` (bf16 of 17-256 keys at head dims 72-128 and
    at padded depths 160-256, in rows of any width),
    ``attention_kernel_wgmma_deep`` (the same at padded depths 288-512) and
    ``attention_kernel_wgmma_2pass`` (bf16 past 256 keys at the head dims of
    :data:`EXACT_HEAD_DIMS`) and ``attention_kernel_wgmma_2pass_deep`` (bf16
    past 256 keys at the padded depths 160-512, in rows of any width), and on
    ``csrc/attention_f32_wide.cuh``
    ``attention_kernel_wide_f32`` (float32 past 16 keys at the padded depths
    160-224 and 288-512, rows of whole 16-byte chunks).  Which one
    a call takes is decided in ``launch_attention_dim``
    (``csrc/attention.cuh``) and
    ``launch_attention_padded`` (``csrc/attention_padded.cuh``) alone; the
    difference of two readings says which ran.  Needs the library (a card and
    ``nvcc``)."""
    names, count = _launch_counters()
    return {n: count(i) for i, n in enumerate(names)}


def fused_attention(
    q: torch.Tensor,  # (B, L, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # (B|1, 1, 1, L) bool, True = attend
) -> torch.Tensor:
    """Masked self-attention, (B, L, H, D) in and out (the JAX layout)."""
    if not attention_eligible(q, k, mask):
        raise ValueError(
            "fused_attention takes self-attention (Lq == Lk) with a (B, 1, 1, L) "
            "key mask or none; use dot_product_attention for other calls")
    if q.device.type == "cpu":
        return scaled_attention(q, k, v, mask, bf16_scores=False)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    check_attention(q, k, v)
    fn = _esv_attention()
    fused_attention.launches += 1
    return call_entry(fn, q, k, v, mask)


fused_attention.launches = 0
