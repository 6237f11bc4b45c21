"""Feature extraction, ported from
``explainable_spatial_vqa_tpu/vision/extract.py``: PNGs to the features h5,
``features`` (N, 1024, 14, 14) float32 in NCHW.

The host decodes with PIL in a thread pool (PIL is imported inside the
call); the device resizes to 224x224 with the JAX package's antialiased
Keys cubic (:func:`cubic_resize`, two matmuls with weights built on the
host as ``jax.image.resize`` builds them), normalizes and runs the
ResNet (:func:`make_extract_fn`).  The batch loop
(:func:`extract_to_sink`) copies each batch's features to pinned host
memory on a side stream and hands them to a sink while the next batch's
forward runs.  :func:`collect_image_paths` lists the image directory's PNGs
in index order; :func:`_decode_resize_pil` is the reference-exact host
resize.
"""

from __future__ import annotations

import contextlib
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.vision.resnet import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ResNetFeatures,
)

__all__ = ["collect_image_paths", "cubic_resize", "extract_features", "extract_to_sink",
           "make_extract_fn"]

F32 = np.float32


def collect_image_paths(image_dir: str, max_images: Optional[int] = None) -> List[str]:
    """The directory's *.png sorted by their trailing index, which must run
    densely over 0..N-1."""
    entries: List[Tuple[str, int]] = []
    for fn in os.listdir(image_dir):
        if not fn.endswith(".png"):
            continue
        idx = int(os.path.splitext(fn)[0].split("_")[-1])
        entries.append((os.path.join(image_dir, fn), idx))
    entries.sort(key=lambda e: e[1])
    if not entries:
        raise ValueError("No valid images found in the input directory.")
    indices = [i for _, i in entries]
    assert len(set(indices)) == len(entries)
    assert min(indices) == 0 and max(indices) == len(entries) - 1
    if max_images is not None:
        entries = entries[:max_images]
    return [p for p, _ in entries]


def _fma(a: np.ndarray, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64."""
    return (np.asarray(a, np.float64) * np.float64(b) + np.float64(c)).astype(F32)


@functools.lru_cache(maxsize=None)
def _weight_mat(in_size: int, out_size: int) -> np.ndarray:
    """(in, out) float32 weights of one axis, as ``jax.image.resize(...,
    method="cubic", antialias=True)`` computes them (``compute_weight_mat``
    in ``jax/_src/image/scale.py``): the Keys cubic (a = -0.5) widened by
    1/scale when downsampling, the weights of each output renormalized over
    its in-bounds taps, and zero where the sample lies outside [-0.5, in -
    0.5].

    The resize is jitted in JAX, and XLA evaluates the formula with each
    multiply-add rounded once and the division by the kernel's scale folded
    into a multiply by its float32 reciprocal (and into the cubic's
    coefficients).  Those roundings are reproduced here: the formula
    evaluated operation by operation in float32 lies up to 1.1e-5 from
    JAX's weights (in the sample positions near 256 and 480, whose float32
    ulp is 3e-5), which moves a 0-255 resize by 2.3e-3."""
    inv_scale = F32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, F32(1.0))
    sample = _fma(np.arange(out_size, dtype=F32) + F32(0.5), inv_scale, -0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=F32)[:, None])
    if kernel_scale == F32(1.0):
        m, c3, c2 = x, F32(1.5), F32(-0.5)
    else:
        r = F32(1.0) / kernel_scale
        m, c3, c2 = x * r, F32(F32(1.5) * r), F32(F32(-0.5) * r)
    near = _fma(_fma(x, c3, -2.5) * m, m, 1.0)  # |t| < 1: (1.5 t - 2.5) t^2 + 1
    far = _fma(_fma(_fma(x, c2, 2.5), m, -4.0), m, 2.0)  # 1 <= |t| < 2
    weights = np.where(m >= 2, F32(0.0), np.where(m >= 1, far, near)).astype(F32)
    total = weights.sum(axis=0, keepdims=True, dtype=F32)
    weights = np.where(np.abs(total) > F32(1000.0 * np.finfo(F32).eps),
                       weights / np.where(total != 0, total, F32(1.0)), F32(0.0))
    inside = (sample >= F32(-0.5)) & (sample <= F32(in_size - 0.5))
    return np.where(inside[None, :], weights, F32(0.0)).astype(F32)


def cubic_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(x, (N, size[0], size[1], C), method="cubic")`` with
    its default antialiasing, on (N, H, W, C) floating-point ``x``: each
    axis whose length changes is contracted with its weight matrix, on
    ``x``'s device and in ``x``'s type.  Not ``F.interpolate``'s bicubic,
    whose a = -0.75 kernel clamps at the edges and does not widen when it
    downsamples."""
    n, h, w, c = x.shape
    y = x.permute(0, 3, 1, 2)  # (N, C, H, W): both contractions are plain matmuls
    if size[0] != h:
        wh = torch.from_numpy(_weight_mat(h, size[0])).to(device=x.device, dtype=x.dtype)
        y = torch.matmul(wh.T, y)
    if size[1] != w:
        ww = torch.from_numpy(_weight_mat(w, size[1])).to(device=x.device, dtype=x.dtype)
        y = torch.matmul(y, ww)
    return y.permute(0, 2, 3, 1)


@contextlib.contextmanager
def _convolutions_in_float32() -> Iterator[None]:
    """cuDNN's TF32 off for the ``with`` block (PyTorch allows it by
    default): the float32 extractor computes in float32, as the JAX module
    declares.  The flag is put back on exit."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def make_extract_fn(model: ResNetFeatures,
                    size: Tuple[int, int] = (224, 224)) -> Callable[[torch.Tensor], torch.Tensor]:
    """A function of (N, H, W, 3) uint8 images: to float32 on ``model``'s
    device, resized to ``size`` (only when the shape differs), ``(x / 255 -
    mean) / std``, the ResNet without autograd, and the features as (N, C,
    h, w) float32."""
    device = next(model.parameters()).device
    mean = torch.as_tensor(IMAGENET_MEAN, device=device)
    std = torch.as_tensor(IMAGENET_STD, device=device)

    def extract(images_u8: torch.Tensor) -> torch.Tensor:
        x = images_u8.to(device).float()
        if tuple(x.shape[1:3]) != tuple(size):
            x = cubic_resize(x, size)
        x = ((x / 255.0 - mean) / std).permute(0, 3, 1, 2).contiguous()
        with torch.no_grad(), _convolutions_in_float32():
            return model(x).float()

    return extract


def _decode(path: str) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    return np.asarray(img, np.uint8)


def _decode_resize_pil(path: str, size: Tuple[int, int]) -> np.ndarray:
    """PIL decode to RGB and BICUBIC resize to ``size`` (H, W) on uint8,
    re-quantized to uint8 by PIL: (H, W, 3) uint8."""
    from PIL import Image

    img = Image.open(path)
    if img.mode != "RGB":
        img = img.convert("RGB")
    img = img.resize((size[1], size[0]), Image.BICUBIC)  # PIL takes (W, H)
    return np.asarray(img, np.uint8)


def extract_to_sink(items: Sequence, decode: Callable[[object], np.ndarray],
                    extract: Callable[[torch.Tensor], torch.Tensor],
                    sink: Callable[[np.ndarray], None], device: torch.device,
                    batch_size: int = 128, decode_workers: int = 8) -> None:
    """The batch loop: ``decode`` each item in a thread pool, ``extract``
    each batch of ``batch_size`` on ``device``, and ``sink`` the (B, C, h, w)
    float32 features in order.  On a card, the uint8 batch goes up from
    pinned memory and the features come down into pinned memory on a side
    stream, so the host decodes batch i+1 and sinks batch i-1 while batch i
    runs."""
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    pending = None  # (host features, the event that ends their copy, or None)

    def flush(entry) -> None:
        host, done = entry
        if done is not None:
            done.synchronize()
        sink(host.numpy())

    with ThreadPoolExecutor(decode_workers) as pool:
        for start in range(0, len(items), batch_size):
            batch = torch.from_numpy(np.stack(list(pool.map(decode,
                                                            items[start:start + batch_size]))))
            if cuda:
                batch = batch.pin_memory().to(device, non_blocking=True)
            feats = extract(batch)
            if cuda:
                host = torch.empty(feats.shape, dtype=feats.dtype, pin_memory=True)
                copy_stream.wait_stream(torch.cuda.current_stream(device))
                with torch.cuda.stream(copy_stream):
                    host.copy_(feats, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(copy_stream)
                feats.record_stream(copy_stream)
                entry = (host, done)
            else:
                entry = (feats, None)
            if pending is not None:
                flush(pending)
            pending = entry
        if pending is not None:
            flush(pending)


def extract_features(
    image_paths: Sequence[str],
    output_h5: str,
    model: Optional[ResNetFeatures] = None,
    batch_size: int = 128,
    decode_workers: int = 8,
    size: Tuple[int, int] = (224, 224),
    resize: str = "device",
    device: Union[str, torch.device] = "cuda",
) -> None:
    """Stream the features of ``image_paths`` into ``output_h5``.

    ``model`` defaults to a ResNet-101 stage 3 with seeded random weights on
    ``device``; a given model must live there.  ``resize``: "device" (the
    antialiased cubic of :func:`cubic_resize`, on the device) or "pil" (host
    PIL BICUBIC with uint8 re-quantization, which bit-matches the reference
    preprocessing; the device then sees ``size`` and resizes nothing)."""
    from explainable_spatial_vqa_tpu_torch.core.artifacts import FeatureWriter
    from explainable_spatial_vqa_tpu_torch.models.layers import init_parameters

    device = resolve_device(device)
    if model is None:
        model = init_parameters(ResNetFeatures(device=device), seed=0)
    model_device = next(model.parameters()).device
    if model_device.type != device.type:
        raise ValueError(f"the model lives on {model_device}, not on {device}")
    if resize == "pil":
        decode = functools.partial(_decode_resize_pil, size=size)
    elif resize == "device":
        decode = _decode
    else:
        raise ValueError(f"unknown resize mode {resize!r} (device|pil)")
    extract = make_extract_fn(model, size)
    with FeatureWriter(output_h5, total=len(image_paths)) as writer:
        extract_to_sink(image_paths, decode, extract, writer.append, model_device,
                        batch_size=batch_size, decode_workers=decode_workers)
