"""ResNet-101 truncated after stage 3 (torchvision ``layer3``), ported from
``explainable_spatial_vqa_tpu/vision/resnet.py``: the frozen feature
extractor whose (N, 1024, 14, 14) float32 maps of 224x224 images every
executor reads.

The architecture is torchvision's (bottleneck v1.5: the stride on the 3x3
convolution, a downsample at each stage's block 0, batch norm after every
convolution), in NCHW.  Batch norm is the frozen affine transform of the
JAX package (:class:`FrozenBatchNorm`).  Parameter and buffer names are
torchvision's, so a torchvision ``resnet101`` state dict loads through
:func:`load_torchvision_state_dict`.  As in the JAX package, parameters are
float32 and the module computes in its ``dtype``.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from explainable_spatial_vqa_tpu_torch.device import resolve_device
from explainable_spatial_vqa_tpu_torch.models.layers import cached_on_params

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "RESNET101_STAGES", "Bottleneck",
           "FrozenBatchNorm", "ResNetFeatures", "load_torchvision_state_dict"]

Device = Union[str, torch.device]

# The reference's normalization constants.  Its std's BLUE channel is 0.224
# (not the canonical 0.225), kept verbatim for feature parity.
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.224], np.float32)

# Bottleneck counts of ResNet-101's stages 1..3 (torchvision's layers 1..3).
RESNET101_STAGES = (3, 4, 23)


class FrozenBatchNorm(nn.Module):
    """Inference-only batch norm: ``inv = weight / sqrt(running_var + eps)``
    in float32, rounded to ``dtype``, then ``x * inv + (bias - running_mean *
    inv)``, as the JAX package computes it.  The folded pair is kept until a
    buffer changes."""

    def __init__(self, features: int, dtype: torch.dtype, device: torch.device,
                 eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.compute_dtype = dtype
        for name, fill in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0),
                           ("running_var", 1.0)):
            self.register_buffer(name, torch.full((features,), fill, device=device))

    def _fold(self):
        key = tuple((b.data_ptr(), b._version) for b in self.buffers())
        kept = self.__dict__.get("_folded")
        if kept is None or kept[0] != key:
            inv = (self.weight / torch.sqrt(self.running_var + self.eps)).to(self.compute_dtype)
            shift = (self.bias - self.running_mean * inv.float()).to(self.compute_dtype)
            kept = (key, (inv[:, None, None], shift[:, None, None]))
            self.__dict__["_folded"] = kept
        return kept[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv, shift = self._fold()
        return x * inv + shift


class _Conv(nn.Conv2d):
    """A square convolution without bias, float32 weights computing in
    ``dtype`` (without autograd the cast is kept between calls), SAME-style
    padding k // 2."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__(cin, cout, k, stride=stride, padding=k // 2, bias=False,
                         device=device, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def cast():
            return self.weight.to(self.compute_dtype)

        weight = cast() if torch.is_grad_enabled() else cached_on_params(self, cast)
        return self._conv_forward(x.to(self.compute_dtype), weight, None)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 with batch norm after each, and with
    ``downsample`` a strided 1x1 projection of the identity."""

    def __init__(self, cin: int, mid: int, cout: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.conv1 = _Conv(cin, mid, 1, 1, dtype, device)
        self.bn1 = FrozenBatchNorm(mid, dtype, device)
        self.conv2 = _Conv(mid, mid, 3, stride, dtype, device)
        self.bn2 = FrozenBatchNorm(mid, dtype, device)
        self.conv3 = _Conv(mid, cout, 1, 1, dtype, device)
        self.bn3 = FrozenBatchNorm(cout, dtype, device)
        self.downsample = (nn.Sequential(_Conv(cin, cout, 1, stride, dtype, device),
                                         FrozenBatchNorm(cout, dtype, device))
                           if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        h = torch.relu(self.bn1(self.conv1(x)))
        h = torch.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return torch.relu(h + identity)


class ResNetFeatures(nn.Module):
    """The stem (7x7 stride-2 convolution, batch norm, ReLU, 3x3 stride-2
    max-pool) and stages 1..``num_stages``: normalized (N, 3, H, W) images to
    (N, 1024, H/16, W/16) maps for the default 3-stage truncation, in
    ``dtype``."""

    def __init__(self, num_stages: int = 3, stage_sizes: Sequence[int] = RESNET101_STAGES,
                 dtype: torch.dtype = torch.float32, device: Device = "cuda"):
        super().__init__()
        device = resolve_device(device)
        self.num_stages = num_stages
        self.dtype = dtype
        self.conv1 = _Conv(3, 64, 7, 2, dtype, device)
        self.bn1 = FrozenBatchNorm(64, dtype, device)
        cin, channels = 64, 256
        for stage in range(num_stages):
            stride = 1 if stage == 0 else 2
            blocks = [Bottleneck(cin if b == 0 else channels, channels // 4, channels,
                                 stride if b == 0 else 1, b == 0, dtype, device)
                      for b in range(stage_sizes[stage])]
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            cin, channels = channels, channels * 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.bn1(self.conv1(x)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)
        for stage in range(self.num_stages):
            h = getattr(self, f"layer{stage + 1}")(h)
        return h


def _ignored(key: str, num_stages: int) -> bool:
    """A torchvision key the truncated net does not hold: a later stage's,
    the classifier's, or a batch-norm step counter."""
    head = key.split(".", 1)[0]
    later = head.startswith("layer") and head[5:].isdigit() and int(head[5:]) > num_stages
    return later or head == "fc" or key.endswith("num_batches_tracked")


def load_torchvision_state_dict(module: ResNetFeatures, state_dict: Mapping[str, Any]) -> None:
    """Load a torchvision ``resnet101`` state dict (tensors or numpy arrays)
    into ``module``.  The keys of stages past ``module.num_stages``,
    ``fc.*`` and every ``num_batches_tracked`` are ignored; a key of the
    truncated net that is missing, any other key, or a shape that differs
    raises, so no weight is left random."""
    kept = {k: torch.as_tensor(v) for k, v in state_dict.items()
            if not _ignored(k, module.num_stages)}
    missing = sorted(set(module.state_dict()) - set(kept))
    if missing:
        raise KeyError(f"state dict lacks {len(missing)} keys of the truncated net, e.g. "
                       f"{missing[:5]}")
    module.load_state_dict(kept, strict=True)
