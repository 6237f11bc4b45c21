"""PyTorch/CUDA port of :mod:`explainable_spatial_vqa_tpu`.

The layout mirrors the JAX package module for module, so each part of the
port sits at the same relative path as the code it was ported from.  The
port imports ``torch``, numpy and the standard library only; it keeps its
own copies of the framework-free pieces it needs (configs, program parsing,
special tokens, the faithfulness tally).

Every public entry point takes ``device="cuda"`` by default and raises when
CUDA is missing, unless the caller passes ``device="cpu"``
(:func:`explainable_spatial_vqa_tpu_torch.device.resolve_device`).  On a CUDA
device the executor's fusion encoder runs on the hand-written kernels in
``csrc/``; on the CPU the same wrappers run their plain PyTorch versions.
"""

from explainable_spatial_vqa_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
