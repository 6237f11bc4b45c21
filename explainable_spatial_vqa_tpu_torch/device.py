"""Device resolution for the port's entry points, and the card's peak rates.

Entry points default to the card.  A caller that wants the CPU says so with
``device="cpu"``; nothing falls back to the CPU on its own.

:data:`PEAK_OPS` and :data:`PEAK_BYTES` are the H100 SXM's data-sheet rates,
the one card in :data:`CARD_PEAKS`.  The measurement drivers read the card
under test through :func:`chip_peak_flops` and :func:`hbm_bytes_per_s`, which
raise for a card the table does not know unless ``BENCH_PEAK_TFLOPS`` (and,
for the bandwidth, ``PROF_HBM_GBS``) names its rate.
"""

from __future__ import annotations

import math
import os
import subprocess
from typing import Union

import torch

__all__ = ["resolve_device", "PEAK_OPS", "PEAK_BYTES", "CARD_PEAKS", "card_peaks",
           "chip_peak_flops", "hbm_bytes_per_s", "card_line"]

# NVIDIA H100 SXM data sheet, dense: tensor-core bf16 and TF32, HBM3.  A
# float32 dot product's least time is its 3xTF32 form's (three TF32 products
# for each, at 495 TFLOP/s, keep float32's accuracy, as the attention kernels
# show), not the CUDA cores' 67 TFLOP/s.
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12,
            "fp32": 67e12,  # float32 on the CUDA cores (the extractor's strict convolutions)
            "fp64": 34e12}  # float64 on the CUDA cores (K3's exact q/k/v fix-up)
PEAK_BYTES = 3.35e12  # HBM3, bytes/s

# torch.cuda.get_device_name -> (operations/s by type, HBM bytes/s)
CARD_PEAKS = {"NVIDIA H100 80GB HBM3": (PEAK_OPS, PEAK_BYTES)}


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def card_peaks(device: Union[str, torch.device] = "cuda"):
    """(operations/s by type, HBM bytes/s) of the card behind ``device``;
    raises ValueError for a card :data:`CARD_PEAKS` does not hold."""
    name = torch.cuda.get_device_name(torch.device(device))
    if name not in CARD_PEAKS:
        raise ValueError(f"no peak rates for {name!r}: set BENCH_PEAK_TFLOPS (dense bf16) and "
                         f"PROF_HBM_GBS, or add the card to device.CARD_PEAKS")
    return CARD_PEAKS[name]


def chip_peak_flops(device: Union[str, torch.device] = "cuda") -> float:
    """Dense bf16 operations/s of the card behind ``device``: ``BENCH_PEAK_TFLOPS``
    (TFLOP/s) where it is set, else the table's rate.  NaN on the CPU, which
    has no device peak: a CPU run states no utilisation."""
    if os.environ.get("BENCH_PEAK_TFLOPS"):
        return float(os.environ["BENCH_PEAK_TFLOPS"]) * 1e12
    if torch.device(device).type != "cuda":
        return math.nan
    return card_peaks(device)[0]["bf16"]


def hbm_bytes_per_s(device: Union[str, torch.device] = "cuda") -> float:
    """The memory rate of the card behind ``device``: ``PROF_HBM_GBS`` (GB/s)
    where it is set, else the table's rate; NaN on the CPU."""
    if os.environ.get("PROF_HBM_GBS"):
        return float(os.environ["PROF_HBM_GBS"]) * 1e9
    if torch.device(device).type != "cuda":
        return math.nan
    return card_peaks(device)[1]


def card_line(device: Union[str, torch.device] = "cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (its first card), or what stands in
    for them on the CPU."""
    if torch.device(device).type != "cuda":
        return "device: cpu (no card)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]
