"""The core shared by the kernel variant drivers (``attention_variants``,
``gemm_variants``): a variant is the shipped ``csrc/`` tree with textual
replacements, each (file, old text, new text) matching exactly once; it is
written whole into a directory of its own, so that every header the units
include is the variant's, and compiled there by ``_build.compile_libraries``
with the package's flags, every unit of every variant at once.  ``mean_ms``
times a call by CUDA events, ``device_ms`` by the kernels' own time on the
card (torch.profiler).
"""

from __future__ import annotations

import re
import shutil
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

from explainable_spatial_vqa_tpu_torch.ops import _build

__all__ = ["Edit", "variant_sources", "variant_tree", "build_variants", "ptxas_usage",
           "mean_ms", "device_ms"]

Edit = Tuple[str, str, str]  # (file in csrc/, old text, new text)


def variant_sources(variants: Mapping[str, Sequence[Edit]], name: str,
                    csrc: Path = _build.CSRC_DIR) -> Dict[str, str]:
    """{file: patched text} for each file variant ``name`` edits; raises
    ValueError where an old text does not occur exactly once."""
    out: Dict[str, str] = {}
    for file, old, new in variants[name]:
        text = out.get(file)
        if text is None:
            text = (csrc / file).read_text()
        if text.count(old) != 1:
            raise ValueError(f"variant {name}: {old[:60]!r} occurs {text.count(old)} times in "
                             f"{file}, not once")
        out[file] = text.replace(old, new)
    return out


def variant_tree(variants: Mapping[str, Sequence[Edit]], name: str, out_dir: Path) -> Path:
    """``csrc/`` copied into ``out_dir/name`` with variant ``name``'s edits."""
    tree = out_dir / name
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, tree)
    for file, text in variant_sources(variants, name).items():
        (tree / file).write_text(text)
    return tree


def build_variants(library: str, variants: Mapping[str, Sequence[Edit]], names: Sequence[str],
                   out_dir: Path, also: Optional[Mapping[str, Tuple[str, Path, Path]]] = None
                   ) -> Dict[str, Tuple[Path, str]]:
    """Compile ``library`` (its units, ``_build.units``) from each named
    variant's tree into ``out_dir/<name>.so``, and the jobs of ``also``
    (``_build.compile_libraries``'s), all at once; {name: (path, the
    compiler's output)}.  Raises with the compiler's output on a failure."""
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {name: (library, out_dir / f"{name}.so", variant_tree(variants, name, out_dir))
            for name in names}
    jobs.update(also or {})
    logs = _build.compile_libraries(jobs)
    return {name: (path, logs[name]) for name, (_, path, _) in jobs.items()}


def ptxas_usage(log: str) -> Dict[str, Tuple[int, int]]:
    """{kernel function (mangled): (registers, bytes spilled)} from ptxas's
    report in a build's output (``-Xptxas=-v``)."""
    out: Dict[str, Tuple[int, int]] = {}
    current = None
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            current = found.group(1)
            out[current] = (0, 0)
        elif current is not None and "spill stores" in line:
            out[current] = (out[current][0],
                            int(line.split("bytes spill stores")[0].split(",")[-1]))
        elif current is not None and "Used" in line and "registers" in line:
            out[current] = (int(line.split("Used")[1].split("registers")[0]), out[current][1])
    return out


def mean_ms(fn, iters: int) -> float:
    """``fn``'s mean time over ``iters`` calls after 3 warm-up calls, by
    CUDA events around the calls."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, match: str = "") -> Optional[float]:
    """``fn``'s device time a call, under torch.profiler (CPU and CUDA
    activity) over ``iters`` calls after 3 warm-up calls: with ``match``, the
    mean time of the kernels whose names hold it (one a call), else every
    kernel's time summed over the calls; None where the profiler saw none.
    (A profile can miss some of a run's kernels; the mean of those it saw
    stands.)  Where a call costs the host more than the card (a kernel of
    microseconds behind a ctypes call), ``mean_ms`` times the host and this
    the kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA and match in e.name]
    if not spans:
        return None
    return sum(spans) / 1e3 / (len(spans) if match else iters)
