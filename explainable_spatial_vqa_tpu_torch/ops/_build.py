"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each library is one shared object with a plain C interface,
``_build/<name>-<hash>.so`` inside the package (the directory is gitignored),
built from its translation units (:func:`units`): ``csrc/<name>.cu`` alone;
for K1's ``fused_attention``, its C entries plus one unit per group of
head dims (:data:`K1_DIM_GROUPS`) and one per group of padded depths
(:data:`K1_PAD_GROUPS`); for K2's and K3's ``fused_block``, its GEMMs,
blocks and C entries plus one unit per head dim of their attention
(:data:`BLOCK_ATTENTION_DIMS`); each compiled by its own ``nvcc`` process
and linked into the one library.  The hash covers every unit's source and
flags, the headers in ``csrc/`` and the compiler flags, so an edited source
builds anew and an unchanged one loads at once.  Every unit of every library
being built compiles at once, in parallel.  Nothing is compiled when a
module is imported: the first launch of a kernel builds its library.  A C
entry gets its argument types once per loaded library (:func:`entry`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, Sequence, Tuple

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "K1_DIM_GROUPS", "K1_PAD_GROUPS",
           "BLOCK_ATTENTION_DIMS", "units",
           "build", "compile_libraries", "load", "bind_entry", "entry", "launch_counters", "check"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# a unit of a library of several is compiled to an object, then linked
_COMPILE_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)

CUDA_HOMES = ("/usr/local/cuda",)  # searched after $CUDA_HOME, before PATH

# K1's head dims with kernels of their own (every multiple of 8 up to 128,
# ``ops.fused_attention.EXACT_HEAD_DIMS``), two to a unit of
# ``fused_attention.cu`` compiled with -DESV_HEAD_DIM_A and -DESV_HEAD_DIM_B
# (nvcc reads a comma in an option as a list): a small and a large dim
# together, so that the units take about the same time; one nvcc process
# for all sixteen would compile their kernels one after another
K1_DIM_GROUPS = ((8, 128), (16, 120), (24, 112), (32, 104), (40, 96), (48, 88), (56, 80),
                 (64, 72))
# the padded kernels' depths (``ops.fused_attention.PADDED_DEPTHS``), which
# take every other head dim up to ``MAX_HEAD_DIM``, two to a unit compiled
# with -DESV_PAD_DEPTH_A and -DESV_PAD_DEPTH_B, a small and a large one
# together; past 256 the deep kernels, two or one to a unit (each depth's
# unit holds its padded or deep kernels, past 128 its short and wgmma ones)
K1_PAD_GROUPS = ((16, 256), (32, 224), (48, 192), (64, 160), (80, 128), (96, 112), (288, 512),
                 (336, 448), (384,))
# K2's and K3's attention at their head dims (``ops.fused_block.BLOCK_HEAD_DIMS``),
# one unit of ``fused_block.cu`` each, compiled with -DESV_BLOCK_HEAD_DIM: in
# one unit with the GEMMs they were the build's longest process
BLOCK_ATTENTION_DIMS = (128, 256, 384, 512)

_LIBS: Dict[str, ctypes.CDLL] = {}


def units(name: str) -> Tuple[Tuple[str, Tuple[str, ...]], ...]:
    """Library ``name``'s translation units: (source file in ``csrc/``, extra
    nvcc flags) each."""
    if name == "fused_attention":
        return (("fused_attention.cu", ()),) + tuple(
            ("fused_attention.cu", tuple(f"-DESV_{what}_{ab}={d}" for ab, d in zip("AB", group)))
            for what, groups in (("HEAD_DIM", K1_DIM_GROUPS), ("PAD_DEPTH", K1_PAD_GROUPS))
            for group in groups)
    if name == "fused_block":
        return (("fused_block.cu", ()),) + tuple(
            ("fused_block.cu", (f"-DESV_BLOCK_HEAD_DIM={d}",)) for d in BLOCK_ATTENTION_DIMS)
    return ((f"{name}.cu", ()),)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), *CUDA_HOMES):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH); it is needed to build the CUDA kernels in " + str(CSRC_DIR))
    return found


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update(" ".join(NVCC_FLAGS).encode())
    for source, flags in units(name):
        digest.update(" ".join((source, *flags)).encode())
    sources = sorted({source for source, _ in units(name)})
    for path in [CSRC_DIR / s for s in sources] + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def compile_libraries(jobs: Dict[str, Tuple[str, Path, Path]],
                      include: Sequence[Path] = ()) -> Dict[str, str]:
    """Compile each job {key: (library name, output path, source directory)}
    from the units of that library (:func:`units`), read from the source
    directory with ``include`` on the header path: every unit at once, then
    each library of several units linked.  Returns {key: the compiler's output}, each unit's under a
    heading with its wall time (ptxas's register and shared-memory report).
    Raises with the output of every failed job."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags_in = [f"-I{d}" for d in include]
    procs, logs, failed = {}, {}, []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        for key, (name, out, src_dir) in jobs.items():
            parts = units(name)
            for i, (source, flags) in enumerate(parts):
                if len(parts) == 1:
                    cmd = [nvcc, *NVCC_FLAGS, *flags_in, *flags, "-o", str(out),
                           str(src_dir / source)]
                else:
                    cmd = [nvcc, *_COMPILE_FLAGS, *flags_in, *flags, "-o",
                           str(Path(tmp) / f"{key}.{i}.o"), str(src_dir / source)]
                log = Path(tmp) / f"{key}.{i}.log"
                with open(log, "w") as sink:
                    proc = subprocess.Popen(cmd, stdout=sink, stderr=subprocess.STDOUT)
                procs[key, i] = (proc, time.perf_counter(), " ".join((source, *flags)), log)
        ended = {}
        while len(ended) < len(procs):  # each unit's wall time, from its start to its end
            for unit, (proc, t0, _, _) in procs.items():
                if unit not in ended and proc.poll() is not None:
                    ended[unit] = time.perf_counter() - t0
            time.sleep(0.05)
        status = {}
        for (key, i), (proc, _, what, log) in procs.items():
            logs[key] = logs.get(key, "") + (f"--- {what}: exit {proc.returncode}, "
                                             f"{ended[key, i]:.1f} s ---\n{log.read_text()}")
            status[key] = status.get(key, 0) or proc.returncode
        for key, (name, out, _) in jobs.items():
            parts = units(name)
            if status[key] == 0 and len(parts) > 1:
                objs = [str(Path(tmp) / f"{key}.{i}.o") for i in range(len(parts))]
                link = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(out), *objs],
                                      capture_output=True, text=True)
                logs[key] += f"--- link: exit {link.returncode} ---\n{link.stdout}{link.stderr}"
                status[key] = link.returncode
            if status[key] != 0:
                failed.append(f"--- {name} ({key}, exit {status[key]}) ---\n{logs[key]}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named library that has no up-to-date build, all at once.

    Returns {name: library path}.  Raises with the compiler's output if any
    build fails.  Each build writes ``_build/<name>.log`` with ptxas's
    register and shared-memory report for each of its units.
    """
    paths = {name: _library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    _nvcc()  # raises before anything is written
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        jobs[name] = (name, Path(tmp), CSRC_DIR)
    try:
        logs = compile_libraries(jobs)
    except RuntimeError:
        for _, tmp, _ in jobs.values():
            tmp.unlink(missing_ok=True)
        raise
    for name, (_, tmp, _) in jobs.items():
        (BUILD_DIR / f"{name}.log").write_text(logs[name])
        os.replace(tmp, todo[name])
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def bind_entry(lib: ctypes.CDLL, name: str, argtypes: Sequence[Any], restype: Any = ctypes.c_int):
    """``lib``'s C entry ``name`` with its argument and result types set."""
    fn = getattr(lib, name)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


_ENTRIES: Dict[Tuple[int, str], Any] = {}


def entry(library: str, name: str, argtypes: Sequence[Any], restype: Any = ctypes.c_int):
    """The C entry ``name`` of the loaded library ``library`` (:func:`load`),
    bound by :func:`bind_entry` once for each library loaded under that name
    (``measure/gemm_variants.py`` swaps other builds into ``_LIBS``)."""
    lib = load(library)
    key = (id(lib), name)
    found = _ENTRIES.get(key)
    if found is None or found[0] is not lib:
        found = _ENTRIES[key] = (lib, bind_entry(lib, name, argtypes, restype))
    return found[1]


def launch_counters(library: str, name_entry: str, count_entry: str):
    """A library's kernel functions and launch counts: (the names its
    ``const char* name_entry(int i)`` gives, up to the first null, its
    ``long long count_entry(int i)``)."""
    lib = load(library)
    name = bind_entry(lib, name_entry, (ctypes.c_int,), ctypes.c_char_p)
    count = bind_entry(lib, count_entry, (ctypes.c_int,), ctypes.c_longlong)
    names = []
    while name(len(names)) is not None:
        names.append(name(len(names)).decode())
    return names, count


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code other than 0."""
    if status != 0:
        raise RuntimeError(f"{what} failed with CUDA error {status}")
