"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
``_build/<name>-<hash>.so`` inside the package (the directory is gitignored).
The hash covers the source, the headers in ``csrc/`` and the compiler flags,
so an edited source builds anew and an unchanged one loads at once.  Builds
of several sources run as parallel ``nvcc`` processes.  Nothing is compiled
when a module is imported: the first launch of a kernel builds its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "load", "check"]

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

CUDA_HOMES = ("/usr/local/cuda",)  # searched after $CUDA_HOME, before PATH

_LIBS: Dict[str, ctypes.CDLL] = {}


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
    for path in [CSRC_DIR / f"{name}.cu"] + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Sequence[str]) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, all at once.

    Returns {name: library path}.  Raises with the compiler's output if any
    build fails.  Each build writes ``_build/<name>.log`` with ptxas's
    register and shared-memory report.
    """
    paths = {name: _library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        output, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(output)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"--- {name}.cu (exit {proc.returncode}) ---\n{output}")
        else:
            os.replace(tmp, todo[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code other than 0."""
    if status != 0:
        raise RuntimeError(f"{what} failed with CUDA error {status}")
