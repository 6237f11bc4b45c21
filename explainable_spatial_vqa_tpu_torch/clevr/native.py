"""ctypes binding of the native symbolic CLEVR engine, copied from
``explainable_spatial_vqa_tpu/clevr/native.py``.

Packs scene graphs and CLEVR programs into flat int32 arrays, executes them
in ``csrc/clevr_exec.cpp`` (the port's copy of the JAX package's
``native/clevr_exec.cpp``) and decodes the outputs into the Python
executor's value domain.  The engine is a host library, not a kernel: the
first call builds it with ``g++`` into ``_build/clevr_exec-<hash>.so``
inside the package (gitignored; the hash covers the source and the flags,
so an edited source builds anew).  The flags are ``native/Makefile``'s
without ``-march=native``, so a library that travels with a copy of the
checkout runs on any x86-64 host.  :func:`native_available` says whether the
library is built and loaded; a failed build is logged with the compiler's
output, and :func:`execute_native` then runs the Python executor, as the
JAX package does without its library.

``execute_native.programs`` counts the programs the library ran since it
was last set to 0 (the Python executor's runs are not counted).  Set
``execute_native.parts`` to ``[0.0, 0.0, 0.0]`` and each program the library
runs adds its packing, C call and decoding seconds to it; ``None`` (the
default) times nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
import time
from functools import lru_cache
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from explainable_spatial_vqa_tpu_torch.clevr.executor import INVALID, execute_program
from explainable_spatial_vqa_tpu_torch.clevr.scenes import Scene

logger = logging.getLogger(__name__)

__all__ = ["native_available", "PackedScene", "pack_program", "execute_native",
           "execute_batch_native", "build_library"]

# Function enum: must match csrc/clevr_exec.cpp.
FN_SCENE, FN_FILTER, FN_UNIQUE, FN_RELATE, FN_UNION, FN_INTERSECT = 0, 1, 2, 3, 4, 5
FN_COUNT, FN_EXIST, FN_QUERY, FN_EQUAL_ATTR, FN_EQUAL_INT = 6, 7, 8, 9, 10
FN_LESS, FN_GREATER, FN_SAME, FN_EQUAL_OBJECT = 11, 12, 13, 14

K_SET, K_OBJ, K_INT, K_BOOL, K_ATTR, K_INVALID, K_POISONED = range(7)

ATTRS = ("color", "shape", "size", "material")
RELATIONS = ("left", "right", "front", "behind")

ATTR_VALUES: Dict[str, Tuple[str, ...]] = {
    "color": ("gray", "red", "blue", "green", "brown", "purple", "cyan", "yellow"),
    "shape": ("cube", "sphere", "cylinder"),
    "size": ("large", "small"),
    "material": ("rubber", "metal"),
}

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "clevr_exec.cpp"
BUILD_DIR = _PKG_DIR / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def build_library() -> Path:
    """Compile ``csrc/clevr_exec.cpp`` unless an up-to-date library exists;
    return its path.  Raises with the compiler's output if the build fails."""
    cxx = os.environ.get("CXX", "g++")
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    path = BUILD_DIR / f"clevr_exec-{digest.hexdigest()[:16]}.so"
    if path.exists():
        return path
    compiler = shutil.which(cxx)
    if compiler is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found; it builds {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([compiler, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cxx} failed (exit {proc.returncode}) on {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


@lru_cache(maxsize=1)
def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (RuntimeError, OSError) as err:
        logger.error("native CLEVR engine unavailable, the Python executor runs instead: %s",
                     err)
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.clevr_execute.restype = ctypes.c_int
    lib.clevr_execute.argtypes = [ctypes.c_int32, i32p, i32p, i32p,
                                  ctypes.c_int32, i32p, i32p]
    lib.clevr_execute_batch.restype = ctypes.c_int
    lib.clevr_execute_batch.argtypes = [ctypes.c_int32, i32p, i32p, i32p,
                                        ctypes.c_int32, i32p, i32p, i32p]
    return lib


def native_available() -> bool:
    """The library is built (at the first call) and loaded."""
    return _load() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


class PackedScene:
    """Scene graph packed to the native data contract."""

    def __init__(self, scene: Scene):
        objects = scene.objects
        self.n_obj = len(objects)
        attrs = np.zeros((self.n_obj, 4), np.int32)
        for i, obj in enumerate(objects):
            for a, name in enumerate(ATTRS):
                attrs[i, a] = ATTR_VALUES[name].index(obj[name])
        self.attrs = np.ascontiguousarray(attrs)

        offsets = np.zeros((4, self.n_obj + 1), np.int32)
        values: List[int] = []
        for r, rel in enumerate(RELATIONS):
            index = scene.relationships.get(rel, {})
            for i in range(self.n_obj):
                offsets[r, i] = len(values)
                values.extend(index.get(i, []))
            offsets[r, self.n_obj] = len(values)
        self.rel_offsets = np.ascontiguousarray(offsets)
        self.rel_values = np.ascontiguousarray(np.asarray(values, np.int32))


def pack_program(program: Sequence[Dict[str, Any]]) -> np.ndarray:
    """Program node list -> (S, 5) int32 [fn, dep0, dep1, side_attr, side_value]."""
    steps = np.full((len(program), 5), -1, np.int32)
    for s, node in enumerate(program):
        fn = node.get("type") or node.get("function")
        inputs = node.get("inputs", [])
        side = node.get("side_inputs") or node.get("value_inputs") or []
        steps[s, 1] = inputs[0] if len(inputs) > 0 else -1
        steps[s, 2] = inputs[1] if len(inputs) > 1 else -1
        if fn == "scene":
            steps[s, 0] = FN_SCENE
        elif fn.startswith("filter_"):
            attr = fn[len("filter_"):]
            steps[s, 0] = FN_FILTER
            steps[s, 3] = ATTRS.index(attr)
            steps[s, 4] = ATTR_VALUES[attr].index(side[0])
        elif fn == "unique":
            steps[s, 0] = FN_UNIQUE
        elif fn == "relate":
            steps[s, 0] = FN_RELATE
            steps[s, 3] = 4
            steps[s, 4] = RELATIONS.index(side[0])
        elif fn == "union":
            steps[s, 0] = FN_UNION
        elif fn == "intersect":
            steps[s, 0] = FN_INTERSECT
        elif fn == "count":
            steps[s, 0] = FN_COUNT
        elif fn == "exist":
            steps[s, 0] = FN_EXIST
        elif fn.startswith("query_"):
            steps[s, 0] = FN_QUERY
            steps[s, 3] = ATTRS.index(fn[len("query_"):])
        elif fn == "equal_integer":
            steps[s, 0] = FN_EQUAL_INT
        elif fn == "equal_object":
            steps[s, 0] = FN_EQUAL_OBJECT
        elif fn.startswith("equal_"):
            steps[s, 0] = FN_EQUAL_ATTR
        elif fn == "less_than":
            steps[s, 0] = FN_LESS
        elif fn == "greater_than":
            steps[s, 0] = FN_GREATER
        elif fn.startswith("same_"):
            steps[s, 0] = FN_SAME
            steps[s, 3] = ATTRS.index(fn[len("same_"):])
        else:
            raise ValueError(f"Unknown function type: {fn}")
    return steps


def _decode(out: np.ndarray, program: Sequence[Dict[str, Any]], n_obj: int) -> List[Any]:
    """Native outputs -> Python executor value domain (short-circuited list)."""
    values: List[Any] = []
    for s in range(out.shape[0]):
        kind, value, mask = int(out[s, 0]), int(out[s, 1]), int(out[s, 2])
        if kind == K_POISONED:
            break
        if kind == K_SET:
            values.append([i for i in range(n_obj) if (mask >> i) & 1])
        elif kind == K_OBJ:
            values.append(value)
        elif kind == K_INT:
            values.append(value)
        elif kind == K_BOOL:
            values.append(bool(value))
        elif kind == K_ATTR:
            fn = program[s].get("type") or program[s].get("function")
            attr = fn[len("query_"):]
            values.append(ATTR_VALUES[attr][value - ATTRS.index(attr) * 8])
        elif kind == K_INVALID:
            values.append(INVALID)
            break
    return values


def execute_native(scene: Scene, program: Sequence[Dict[str, Any]],
                   packed: Optional[PackedScene] = None) -> List[Any]:
    """Drop-in for ``executor.execute_program`` through the native engine; a
    program with a function or value the engine does not pack (such as
    ``filter_objectcategory``) runs on the Python executor."""
    lib = _load()
    if lib is None:
        return execute_program(scene, program)
    parts = execute_native.parts
    if parts is not None:
        t0 = time.perf_counter()
    if packed is None:
        packed = PackedScene(scene)
    try:
        steps = pack_program(program)
    except (ValueError, IndexError):
        return execute_program(scene, program)
    out = np.zeros((len(program), 3), np.int32)
    if parts is not None:
        t1 = time.perf_counter()
    rc = lib.clevr_execute(
        packed.n_obj, _ptr(packed.attrs), _ptr(packed.rel_offsets),
        _ptr(packed.rel_values), steps.shape[0], _ptr(steps), _ptr(out),
    )
    if rc != 0:
        raise RuntimeError("native execution failed")
    execute_native.programs += 1
    if parts is None:
        return _decode(out, program, packed.n_obj)
    t2 = time.perf_counter()
    values = _decode(out, program, packed.n_obj)
    for i, dt in enumerate((t1 - t0, t2 - t1, time.perf_counter() - t2)):
        parts[i] += dt
    return values


execute_native.programs = 0
execute_native.parts = None


def execute_batch_native(packed: PackedScene, programs: Sequence[np.ndarray]) -> np.ndarray:
    """Execute many packed programs against one scene in a single call.

    Returns raw (total_steps, 3) outputs; offsets follow program lengths.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    offsets = np.zeros(len(programs) + 1, np.int32)
    for i, p in enumerate(programs):
        offsets[i + 1] = offsets[i] + p.shape[0]
    steps = np.ascontiguousarray(np.concatenate(programs, axis=0))
    out = np.zeros((offsets[-1], 3), np.int32)
    rc = lib.clevr_execute_batch(
        packed.n_obj, _ptr(packed.attrs), _ptr(packed.rel_offsets),
        _ptr(packed.rel_values), len(programs), _ptr(offsets), _ptr(steps), _ptr(out),
    )
    if rc != 0:
        raise RuntimeError("native batch execution failed")
    execute_native.programs += len(programs)
    return out
