"""Monotonic alignment search: a host C++ core bound with ``ctypes``, and
its numpy twin.

Counterpart of ``slam_llm_tpu/ops/monotonic_align.py`` (the reference's
Cython ``monotonic_align/core.pyx`` from Matcha-TTS, for TTS duration
modeling). The port compiles its own copy of the C++ source
(``native/monotonic_align.cpp``) with ``g++`` at first use into
``build/slam_llm_tpu_torch/`` at the root of the checkout, named by a hash
of the source, so an unchanged source loads the existing library. A failed
build raises: ``maximum_path`` runs the numpy twin only when the caller
asks for it (``native=False``), never in place of the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "monotonic_align.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "slam_llm_tpu_torch"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build() -> Path:
    """The shared library of ``SRC``, compiled if it is not there yet (with
    OpenMP, or without when the compiler refuses it); a failed build raises
    ``RuntimeError`` with the compiler's output."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmonotonic_align-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", str(SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            cmd.remove("-fopenmp")
            r = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SRC.name} failed: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"building {SRC.name} failed ({' '.join(cmd)}):\n{r.stderr}")
    tmp.replace(lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded library (built at the first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.maximum_path.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ]
            lib.maximum_path.restype = None
            _lib = lib
    return _lib


def maximum_path_numpy(paths: np.ndarray, values: np.ndarray, t_xs, t_ys, max_neg_val: float) -> None:
    """The numpy twin of the C++ core: writes ``paths`` (B, Tx, Ty) int32 in
    place and accumulates into ``values`` (B, Tx, Ty) f32."""
    for i in range(values.shape[0]):
        t_x, t_y = int(t_xs[i]), int(t_ys[i])
        v = values[i]
        for y in range(t_y):
            for x in range(max(0, t_x + y - t_y), min(t_x, y + 1)):
                v_cur = max_neg_val if x == y else v[x, y - 1]
                v_prev = (0.0 if y == 0 else max_neg_val) if x == 0 else v[x - 1, y - 1]
                v[x, y] += max(v_cur, v_prev)
        index = t_x - 1
        for y in range(t_y - 1, -1, -1):
            paths[i, index, y] = 1
            if index != 0 and (index == y or v[index, y - 1] < v[index - 1, y - 1]):
                index -= 1


def maximum_path(values: np.ndarray, t_xs: Optional[np.ndarray] = None, t_ys: Optional[np.ndarray] = None,
                 max_neg_val: float = -1e9, native: bool = True) -> np.ndarray:
    """The best monotonic alignment of each item of ``values`` (B, Tx, Ty)
    log-likelihoods over its valid ``t_xs`` x ``t_ys`` corner: int32 (B, Tx,
    Ty), 1 on the path. ``native=False`` runs the numpy twin."""
    values = np.ascontiguousarray(values, np.float32).copy()
    b, tx, ty = values.shape
    t_xs = np.ascontiguousarray(t_xs if t_xs is not None else np.full(b, tx), np.int32)
    t_ys = np.ascontiguousarray(t_ys if t_ys is not None else np.full(b, ty), np.int32)
    paths = np.zeros((b, tx, ty), np.int32)
    if not native:
        maximum_path_numpy(paths, values, t_xs, t_ys, max_neg_val)
        return paths
    library().maximum_path(
        paths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        t_xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), t_ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        b, tx, ty, max_neg_val,
    )
    return paths
