"""Build the package's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/*.cu`` compiles to an object file in its own ``nvcc`` process,
all started together, and the objects link into one shared library with a
plain C interface, for ``sm_90a`` (Hopper), at first use. The library lands in
``build/slam_llm_tpu_torch/`` at the root of the checkout, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one
loads the existing file. A missing ``nvcc`` or a failed build raises: no
kernel has a fallback on CUDA tensors.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
``check`` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "slam_llm_tpu_torch"
# no --use_fast_math: rowquant's division and rounding must stay IEEE-exact
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # x fold q s | m k x_f32 rotate stochastic seed | threads rows units fold_smem | stream
    "slam_rowquant": [_P] * 4 + [_L, _I, _I, _I, _I, _L] + [_I] * 4 + [_P],
    # xq wq xs ws out scratch counters | m n k out_f32 path bm splits sms | stream
    "slam_int8_matmul": [_P] * 7 + [_I] * 8 + [_P],
    # q k v mask out lse cos sin k_rot | b tq tk h hkv d | q/k/v strides | scale causal hb bn sms stream
    "slam_flash_fwd": [_P] * 9 + [_I] * 6 + [_L] * 9 + [ctypes.c_float, _I, _I, _I, _I, _P],
    # q k v mask out dout lse cos sin lse_t dlt_t q_rot k_rot dq dk dv (all contiguous) | b t h hkv d |
    # scale | causal hb tpad sms | stream
    "slam_flash_bwd": [_P] * 16 + [_I] * 5 + [ctypes.c_float] + [_I] * 4 + [_P],
    # q k v mask out lse | b tq tk h hkv d | q/k/v strides | scale causal | stream
    "slam_flash_fwd_f32": [_P] * 6 + [_I] * 6 + [_L] * 9 + [ctypes.c_float, _I, _P],
    # q k v mask out dout lse delta dq dk dv | b t h hkv d | q/k/v/out/dout strides | scale causal | stream
    "slam_flash_bwd_f32": [_P] * 11 + [_I] * 5 + [_L] * 15 + [ctypes.c_float, _I, _P],
    # q k v s_out o_out | d n | stream
    "slam_wgmma_probe": [_P] * 5 + [_I, _I, _P],
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of the last compile in this process


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc") if os.environ.get("CUDA_HOME") else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): cannot build the CUDA kernels")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    global build_seconds
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    tmp = so.with_name(f"{tag}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            failed.append(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    # ptxas -v reports registers, shared memory and spills per kernel
    so.with_suffix(".log").write_text("".join(logs))
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.slam_error_string.argtypes = [ctypes.c_int]
        lib.slam_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = library().slam_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``: the planners size
    persistent grids and K splits by it."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as the C entry points take it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
