"""Builds and loads the port's CUDA kernels.

``nvcc`` compiles ``csrc/*.cu`` (plain C interfaces, no PyTorch headers) for
``sm_90a`` into one shared library under ``linkpred_tpu_torch/build/`` at
first use, and rebuilds when a source is newer than the library.  The
library is loaded with ctypes; tensors go in as ``data_ptr()`` and the
stream as ``torch.cuda.current_stream().cuda_stream``.  No ``--use_fast_math``:
the float divides and square roots stay IEEE so unweighted scores match the
plain twins bit for bit.  A missing ``nvcc`` or a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

__all__ = ["load", "check", "SOURCES", "BUILD_DIR", "NVCC_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", f)
           for f in ("fused_tail.cu", "compact.cu")]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_SO = os.path.join(BUILD_DIR, "liblinkpred_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "CUDA kernels of linkpred_tpu_torch are built from "
        "linkpred_tpu_torch/kernels/csrc with the CUDA toolkit's nvcc")


def _build() -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, *SOURCES],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({r.returncode}) building {_SO}:\n{r.stderr}")
    os.replace(tmp, _SO)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    stale = not os.path.exists(_SO) or os.path.getmtime(_SO) < max(
        os.path.getmtime(s) for s in SOURCES)
    if stale:
        _build()
    lib = ctypes.CDLL(_SO)
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.lp_fused_tail_scratch_bytes.restype = i64
    lib.lp_fused_tail_scratch_bytes.argtypes = [i64]
    lib.lp_fused_tail.restype = i32
    lib.lp_fused_tail.argtypes = [
        i32,                              # CUDA device index
        p, p, p, p, p, p,                 # hi, lo, deg0, deg1, w0, w1
        i64, i32, ctypes.c_uint64,        # cap, n_metrics, codes
        i32, i32, i32, ctypes.c_float,    # w_bits, n, maxf2, min_score
        p, p, p, p, p]                    # skeys, ku, kw, scratch, stream
    lib.lp_pack_scratch_bytes.restype = i64
    lib.lp_pack_scratch_bytes.argtypes = [i64]
    lib.lp_pack_survivors.restype = i32
    lib.lp_pack_survivors.argtypes = [
        i32,                              # CUDA device index
        p, p, i64, i64,                   # key, thr, total, capacity
        p, p, p, p, p]                    # pk, pidx, count, scratch, stream
    lib.lp_cuda_error_string.restype = ctypes.c_char_p
    lib.lp_cuda_error_string.argtypes = [i32]
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = lib.lp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
