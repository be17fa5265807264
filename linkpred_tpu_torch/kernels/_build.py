"""Builds and loads the port's CUDA kernels.

One ``nvcc`` process per source in ``SOURCES`` (plain C interfaces, no
PyTorch headers), all started together, compiles for ``sm_90a``; one more
links the objects into one shared library under ``linkpred_tpu_torch/build/``
at first use.  It rebuilds when a source is newer than the library.  The
library is loaded with ctypes; tensors go in as ``data_ptr()`` and the
stream as ``torch.cuda.current_stream().cuda_stream``.  No
``--use_fast_math``: the float divides and square roots stay IEEE so
unweighted scores match the plain twins bit for bit.  A missing ``nvcc`` or
a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

__all__ = ["load", "check", "SOURCES", "BUILD_DIR", "NVCC_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_HERE, "csrc", f)
           for f in ("fused_tail.cu", "compact.cu", "smoke.cu", "bitonic.cu",
                     "dynstore.cu")]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "build")
_SO = os.path.join(BUILD_DIR, "liblinkpred_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

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


def _run(cmds, what: str) -> None:
    """Run the commands side by side; raise if any failed, once all ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    errs = [p.communicate()[1] for p in procs]
    for cmd, p, err in zip(cmds, procs, errs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}) {what}: "
                               f"{' '.join(cmd)}\n{err}")


def _build() -> None:
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in SOURCES]
    tmp = f"{_SO}.{tag}"
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", o, s]
              for s, o in zip(SOURCES, objs)], f"compiling for {_SO}")
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]],
             f"linking {_SO}")
        os.replace(tmp, _SO)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


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
    lib.lp_fused_tail_tile_lanes.restype = i32
    lib.lp_fused_tail_tile_lanes.argtypes = []
    lib.lp_fused_tail_scratch_bytes.restype = i64
    lib.lp_fused_tail_scratch_bytes.argtypes = [i64]
    lib.lp_fused_tail.restype = i32
    lib.lp_fused_tail.argtypes = [
        i32,                              # CUDA device index
        p, p, p, p, p, p,                 # hi, lo, deg0, deg1, w0, w1
        i64, i32, ctypes.c_uint64,        # cap, n_metrics, codes
        i32, i32, i32, ctypes.c_float,    # w_bits, n, maxf2, min_score
        i32,                              # killers
        p, p, p, p, p]                    # skeys, ku, kw, scratch, stream
    lib.lp_pack_scratch_bytes.restype = i64
    lib.lp_pack_scratch_bytes.argtypes = [i64]
    lib.lp_pack_survivors.restype = i32
    lib.lp_pack_survivors.argtypes = [
        i32,                              # CUDA device index
        p, p, i64, i64,                   # key, thr, total, capacity
        p, p, p, p, p]                    # pk, pidx, count, scratch, stream
    lib.lp_affine_smoke.restype = i32
    lib.lp_affine_smoke.argtypes = [i32, p, p, i64, p]  # device, x, out, n,
    #                                                      stream
    lib.lp_bitonic_sort.restype = i32
    lib.lp_bitonic_sort.argtypes = [
        i32,                              # CUDA device index
        p, p, i64,                        # key, payload (or None), n
        p, p, i64,                        # host stage tables ks, js; count
        p, i64, i32,                      # host launch table, rows, log2 tile
        p, p]                             # stream, host int64 launch count
    lib.lp_bitonic_limits.restype = None
    lib.lp_bitonic_limits.argtypes = [p]  # host int32[4]
    lib.lp_dynstore.restype = i32
    lib.lp_dynstore.argtypes = [i32, p, p, p, i32, p]  # device, off, x, out,
    #                                                    iters, stream
    lib.lp_cuda_error_string.restype = ctypes.c_char_p
    lib.lp_cuda_error_string.argtypes = [i32]
    _lib = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = lib.lp_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
