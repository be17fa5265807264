"""ctypes loader for the native plan helpers (``native/src/plan_native.cpp``).

Builds ``libplan_native.so`` with ``g++`` into the port's build directory
(``linkpred_tpu_torch/build/``) on first use, and rebuilds when the source is
newer.  When there is no compiler or the build fails, ``native_lib()`` is
None and the planner runs its NumPy pipeline instead: both produce the same
plan (host planning only; no device work depends on this library).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

__all__ = ["native_lib", "BUILD_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
_SRC = os.path.join(os.path.dirname(_PKG), "native", "src", "plan_native.cpp")
_SO = os.path.join(BUILD_DIR, "libplan_native.so")

_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _SO)
    return True


def native_lib() -> Optional[ctypes.CDLL]:
    """The loaded plan library, built on demand; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SRC):
        return None
    fresh = os.path.exists(_SO) and \
        os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
    if not fresh and not _build():
        return None
    _lib = _load()
    if _lib is None and fresh and _build():
        # a copied artifact can pass the mtime check yet miss a symbol
        _lib = _load()
    return _lib


def _load() -> Optional[ctypes.CDLL]:
    try:
        lib = ctypes.CDLL(_SO)
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.lp_plan_expand.restype = ctypes.c_int64
        lib.lp_plan_expand.argtypes = [
            i32p, i32p, ctypes.c_int64,              # offsets, indices, n
            i32p, i32p, i32p, ctypes.c_int64,        # src, mid, skip, m1
            ctypes.c_int32, ctypes.c_int32,          # upper_only, deg16
            ctypes.c_int64,                          # est
            i32p, i32p, i32p, i32p, i32p,            # slot arrays
            i64p]                                    # cnt_u
        lib.lp_plan_firsthop.restype = ctypes.c_int64
        lib.lp_plan_firsthop.argtypes = [
            i32p, i32p, ctypes.c_int64,              # offsets, indices, n
            ctypes.c_int32, ctypes.c_int32,          # min_degree1, upper_only
            i32p, i32p, i32p,                        # src, mid, skip out
            i32p, i32p,                              # kuniq, kskip out
            ctypes.POINTER(ctypes.c_int64)]          # ku_out
        return lib
    except (OSError, AttributeError):
        # AttributeError: the .so loaded but misses a symbol
        return None
