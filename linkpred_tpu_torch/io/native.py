"""ctypes loader for the native C++ host helpers (``native/src/``): the MTX
body parser (``mtx_native.cpp``) and the plan helpers (``plan_native.cpp``).

Builds ``liblinkpred_native.so`` from both sources with ``g++`` into the
port's build directory (``linkpred_tpu_torch/build/``) on first use, and
rebuilds when a source is newer.  When there is no compiler or the build
fails, ``native_lib()`` is None: ``io.mtx`` then parses with its NumPy
tokenizer and the planner runs its NumPy pipeline, and both give the same
result (host work only; no device work depends on this library).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

__all__ = ["native_lib", "parse_mtx_body", "parse_mtx_buffer", "BUILD_DIR"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "build")
_SRCS = [os.path.join(os.path.dirname(_PKG), "native", "src", f)
         for f in ("mtx_native.cpp", "plan_native.cpp")]
_SO = os.path.join(BUILD_DIR, "liblinkpred_native.so")

_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-o", tmp, *_SRCS],
            check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return False
    os.replace(tmp, _SO)
    return True


def native_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built on demand; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not all(os.path.exists(p) for p in _SRCS):
        return None
    fresh = os.path.exists(_SO) and os.path.getmtime(_SO) >= max(
        os.path.getmtime(p) for p in _SRCS)
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
        cchar_p = ctypes.POINTER(ctypes.c_char)
        lib.lp_mtx_parse.restype = ctypes.c_int64
        lib.lp_mtx_parse.argtypes = [
            cchar_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double)]
        lib.lp_mtx_detect_cols.restype = ctypes.c_int
        lib.lp_mtx_detect_cols.argtypes = [cchar_p, ctypes.c_int64]
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


def _as_cptr(buf, offset: int = 0):
    """Zero-copy ``char*`` into ``buf`` (bytes, bytearray, mmap) at
    ``offset``."""
    if isinstance(buf, bytes):
        base = ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_char))
        return ctypes.cast(ctypes.byref(base.contents, offset),
                           ctypes.POINTER(ctypes.c_char))
    view = (ctypes.c_char * (len(buf) - offset)).from_buffer(buf, offset)
    return ctypes.cast(view, ctypes.POINTER(ctypes.c_char))


def parse_mtx_buffer(
    buf, offset: int, length: int, max_rows: int, weighted: bool,
) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Parse coordinate lines from ``buf[offset:offset+length]`` without
    copying the text (``buf`` may be an mmap of a multi-GB file).  Returns
    (src, dst, weights) as 1-indexed int64 arrays and float64 weights, or
    None when the native library is unavailable."""
    lib = native_lib()
    if lib is None:
        return None
    p = _as_cptr(buf, offset)
    ncols = lib.lp_mtx_detect_cols(p, length)
    if ncols < 2:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy(), (np.empty(0, dtype=np.float64) if weighted
                             else None)
    src = np.empty(max_rows, dtype=np.int64)
    dst = np.empty(max_rows, dtype=np.int64)
    wts = (np.empty(max_rows, dtype=np.float64)
           if (weighted and ncols >= 3) else None)
    rows = int(lib.lp_mtx_parse(
        p, length, max_rows, ncols,
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        wts.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if wts is not None else None))
    return src[:rows], dst[:rows], (wts[:rows] if wts is not None else None)


def parse_mtx_body(
    body: bytes, max_rows: int, weighted: bool,
) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """Parse coordinate lines into (src, dst, weights), 1-indexed; None when
    the native library is unavailable."""
    return parse_mtx_buffer(body, 0, len(body), max_rows, weighted)
