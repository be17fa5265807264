"""Build modes, assertions, levelled logging and crash diagnostics
(counterpart of ``linkpred_tpu/utils/debug.py``).

The reference compiles its checks in or out with ``-DBUILD=N``; here the
mode is a runtime setting, read from ``LINKPRED_BUILD`` at import and
changed with :func:`set_build_mode`.
"""
from __future__ import annotations

import faulthandler
import io
import os
import sys

from .logging import log

__all__ = [
    "BUILD_RELEASE", "BUILD_ERROR", "BUILD_WARNING", "BUILD_INFO",
    "BUILD_DEBUG", "BUILD_TRACE",
    "set_build_mode", "build_mode",
    "ASSERT", "ASSERT_THAT",
    "log_error", "log_warning", "log_info", "log_debug", "log_trace",
    "install_fault_handler",
]

BUILD_RELEASE = 0
BUILD_ERROR = 1
BUILD_WARNING = 2
BUILD_INFO = 3
BUILD_DEBUG = 4
BUILD_TRACE = 5

_MODE = int(os.environ.get("LINKPRED_BUILD", BUILD_RELEASE))


def set_build_mode(mode: int) -> None:
    global _MODE
    _MODE = int(mode)


def build_mode() -> int:
    return _MODE


def ASSERT(exp, msg: str = "") -> None:
    """Raises ``AssertionError`` when ``exp`` is false, from BUILD_ERROR
    up; a no-op in release mode."""
    if _MODE >= BUILD_ERROR and not exp:
        raise AssertionError(msg or "ASSERT failed")


def ASSERT_THAT(exp_fn, msg: str = "") -> None:
    """:func:`ASSERT` of ``exp_fn()``, called only when the mode checks."""
    if _MODE >= BUILD_ERROR and not exp_fn():
        raise AssertionError(msg or "ASSERT_THAT failed")


def _leveled(level: int, tag: str):
    def emit(msg: str) -> None:
        if _MODE >= level:
            log(f"{tag}{msg}")
    return emit


log_error = _leveled(BUILD_ERROR, "E ")
log_warning = _leveled(BUILD_WARNING, "W ")
log_info = _leveled(BUILD_INFO, "I ")
log_debug = _leveled(BUILD_DEBUG, "D ")
log_trace = _leveled(BUILD_TRACE, "T ")


def install_fault_handler(file=None) -> None:
    """Backtraces of every thread on SIGSEGV/SIGABRT (the reference
    driver's ``install_sigsegv``), via the stdlib faulthandler.  No-op when
    stderr has no OS-level fd (e.g. under pytest capture)."""
    try:
        faulthandler.enable(file=file or sys.stderr, all_threads=True)
    except (io.UnsupportedOperation, AttributeError, ValueError):
        pass
