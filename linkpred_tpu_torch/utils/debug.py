"""Crash diagnostics (counterpart of ``install_fault_handler`` in
``linkpred_tpu/utils/debug.py``; the rest of that module is not ported)."""
from __future__ import annotations

import faulthandler
import io
import sys

__all__ = ["install_fault_handler"]


def install_fault_handler(file=None) -> None:
    """Backtraces of every thread on SIGSEGV/SIGABRT (the reference
    driver's ``install_sigsegv``), via the stdlib faulthandler.  No-op when
    stderr has no OS-level fd (e.g. under pytest capture)."""
    try:
        faulthandler.enable(file=file or sys.stderr, all_threads=True)
    except (io.UnsupportedOperation, AttributeError, ValueError):
        pass
