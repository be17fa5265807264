"""Device profiling: trace capture and a per-op summary (counterpart of
``linkpred_tpu/utils/profiling.py``).

The reference's observability is wall-clock only.  On the card the
question is which kernel holds the device time, so this wraps
``torch.profiler`` trace capture (CPU and, where there is a card, CUDA
activity) and parses the chrome trace it writes into an aggregated per-op
table.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import tempfile
from typing import Callable, Optional

import torch

__all__ = ["trace", "summarize_trace", "profile_fn"]

# Chrome-trace categories of the work that ran on the card (the rest are
# host spans: operators, runtime calls, Python functions).
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Context manager: capture a profiler trace; yields the trace
    directory, into which a chrome trace (``*.trace.json.gz``) is written
    on exit."""
    from torch.profiler import ProfilerActivity, profile

    d = log_dir or tempfile.mkdtemp(prefix="linkpred_trace_")
    os.makedirs(d, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield d
    prof.export_chrome_trace(
        os.path.join(d, f"linkpred.{os.getpid()}.{id(prof)}.trace.json.gz"))


def _durations(trace_dir: str) -> dict:
    """{op name: [total ms, ran on the card]} over the traces in
    ``trace_dir``."""
    files = glob.glob(os.path.join(trace_dir, "**", "*.trace.json*"),
                      recursive=True)
    agg: dict = {}
    for f in files:
        opener = gzip.open if f.endswith(".gz") else open
        with opener(f, "rt") as fh:
            data = json.load(fh)
        for e in data.get("traceEvents", []):
            if e.get("ph") == "X":
                row = agg.setdefault(e.get("name", "?"), [0.0, False])
                row[0] += e.get("dur", 0) / 1e3
                row[1] = row[1] or e.get("cat") in _DEVICE_CATS
    return agg


def summarize_trace(trace_dir: str, top: int = 25) -> list[tuple[str, float]]:
    """Aggregate op durations from a captured trace.

    Returns [(op_name, total_ms)] sorted descending — device kernels and
    host spans mixed; the kernel rows (e.g. ``tail_onepass``) give the
    kernels' device time.
    """
    agg = _durations(trace_dir)
    return sorted(((k, v[0]) for k, v in agg.items()),
                  key=lambda kv: -kv[1])[:top]


def profile_fn(fn: Callable, *args, top: int = 25, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a trace; returns (result, summary).

    Where there is a card, the call ends with ``torch.cuda.synchronize()``
    inside the trace, and a trace holding no device event raises (a
    profiler session on the card has been seen to record none): the
    summary is never a host-only table passed off as the device's."""
    with trace() as d:
        result = fn(*args, **kwargs)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    if torch.cuda.is_available() and not any(
            dev for _, dev in _durations(d).values()):
        raise RuntimeError(
            f"profile_fn: the profiler recorded no device event in {d}")
    return result, summarize_trace(d, top=top)
