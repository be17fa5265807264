"""Repeat-averaged timing (counterpart of ``linkpred_tpu/utils/timing.py``).

Same warm-up and repeat semantics as the reference's ``measure_duration``
(its one call without the warm-up timed host work, which the port times
with ``perf_counter`` directly).  On a CUDA device the clock is a pair of CUDA events on the current stream,
read after a stream sync; on the CPU it is ``time.perf_counter``.
"""
from __future__ import annotations

import time
from typing import Callable, Tuple, TypeVar

import torch

T = TypeVar("T")

__all__ = ["measure_duration"]


def measure_duration(fn: Callable[[], T], device,
                     repeat: int = 1) -> Tuple[float, T]:
    """Run ``fn`` once untimed (the kernels' first call builds and loads
    them), then ``repeat`` times on ``device``; return (average
    milliseconds, last result)."""
    device = torch.device(device)
    repeat = max(repeat, 1)
    fn()
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        stream.synchronize()
        start.record(stream)
        for _ in range(repeat):
            result = fn()
        end.record(stream)
        stream.synchronize()
        return start.elapsed_time(end) / repeat, result
    t0 = time.perf_counter()
    for _ in range(repeat):
        result = fn()
    return (time.perf_counter() - t0) * 1e3 / repeat, result
