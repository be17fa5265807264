"""Repeat-averaged timing (counterpart of ``linkpred_tpu/utils/timing.py``).

The reference's signatures and semantics: ``measure_duration(fn, repeat=1,
warmup=True)`` averages ``repeat`` calls after an optional untimed one, and
``measure_duration_marked(fn, repeat=1)`` times only what ``fn`` wraps in
the ``mark`` it is handed.  The port adds ``device=`` (a keyword, default
the card): on a CUDA device the clock is a pair of CUDA events on the
current stream, read after a stream sync; on the CPU it is
``time.perf_counter``.  ``measure_duration``'s untimed call is the span
``api.warmup``, up to the stream sync that ends it, and its timed calls
with their closing sync are ``api.score`` (``utils/profiling.py``).
"""
from __future__ import annotations

import time
from typing import Callable, Tuple, TypeVar

import torch

from .profiling import span

T = TypeVar("T")

__all__ = ["measure_duration", "measure_duration_marked"]


class _Clock:
    """Milliseconds between ``start()`` and ``stop()`` on ``device``: CUDA
    events on its current stream, read after a sync, or the host clock."""

    def __init__(self, device):
        device = torch.device(device)
        self.stream = (torch.cuda.current_stream(device)
                       if device.type == "cuda" else None)

    def sync(self) -> None:
        """Wait for the work queued on the clock's stream."""
        if self.stream is not None:
            self.stream.synchronize()

    def start(self) -> None:
        if self.stream is None:
            self.t0 = time.perf_counter()
            return
        self.begin = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.sync()
        self.begin.record(self.stream)

    def stop(self) -> float:
        if self.stream is None:
            return (time.perf_counter() - self.t0) * 1e3
        self.end.record(self.stream)
        self.stream.synchronize()
        return self.begin.elapsed_time(self.end)


def measure_duration(fn: Callable[[], T], repeat: int = 1,
                     warmup: bool = True, *,
                     device="cuda") -> Tuple[float, T]:
    """Run ``fn`` once untimed when ``warmup`` (the kernels' first call
    builds and loads them), then ``repeat`` times on ``device``; return
    (average milliseconds, last result)."""
    repeat = max(repeat, 1)
    clock = _Clock(device)
    if warmup:
        with span("api.warmup"):
            fn()
            clock.sync()
    with span("api.score"):
        clock.start()
        for _ in range(repeat):
            result = fn()
        ms = clock.stop()
    return ms / repeat, result


def measure_duration_marked(fn: Callable[[Callable], T], repeat: int = 1, *,
                            device="cuda") -> Tuple[float, T]:
    """Time only the sub-sections that ``fn`` wraps in the ``mark`` it is
    handed (``mark(f)`` runs ``f()`` on the clock and returns its result),
    ``repeat`` times; return (average marked milliseconds a call, last
    result)."""
    clock = _Clock(device)
    acc = 0.0
    result = None

    def mark(f):
        nonlocal acc
        clock.start()
        r = f()
        acc += clock.stop()
        return r

    for _ in range(max(repeat, 1)):
        result = fn(mark)
    return acc / max(repeat, 1), result
