"""Numeric helpers, device memory budgets, timing, the reference's log
grammar, the fault handler, the memory roofline and the profiler helper.

The reference's ``sync`` is not here: it waited out a relay host that the
card does not have (CUDA events and stream syncs do its work)."""
from .timing import measure_duration, measure_duration_marked
from .logging import graph_line, log, result_line
from .random import Xorshift32, xorshift32_step

__all__ = ["measure_duration", "measure_duration_marked",
           "log", "graph_line", "result_line", "Xorshift32", "xorshift32_step"]
