"""Numeric helpers, device memory budgets, timing, the reference's log
grammar, the fault handler, the memory roofline and the profiler helper."""
