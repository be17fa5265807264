"""K1 fused tail: the mean host wall of one K1 launch in the traced slice,
in us: the program's span ``tile.k1`` (the wrapper's allocation, the
ctypes launch and its check; ``ops/fused_tail.py``).  The part of the
tile's host path (C9) that K1's wrapper takes, with the profiler's cost
of each of its operations."""
from lpbench.layer_metrics._spans import span_mean_us


def read(rec):
    return span_mean_us(rec, "tile.k1")
