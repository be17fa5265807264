"""Tile loop: the mean host wall of one tile in the traced slice, in us:
the program's span ``scan.tile`` (a tile's gathers, its sort, K1's launch
and the host work between them; ``predict/scoring.py``), the warm-up
pass's tiles and the timed pass's alike.  Where it is longer than the
card's work on a tile, the host holds the card back (C9).  The
profiler's cost of each operation of the tile is in it."""
from lpbench.layer_metrics._spans import span_mean_us


def read(rec):
    return span_mean_us(rec, "scan.tile")
