"""The median request latency over all requests of the window."""
from lpbench.end_to_end._latency import percentile_ms


def read(rec):
    return percentile_ms(rec, 50)
