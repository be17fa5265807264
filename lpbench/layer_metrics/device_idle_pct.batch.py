"""Device: 100 - the union of kernel, memcpy and memset intervals in the
traced slice of a whole-graph window, over the seconds its calls take
untraced, in % (``_idle.py``)."""
from lpbench.layer_metrics._idle import idle_pct


def read(rec):
    return idle_pct(rec, "whole_graph")
