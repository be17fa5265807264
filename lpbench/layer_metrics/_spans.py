"""The mean length of one of the program's spans, in us, in the traced
slice: while the profiler runs, each span is an annotation of its trace
(``cat`` ``user_annotation``; ``utils/profiling.py``), on the profiler's
clock.  The profiler's cost of each operation inside the span is in it:
read it against earlier readings of itself, not against the untraced
walls.  None where the slice holds no such span."""


def span_mean_us(rec, name: str):
    if rec.kind != "whole_graph" or not rec.events:
        return None
    durs = [e["dur"] for e in rec.events
            if e.get("cat") == "user_annotation" and e.get("name") == name]
    return sum(durs) / len(durs) if durs else None
