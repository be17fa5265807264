"""Tile loop, serving: the ms a request spends scoring its wide-degree side
plan.  Each span ``scan.side`` (one scoring of a side plan: its tiles, K1's
wide branch and its own selection, in place of ``scan.pass``;
``predict/api.py`` names it) is, while the
profiler runs, an annotation of its trace (``cat`` ``user_annotation``) on
the profiler's clock; their lengths are summed over the traced slice and
divided by the requests traced, so a request's warm-up scoring and its
timed one both count.  The profiler's cost of each operation inside the
span is in it.  None outside a serving run, or where the slice holds no
such span (a program without it, or requests with no side plan)."""


def read(rec):
    if rec.kind != "per_user" or not rec.events or not rec.traced_calls:
        return None
    durs = [float(e.get("dur", 0)) for e in rec.events
            if e.get("cat") == "user_annotation"
            and e.get("name") == "scan.side"]
    return sum(durs) / 1e3 / rec.traced_calls if durs else None
