"""Host plan: the median ms of each request's ``build_plan`` (host clock
around the name ``predict.api`` calls), over the requests before the
traced slice."""
import statistics


def read(rec):
    if rec.kind != "per_user":
        return None
    t = [c["plan_s"] * 1e3 for c in rec.calls
         if c["ok"] and not c["traced"] and "plan_s" in c]
    return statistics.median(t) if t else None
