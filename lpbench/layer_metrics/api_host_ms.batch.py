"""API layer: the mean ms a whole-graph call spends in the API's host work
after its timed pass, by the program's own clocks (``PredictResult``):
the copy of the top rows to the host (``transfer_ms``) and the host merge
(``time_ms - scoring_ms``), over the window's calls before the traced
slice."""


def read(rec):
    if rec.kind != "whole_graph":
        return None
    t = [c["transfer_ms"] + c["time_ms"] - c["scoring_ms"]
         for c in rec.calls if c["ok"] and not c["traced"]]
    return sum(t) / len(t) if t else None
