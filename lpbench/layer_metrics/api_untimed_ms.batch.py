"""API layer: the mean ms of a whole-graph call that the program's own
clocks leave out: its wall (host clock) less ``time_ms`` (the timed pass
and the merge) and ``transfer_ms``.  That is the memory check, the uploads
of the stream and the CSR, and the untimed warm-up pass that
``measure_duration(warmup=True)`` runs before the timed one; over the
window's calls before the traced slice."""


def read(rec):
    if rec.kind != "whole_graph":
        return None
    t = [c["wall_s"] * 1e3 - c["time_ms"] - c["transfer_ms"]
         for c in rec.calls if c["ok"] and not c["traced"]]
    return sum(t) / len(t) if t else None
