"""API layer, serving: the 95th percentile latency (inclusive method) of
the requests made before the traced slice, with no profiler started in
the process, each from ``predict_links(sources=...)`` until its per-user
rows are on the host.  Its tail rests on the few heaviest requests of
some tens, and on the host's speed while they ran, so it stands beside
``request_ms_p50`` here and holds no bound."""
from lpbench.end_to_end._latency import percentile_of


def read(rec):
    if rec.kind != "per_user":
        return None
    return percentile_of([c for c in rec.calls if not c["traced"]], 95)
