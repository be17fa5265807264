"""Request latency percentiles; a failed request counts as missing any
limit."""
import math
import statistics


def percentile_of(calls, q: int):
    """The ``q``-th percentile (inclusive method) of the calls' walls in
    ms, or None where there is none or it falls on a failed call."""
    lat = sorted(c["wall_s"] * 1e3 if c["ok"] else math.inf for c in calls)
    if not lat:
        return None
    if len(lat) == 1:
        return lat[0] if math.isfinite(lat[0]) else None
    v = statistics.quantiles(lat, n=100, method="inclusive")[q - 1]
    return v if math.isfinite(v) else None


def percentile_ms(rec, q: int):
    """The ``q``-th percentile over all requests of the window."""
    if rec.kind != "per_user":
        return None
    return percentile_of(rec.calls, q)
