"""The device's idle share: 100 - its busy time in the traced slice over
what the slice's calls take untraced (their number times the mean wall of
the calls before it, made with no profiler started in the process).  The
slice's own length would count the profiler's per-op cost as idle."""
from lpbench.trace import busy_us, device_events, window_of


def idle_pct(rec, kind: str):
    if rec.kind != kind or not rec.events or not rec.traced_calls \
            or not device_events(rec.events):
        return None
    before = [c["wall_s"] for c in rec.calls
              if c["ok"] and c["traced"] is None]
    if not before:
        return None
    t0, t1 = window_of(rec.events)
    untraced_s = rec.traced_calls * sum(before) / len(before)
    return 100.0 * (1.0 - busy_us(rec.events, t0, t1) / 1e6 / untraced_s)
