"""The traced run's records: one ``torch.profiler`` session (CPU and CUDA)
over a slice of the window, exported as a chrome trace and read back as a
list of complete events, and the arithmetic over them: the union of the
device's intervals, its idle gaps and what the host was doing in them, and
device time by kernel family.

Times are the trace's own microseconds.  The slice is marked by a host
annotation named ``WINDOW``, so the device's busy time is taken over
exactly the host's traced interval.  The session records every host op,
which slows the host: the slice's gaps are wider than in an untraced call,
and the device's idle share is read against untraced calls (see
``lpbench/layer_metrics/_idle.py``).
"""
from __future__ import annotations

import gzip
import json
import os
import re

__all__ = ["WINDOW", "DEVICE_CATS", "Capture", "load_events",
           "device_events", "window_of", "busy_us", "idle_gaps",
           "family_us", "breakdown", "short_name"]

WINDOW = "lpbench.window"
# Work that ran on the card; every other category is the host's.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Capture:
    """A profiler session that the window starts and stops between two
    calls; :meth:`export` writes the chrome trace once the window closed."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._mark = None
        self.done = False

    @staticmethod
    def warm_up(cuda: bool = True) -> None:
        """One short session, so that the profiler's own start-up (CUPTI's)
        falls before the traced slice and not into it."""
        import torch

        cap = Capture(cuda)
        cap.start()
        x = torch.ones(8, device="cuda" if cuda else "cpu")
        (x + 1).sum().item()
        cap.stop()

    def start(self) -> None:
        import torch

        self._prof.__enter__()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()

    def stop(self) -> None:
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.done = True

    def export(self, path: str) -> list:
        self._prof.export_chrome_trace(path)
        try:
            return load_events(path)
        finally:
            os.remove(path)


def load_events(path: str) -> list:
    """The complete (``ph == "X"``) events of a chrome trace file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = json.load(fh)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"]


def device_events(events) -> list:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def window_of(events) -> tuple[float, float]:
    """``(t0, t1)`` of the ``WINDOW`` annotation on the host; without one,
    the span of all events."""
    marks = [e for e in events if e.get("name") == WINDOW
             and e.get("cat") == "user_annotation"]
    if marks:
        e = marks[0]
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
    t0 = min(float(e["ts"]) for e in events)
    return t0, max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)


def _intervals(dev, t0: float, t1: float) -> list:
    """Device intervals clipped to ``[t0, t1]``, merged, in order."""
    iv = sorted((max(float(e["ts"]), t0),
                 min(float(e["ts"]) + float(e.get("dur", 0)), t1))
                for e in dev)
    merged = []
    for a, b in iv:
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def busy_us(events, t0: float, t1: float) -> float:
    """The union of kernel, memcpy and memset intervals inside the window."""
    return sum(b - a for a, b in _intervals(device_events(events), t0, t1))


def idle_gaps(events, t0: float, t1: float) -> list:
    """The window's stretches with nothing on the device: ``[(a, b)]``."""
    gaps, at = [], t0
    for a, b in _intervals(device_events(events), t0, t1):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if at < t1:
        gaps.append((at, t1))
    return gaps


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    argument list."""
    name = re.sub(r"^void ", "", name)
    prev = None
    while prev != name:
        prev, name = name, re.sub(r"<[^<>]*>", "", name)
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()


def family_us(events, pattern: str, with_memset: bool = False) -> tuple:
    """``(device us, launches)`` of the kernels whose name matches
    ``pattern`` (a regular expression); with ``with_memset``, the memset
    that comes just before each launch on its stream counts with it."""
    rx = re.compile(pattern)
    dev = sorted(device_events(events), key=lambda e: float(e["ts"]))
    last_on = {}
    total, launches = 0.0, 0
    for e in dev:
        stream = (e.get("args") or {}).get("stream")
        if e.get("cat") == "kernel" and rx.search(e.get("name", "")):
            total += float(e.get("dur", 0))
            launches += 1
            prev = last_on.get(stream)
            if with_memset and prev is not None \
                    and prev.get("cat") == "gpu_memset":
                total += float(prev.get("dur", 0))
        last_on[stream] = e
    return total, launches


def _label(host, a: float, b: float) -> str:
    """The innermost host event that holds the gap's midpoint."""
    mid = (a + b) / 2
    best = None
    for e in host:
        s = float(e["ts"])
        if s > mid:
            break
        d = float(e.get("dur", 0))
        if s + d >= mid and (best is None or d < float(best.get("dur", 0))):
            best = e
    return best["name"] if best is not None else "host, no traced op"


def breakdown(events, t0: float, t1: float, top: int = 10) -> dict:
    """The device ops that took the most time in the window, and its
    longest idle gaps, each named by what the host was doing: seconds."""
    per = {}
    for e in device_events(events):
        s, d = float(e["ts"]), float(e.get("dur", 0))
        if s + d <= t0 or s >= t1:
            continue
        name = e.get("name", "?")
        if e.get("cat") == "kernel":
            name = short_name(name)
        per[name] = per.get(name, 0.0) + min(s + d, t1) - max(s, t0)
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    host = sorted((e for e in events if e.get("cat") in _HOST_CATS
                   and e.get("name") != WINDOW),
                  key=lambda e: float(e["ts"]))
    gaps = sorted(idle_gaps(events, t0, t1), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n, us / 1e6] for n, us in ops],
            "idle_gaps": [[_label(host, a, b), (b - a) / 1e6]
                          for a, b in gaps]}
