"""Observability: the program's spans and counters, and device trace
capture with a per-op summary (counterpart of
``linkpred_tpu/utils/profiling.py``).

The reference's observability is wall-clock only.  The port adds:

* **Spans** (:func:`span`): a context manager at each layer boundary of
  the program (``plan.*``, ``api.*``, ``scan.*``, ``tile.*``,
  ``select.metric``; a pass's scoring is ``scan.pass``, or ``scan.side``
  for a wide-degree side plan).  Recording is off by default;
  :func:`enable` turns it on and :func:`drain` returns and clears what was
  recorded.  A record holds the name, start and end
  (``time.perf_counter_ns``), its id, its parent's id and a call id: the
  id of the outermost span open when it started (one ``predict_links``
  call, or one ``build_plan`` called directly).  :func:`wall_ns` places a
  stamp on the wall clock through the anchor pair taken at
  :func:`enable`.
  The recorder keeps one stack of open spans, for the one thread that
  drives the card.
  While a ``torch.profiler`` session is active, a span also opens
  ``torch.profiler.record_function`` under its name, whether or not the
  recorder keeps it, so the session's trace names the program's layers on
  its own clock.  Otherwise, with recording off, :func:`span` returns one
  shared object that does nothing.
* **Counters** (:func:`count`): always on; :func:`counter` reads one,
  :func:`reset_counters` zeroes them all.  The program counts
  ``k1.launches`` and ``k1.killer_launches`` (CUDA launches of K1, and of
  those the ones with killers), ``k2.launches`` (of K2),
  ``select.packed_arm`` and ``select.sort_arm`` (which arm of the packed
  selection ran), ``select.full_sort`` (selections sent straight to one
  full sort, the pack not tried), ``scan.segments`` (segments the
  segmented selection selected over), ``scan.tiles`` (tiles the tile loop
  scored), ``api.merge_rows`` (rows of the passes' winners and the
  host-scored hubs' that enter the device merge, over metrics),
  ``api.rows_back`` (merged rows copied back to the host, at most
  ``max_edges`` a metric, over metrics), ``api.warmup_skips`` (calls
  that skipped the untimed warm-up pass: a plan already scored with the
  same shape),
  ``plan.firsthop_rows`` (CSR rows a plan's first hop read for a source
  set) and ``plan.firsthop_scans`` (plans whose first hop scanned every
  edge).
* **Trace capture** (:func:`trace`, :func:`profile_fn`): a
  ``torch.profiler`` session (CPU and, where there is a card, CUDA
  activity) whose chrome trace is read back into a per-op table, host ops
  and device work in separate rows.
"""
from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["span", "enable", "disable", "drain", "summarize_spans",
           "wall_ns", "count", "counter", "reset_counters", "trace",
           "summarize_trace", "profile_fn"]

# Chrome-trace categories of the work that ran on the card (the rest are
# host spans: operators, runtime calls, annotations).
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# ------------------------------------------------------------------ spans

_on = False
_open: list = []        # the recorded spans open now, innermost last
_done: list = []        # closed recorded spans, in closing order
_last_id = 0
_anchor = (0, 0)        # (time.time_ns(), time.perf_counter_ns()) at enable()


class _NoSpan:
    """The shared span of the off path.  Its ``__enter__`` and ``__exit__``
    are one C function, which a ``with`` statement calls unbound, so no
    Python frame is made: ``"".format`` takes any arguments and returns
    ``""``, which is false, so an exception raised inside passes through."""
    __slots__ = ()
    __enter__ = __exit__ = "".format


_NO_SPAN = _NoSpan()


class Span:
    """One recorded span; after it closed, its record: ``name``, ``start``
    and ``end`` (``perf_counter_ns``), ``id``, ``parent`` (the enclosing
    recorded span's id, or None) and ``call`` (the outermost one's id)."""
    __slots__ = ("name", "start", "end", "id", "parent", "call", "_mark")

    def __init__(self, name: str):
        self.name = name
        self._mark = None

    def __enter__(self):
        global _last_id
        _last_id += 1
        self.id = _last_id
        up = _open[-1] if _open else None
        self.parent = up.id if up is not None else None
        self.call = up.call if up is not None else self.id
        _open.append(self)
        # the stamps bracket the profiler's annotation, whose first opening
        # in a process takes a millisecond after its own start
        self.start = time.perf_counter_ns()
        if _autograd_profiler._is_profiler_enabled:
            self._mark = torch.profiler.record_function(self.name)
            self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self._mark is not None:
            self._mark.__exit__(*exc)
            self._mark = None
        self.end = time.perf_counter_ns()
        _open.pop()
        _done.append(self)
        return False


def span(name: str):
    """A context manager around one layer's work: recorded while recording
    is on, an annotation of the profiler's trace while a ``torch.profiler``
    session is active, and otherwise one shared object that does
    nothing."""
    if _on:
        return Span(name)
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def enable() -> None:
    """Start recording spans, and take the anchor of :func:`wall_ns`."""
    global _on, _anchor
    _anchor = (time.time_ns(), time.perf_counter_ns())
    _on = True


def disable() -> None:
    """Stop recording; spans open now are still recorded when they close."""
    global _on
    _on = False


def drain() -> list:
    """The spans recorded and closed since the last drain, in closing order
    (children before their parent); clears them."""
    out = _done[:]
    del _done[:]
    return out


def wall_ns(t: int) -> int:
    """The wall clock (``time.time_ns``) at the ``perf_counter_ns`` stamp
    ``t``, through the anchor taken at the last :func:`enable`.  A
    profiler's chrome trace puts an event at ``ts * 1000 +
    baseTimeNanoseconds`` on the same clock."""
    return _anchor[0] + (t - _anchor[1])


def summarize_spans(spans) -> dict:
    """``{name: (count, total ns, self ns)}`` over ``spans`` (records of
    :func:`drain`); a span's self time is its duration less the part its
    recorded children cover."""
    child_ns: dict = {}
    for s in spans:
        if s.parent is not None:
            child_ns[s.parent] = child_ns.get(s.parent, 0) + s.end - s.start
    out: dict = {}
    for s in spans:
        n, total, own = out.get(s.name, (0, 0, 0))
        d = s.end - s.start
        out[s.name] = (n + 1, total + d, own + d - child_ns.get(s.id, 0))
    return out


# --------------------------------------------------------------- counters

_counts: dict = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    """The counter ``name``: 0 where nothing counted it since the last
    :func:`reset_counters`."""
    return _counts.get(name, 0)


def reset_counters() -> None:
    """Zero every counter."""
    _counts.clear()


# ---------------------------------------------------------- trace capture

@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Context manager: capture a profiler trace; yields the trace
    directory, into which a chrome trace (``*.trace.json.gz``) is written
    on exit.  Without ``log_dir`` the directory is a new temporary one,
    which the caller removes."""
    from torch.profiler import ProfilerActivity, profile

    d = log_dir or tempfile.mkdtemp(prefix="linkpred_trace_")
    os.makedirs(d, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield d
    prof.export_chrome_trace(
        os.path.join(d, f"linkpred.{os.getpid()}.{id(prof)}.trace.json.gz"))


def _durations(trace_dir: str) -> dict:
    """{(op name, ran on the card): total ms} over the traces in
    ``trace_dir``: a host op and a kernel of one name are two rows."""
    files = glob.glob(os.path.join(trace_dir, "**", "*.trace.json*"),
                      recursive=True)
    agg: dict = {}
    for f in files:
        opener = gzip.open if f.endswith(".gz") else open
        with opener(f, "rt") as fh:
            data = json.load(fh)
        for e in data.get("traceEvents", []):
            if e.get("ph") == "X":
                key = (e.get("name", "?"), e.get("cat") in _DEVICE_CATS)
                agg[key] = agg.get(key, 0.0) + e.get("dur", 0) / 1e3
    return agg


def summarize_trace(trace_dir: str,
                    top: int = 25) -> list[tuple[str, float, bool]]:
    """Aggregate op durations from a captured trace.

    Returns [(op_name, total_ms, ran_on_card)] sorted descending: device
    work (kernels, copies, memsets) and host spans in separate rows; the
    kernel rows (e.g. ``tail_onepass``) give the kernels' device time.
    """
    agg = _durations(trace_dir)
    return sorted(((name, ms, dev) for (name, dev), ms in agg.items()),
                  key=lambda row: -row[1])[:top]


def profile_fn(fn: Callable, *args, top: int = 25, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a trace; returns (result, summary)
    and removes the trace it wrote.

    Where there is a card, the call ends with ``torch.cuda.synchronize()``
    inside the trace, and a trace holding no device event raises (a
    profiler session on the card has been seen to record none): the
    summary is never a host-only table passed off as the device's."""
    d = tempfile.mkdtemp(prefix="linkpred_trace_")
    try:
        with trace(d):
            result = fn(*args, **kwargs)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        if torch.cuda.is_available() and not any(
                dev for _, dev in _durations(d)):
            raise RuntimeError(
                "profile_fn: the profiler recorded no device event")
        return result, summarize_trace(d, top=top)
    finally:
        shutil.rmtree(d, ignore_errors=True)
