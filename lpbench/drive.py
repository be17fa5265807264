"""The one window loop every traffic mix runs through, by its ``kind``:

* ``whole_graph``: set-up builds the whole graph's plan once
  (``predict.plan.build_plan``) and makes one untimed call; the window
  then calls ``predict_links_multi(..., plan=plan)`` back to back, one
  caller, one pass for the traffic's ``metric`` or all of its
  ``metrics``, each metric's top k on the host when it returns; a call's
  program clocks are the sums over its metrics' results, and each
  metric's answer is judged;
* ``per_user``: a closed loop of one outstanding request; each request
  draws ``users`` distinct vertices of degree >= 1 from the seed, calls
  ``predict_links(..., sources=users)`` with no plan and then
  ``top_per_source``; a request is timed from when it is sent until the
  per-user rows are on the host.

The window measures at least ``seconds`` and ends with the call that
straddles that mark, so every call it counts is whole and no time of it
is idle.  A traced run (``trace=True``) profiles one slice of the window,
at least ``trace_seconds`` of whole calls, from the first call after half
of ``seconds``.  The calls before it run with no profiler started in the
process, and the per-layer readers read those; a session may leave the
process slower (CUPTI stays loaded), so the calls after the slice are
neither traced nor read.  The walls of the three kinds of call are
printed side by side.  Once the window has
closed, the device's peak memory is read, the program's state is freed,
and the answers are judged against the reference.
"""
from __future__ import annotations

import dataclasses
import gc
import os
import random
import sys
import time
import traceback

import numpy as np
import torch

from . import graph500, judge, roofline
from .reference import WEIGHTED
from .trace import Capture, device_events

__all__ = ["Record", "run"]


@dataclasses.dataclass
class Record:
    """What one run measured, for the metric readers."""
    kind: str
    seconds: float                  # the window's length, whole calls
    setup_s: float
    calls: list                     # per call: dict(wall_s, ok, traced
    #                                 (None before the slice, "slice",
    #                                 "after"), the program's scoring_ms,
    #                                 time_ms, transfer_ms; a traced serve's
    #                                 plan_s)
    attempted: int
    failed: int
    edges: int                      # directed edges of the graph scored
    plan_s: float = None            # set-up's whole-graph plan
    passes: list = None             # the plan's passes (roofline counts)
    n_metrics: int = 1              # metrics a pass scores
    n_weighted: int = 0             # of them, those summing a weight
    kind_of_card: str = ""
    events: list = None             # the traced slice's chrome events
    traced_calls: int = 0
    numbers: dict = None
    memory_peak_bytes: int = 0


def _say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _sub_plans(plan) -> list:
    """The plan's sub-plans in scoring order: the side stream, the hub
    sub-plan and theirs."""
    out = []
    for q in (plan.side_plan, plan.huge_plan):
        if q is not None:
            out.append(q)
            out.extend(_sub_plans(q))
    return out


def _pass_info(plan, max_edges: int, n_metrics: int, device_bytes: int):
    """The plan's passes as the roofline readers count them: each pass's
    non-empty tiles' filled lanes, its degree width, and whether its
    selection takes the survivor pack.  A pass whose selection runs by
    segments packs only where the merge of the segments' winners does: it
    then has ``merge_pack``, that selection's lanes and survivors."""
    all_slots = plan.total_slots + plan.huge_slots + (
        plan.side_plan.total_slots if plan.side_plan else 0)
    k = roofline.exact_k(all_slots, max_edges)
    out = []
    for p in [plan, *_sub_plans(plan)]:
        bounds = np.asarray(p.tile_start, dtype=np.int64)
        t_pad = bounds.shape[0] - 1
        nonempty = bounds[1:] > bounds[:-1]
        if p.packed:
            lanes = (bounds[1:] - bounds[:-1])[nonempty]
        else:
            work = np.zeros(p.fe_work.shape[0] + 1, dtype=np.int64)
            np.cumsum(p.fe_work, out=work[1:])
            lanes = (work[bounds[1:]] - work[bounds[:-1]])[nonempty]
        buffer = t_pad * p.cap
        kk = min(k, buffer)
        seg = roofline.segments(t_pad, p.cap, n_metrics, device_bytes)
        out.append(dict(
            packed=bool(p.packed), wide=not p.deg16, cap=int(p.cap),
            tiles=int(nonempty.sum()), lanes=lanes, filled=int(lanes.sum()),
            kk=int(kk), packs=roofline.selection_packs(buffer, kk, seg)))
        if seg > 1:
            # each segment keeps its top min(k, its lanes); one selection
            # a metric merges them
            winners = seg * min(k, -(-t_pad // seg) * p.cap)
            if roofline.selection_packs(winners, min(k, winners), 1):
                out[-1]["merge_pack"] = dict(filled=winners,
                                             kk=min(k, winners))
    return out


def _plan_line(plan, passes) -> str:
    """The path the plan takes: each pass's stream, tiles, cap, slots and
    whether its selection takes the survivor pack (K2)."""
    names = ["main"] + [
        "side" if q is plan.side_plan else "hub" if q is plan.huge_plan
        else "sub" for q in _sub_plans(plan)]
    parts = [f"{name}: {'packed' if p.packed else 'edge stream'}, "
             f"{p.num_tiles} tiles of cap {p.cap}, {p.total_slots} slots, "
             f"deg16 {p.deg16}, pack {'on' if i['packs'] else 'off'}"
             + (", merge pack on" if "merge_pack" in i else "")
             for name, p, i in zip(names, [plan, *_sub_plans(plan)], passes)]
    parts.append(f"host hubs {plan.host_src.size}")
    return "plan: " + "; ".join(parts)


def _clocks(results) -> dict:
    """The program's own clocks of a call, summed over its
    ``PredictResult``s (one a metric): ms."""
    return {name: sum(getattr(r, name) for r in results)
            for name in ("scoring_ms", "time_ms", "transfer_ms")}


def _program_graph(g: graph500.Graph):
    from linkpred_tpu_torch.graph import CSRGraph

    offsets, indices, degrees = g.host_csr()
    return CSRGraph(offsets=offsets, indices=indices, degrees=degrees,
                    weights=None, n=g.n, m=g.m)


class _Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from a seed."""

    def __init__(self, size: int, seed: int):
        self.size, self.items, self.seen = size, [], 0
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


def _window(call, seconds: float, trace: bool, trace_seconds: float,
            cuda: bool):
    """Run ``call()`` back to back for at least ``seconds``, and in a
    traced run until its slice has closed; returns (calls, window
    seconds, capture or None)."""
    calls, cap = [], None
    t0 = now = time.perf_counter()
    while True:
        if trace and cap is None and calls and now - t0 >= seconds / 2:
            Capture.warm_up(cuda)
            cap = Capture(cuda=cuda)
            cap.start()
            traced_from = time.perf_counter()
        rec = call()
        rec["traced"] = None if cap is None else "after" if cap.done \
            else "slice"
        calls.append(rec)
        now = time.perf_counter()
        if rec["traced"] == "slice" and now - traced_from >= trace_seconds:
            cap.stop()
        if now - t0 >= seconds and (not trace or (cap and cap.done)):
            break
    return calls, now - t0, cap


def _walls(calls) -> str:
    """The mean wall of the calls before the traced slice, in it, and
    after it."""
    parts = []
    for tag, name in ((None, "before the slice"), ("slice", "traced"),
                      ("after", "after the slice")):
        w = [c["wall_s"] for c in calls if c["ok"] and c["traced"] == tag]
        if w:
            parts.append(f"{name} {sum(w) / len(w):.4f} s ({len(w)})")
    return "call wall: " + ", ".join(parts)


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device="cuda") -> Record:
    """One run of a cell: set-up, the window, the judge."""
    t_setup = time.perf_counter()
    device = torch.device(device)
    cuda = device.type == "cuda"
    from linkpred_tpu_torch.predict import api
    from linkpred_tpu_torch.predict.api import (PredictOptions,
                                                predict_links,
                                                predict_links_multi,
                                                top_per_source)
    from linkpred_tpu_torch.predict.plan import build_plan

    gdev, k = graph500.make_graph(cfg, seed, device)
    y = _program_graph(gdev)
    edges = gdev.m
    # the reference's copy waits on the host while the program runs
    ghost = graph500.Graph(gdev.offsets.cpu(), gdev.indices.cpu(), gdev.n)
    del gdev
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _say(f"graph: n {y.n}, {edges} directed edges after removal, k {k}")

    names = judge.metric_names(traffic)
    d1 = int(cfg["min_degree1"])
    kind = traffic["kind"]
    failed = []
    plan_times = []
    plan_s = None
    passes = None
    # the card's memory sizes the selection's segments (roofline counts)
    dev_bytes = (torch.cuda.get_device_properties(device).total_memory
                 if cuda else 16 << 30)

    def failure():
        if not failed:
            _say("a call raised:\n" + traceback.format_exc())
        failed.append(1)

    if kind == "whole_graph":
        t = time.perf_counter()
        plan = build_plan(y, d1, device=device)
        plan_s = time.perf_counter() - t
        want = cfg.get("whole_graph_stream")
        got = "packed" if plan.packed else "edge stream"
        if want and want != got:
            raise RuntimeError(f"the configuration's whole-graph plan takes "
                               f"the {want}, this one the {got}")
        opts = PredictOptions(max_edges=k)
        passes = _pass_info(plan, k, len(names), dev_bytes)
        print(_plan_line(plan, passes), flush=True)
        sample = _Reservoir(int(traffic["checked_calls"]), seed)
        predict_links_multi(y, names, d1, options=opts, plan=plan,
                            device=device)

        def call():
            t = time.perf_counter()
            try:
                with torch.profiler.record_function("lpbench.predict_links"):
                    res = predict_links_multi(y, names, d1, options=opts,
                                              plan=plan, device=device)
            except Exception:       # a failed pass counts, the window goes on
                failure()
                return dict(wall_s=time.perf_counter() - t, ok=False)
            wall = time.perf_counter() - t
            sample.offer({m: (r.u, r.v, r.score) for m, r in res.items()})
            return dict(wall_s=wall, ok=True, **_clocks(res.values()))

    elif kind == "per_user":
        metric = traffic["metric"]
        n_users = int(traffic["users"])
        max_edges = n_users * int(traffic["edges_per_user"])
        per_user = int(traffic["per_user"])
        opts = PredictOptions(max_edges=max_edges)
        active = np.nonzero(y.degrees > 0)[0]
        answers = []
        real_plan = api.build_plan
        plans = []

        def timed_plan(*a, **kw):
            t = time.perf_counter()
            try:
                with torch.profiler.record_function("lpbench.build_plan"):
                    return real_plan(*a, **kw)
            finally:
                plan_times.append(time.perf_counter() - t)

        def kept_plan(*a, **kw):
            plans[:] = [real_plan(*a, **kw)]
            return plans[0]

        def request(rng, keep: bool):
            users = np.sort(rng.choice(active, size=n_users, replace=False))
            t = time.perf_counter()
            n_plans = len(plan_times)
            try:
                with torch.profiler.record_function("lpbench.predict_links"):
                    res = predict_links(y, metric, d1, options=opts,
                                        sources=users, device=device)
                with torch.profiler.record_function("lpbench.top_per_source"):
                    top = top_per_source(res, per_user)
            except Exception:       # a failed request counts as missing
                failure()
                return dict(wall_s=time.perf_counter() - t, ok=False)
            wall = time.perf_counter() - t
            if keep:
                answers.append((users, (top.u, top.v, top.score)))
            rec = dict(wall_s=wall, ok=True, **_clocks([res]))
            if len(plan_times) > n_plans:
                rec["plan_s"] = plan_times[-1]
            return rec

        warm = np.random.default_rng([int(seed), 1])
        api.build_plan = kept_plan
        try:
            for _ in range(int(traffic["warmup_requests"])):
                request(warm, keep=False)
        finally:
            api.build_plan = real_plan
        if failed:
            raise RuntimeError("a warm-up request failed")
        print("last warm-up request's " + _plan_line(plans[0], _pass_info(
            plans[0], max_edges, 1, dev_bytes)), flush=True)
        plans.clear()
        rng = np.random.default_rng([int(seed), 0])
        if trace:
            api.build_plan = timed_plan

        def call():
            return request(rng, keep=True)
    else:
        raise KeyError(f"no traffic kind {kind!r}")

    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    _say(f"set-up {setup_s:.3f} s" + (f" (plan {plan_s:.3f} s)"
                                       if plan_s is not None else ""))
    try:
        calls, window_s, cap = _window(call, seconds, trace,
                                       float(traffic["trace_seconds"]), cuda)
    finally:
        if kind == "per_user":
            api.build_plan = real_plan
    if cuda:
        torch.cuda.synchronize()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    rec = Record(kind=kind, seconds=window_s, setup_s=setup_s, calls=calls,
                 attempted=len(calls), failed=len(failed), edges=edges,
                 plan_s=plan_s, passes=passes, n_metrics=len(names),
                 n_weighted=sum(m in WEIGHTED for m in names),
                 kind_of_card=torch.cuda.get_device_name(device)
                 if cuda else "cpu",
                 traced_calls=sum(c["traced"] == "slice" for c in calls),
                 memory_peak_bytes=peak)
    _say(f"window {window_s:.3f} s, {len(calls)} calls, "
         f"{len(failed)} failed")
    if trace:
        _say(_walls(calls))

    # the program's state goes before the reference runs
    if kind == "whole_graph":
        del plan
    del y
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if cap is not None:
        base = os.environ.get("TMPDIR") or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), ".cache")
        os.makedirs(base, exist_ok=True)
        t = time.perf_counter()
        rec.events = cap.export(os.path.join(base, "lpbench_trace.json"))
        _say(f"trace: {len(rec.events)} events of {rec.traced_calls} calls, "
             f"read in {time.perf_counter() - t:.3f} s")
        if cuda and not device_events(rec.events):
            raise RuntimeError("the profiler recorded no device event")

    t = time.perf_counter()
    g = graph500.Graph(ghost.offsets.to(device), ghost.indices.to(device),
                       ghost.n)
    if kind == "whole_graph":
        numbers = judge.judge_whole_graph(g, traffic, d1, k, sample.items)
    else:
        numbers = judge.judge_served(
            g, metric, d1, answers, max_edges=max_edges, per_user=per_user,
            band=float(traffic["limits"]["rank_gap"]))
    numbers["missing"] = len(failed)
    rec.numbers = numbers
    _say(f"reference {time.perf_counter() - t:.3f} s")
    return rec
