"""The program's spans and counters (``linkpred_tpu_torch/utils/profiling.py``)
on the CPU: the off path, nesting, parent and call ids, self time, every
span of a ``predict_links`` call on a packed plan, on an edge-stream plan
and in serving mode, the tile counter against the plan, answers with
recording on and off, the spans as a profiler session's annotations on
its clock, and the benchmark's runs, which never turn recording on.
"""
import json
import os
import sys
import time

import numpy as np
import pytest

from conftest import powerlaw_graph

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import convert
from linkpred_tpu_torch.predict import api, plan, scoring
from linkpred_tpu_torch.utils import profiling
from linkpred_tpu_torch.utils.profiling import counter, span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PLAN = {"plan.build", "plan.firsthop", "plan.route"}
API = {"api.call", "api.memcheck", "api.upload", "api.warmup", "api.score",
       "api.copy_back", "api.merge"}
TILES = {"scan.pass", "scan.tile", "tile.gather", "tile.sort", "tile.k1",
         "scan.select", "select.metric"}
EVERY = (PLAN | API | TILES | {"plan.expand", "plan.emit", "plan.edge_stream",
                               "api.host_hubs", "api.top_per_source",
                               "scan.merge_segments", "scan.side"})


@pytest.fixture(autouse=True)
def _recorder():
    """Every test starts and ends with recording off and nothing kept."""
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _graph(rng, n=400, m=2400):
    gr = powerlaw_graph(rng, n, m)
    return convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                     gr.n, gr.m)


def _passes(p):
    return [p, *api._sub_plans(p)]


def _nonempty_tiles(p) -> int:
    return sum(int((np.diff(np.asarray(q.tile_start)) > 0).sum())
               for q in _passes(p))


def _recorded(fn):
    """``fn()`` with recording on: (its result, the spans it recorded)."""
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.drain()


def _names(spans) -> set:
    return {s.name for s in spans}


def test_off_path_records_nothing_and_shares_one_object(rng):
    a, b = span("a"), span("b")
    assert a is b, "the off path hands out one shared object"
    with a:
        with b:
            pass
    with pytest.raises(ValueError, match="passes through"):
        with span("c"):
            raise ValueError("passes through")
    gp = _graph(rng, 200, 800)
    lt.predict_links(gp, "jaccard_coefficient", min_degree1=0, cap=256,
                     device="cpu", options=lt.PredictOptions(max_edges=50))
    assert profiling.drain() == []


def test_nesting_parents_calls_and_self_time():
    def work(ms):
        t = time.perf_counter() + ms / 1e3
        while time.perf_counter() < t:
            pass

    profiling.enable()
    with span("root") as root:
        work(2)
        with span("child") as c1:
            work(3)
            with span("leaf") as leaf:
                work(1)
        with span("child") as c2:
            work(1)
    with span("other") as other:
        pass
    profiling.disable()
    with span("after"):
        pass
    spans = profiling.drain()
    assert [s.name for s in spans] == ["leaf", "child", "child", "root",
                                      "other"], "closing order"
    assert (root.parent, c1.parent, leaf.parent, c2.parent) == \
        (None, root.id, c1.id, root.id)
    assert {s.call for s in (root, c1, leaf, c2)} == {root.id}
    assert other.parent is None and other.call == other.id != root.id
    assert len({s.id for s in spans}) == 5
    for s in (c1, leaf, c2):
        assert root.start <= s.start <= s.end <= root.end
    summary = profiling.summarize_spans(spans)
    dur = {s.id: s.end - s.start for s in spans}
    assert summary["root"] == (1, dur[root.id],
                               dur[root.id] - dur[c1.id] - dur[c2.id])
    assert summary["child"] == (2, dur[c1.id] + dur[c2.id],
                                dur[c1.id] - dur[leaf.id] + dur[c2.id])
    assert summary["leaf"] == (1, dur[leaf.id], dur[leaf.id])
    assert summary["root"][2] >= 2e6, "the root's own 2 ms of work"
    assert profiling.drain() == [], "drain clears"


def test_counters_count_read_and_reset():
    profiling.reset_counters()
    assert counter("t.x") == 0
    profiling.count("t.x")
    profiling.count("t.x", 4)
    assert counter("t.x") == 5
    profiling.reset_counters()
    assert counter("t.x") == 0


def _check_call(spans, p):
    """One predict_links call's spans: one root, every span in its call,
    and the tile spans against the plan and the counter."""
    roots = [s for s in spans if s.parent is None]
    assert [s.name for s in roots] == ["api.call"]
    assert {s.call for s in spans} == {roots[0].id}
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start <= s.start <= s.end <= up.end, s.name
    for s in spans:
        if s.name.startswith("tile."):
            assert by_id[s.parent].name == "scan.tile", s.name
        if s.name == "scan.tile":
            assert by_id[s.parent].name == "scan.pass"
        if s.name in ("plan.firsthop", "plan.route", "plan.expand",
                      "plan.emit", "plan.edge_stream"):
            assert by_id[s.parent].name == "plan.build", s.name
    tiles = sum(s.name == "scan.tile" for s in spans)
    # one warm-up scoring and one timed scoring of every pass
    assert tiles == counter("scan.tiles") == 2 * _nonempty_tiles(p) > 0
    passes = sum(s.name == "scan.pass" for s in spans)
    assert passes == 2 * len(_passes(p))


def test_spans_of_a_packed_plan(rng, monkeypatch):
    gp = _graph(rng)
    # a segmented selection: 1 metric, seg lanes = 2048 * 12 // 12 = 8 tiles
    monkeypatch.setattr(scoring, "SEG_LANES", 2048)
    p = plan.build_plan(gp, 0, 256, device="cpu")
    assert p.packed and p.huge_plan is not None, "test premise"
    profiling.reset_counters()
    _, spans = _recorded(lambda: lt.predict_links(
        gp, "jaccard_coefficient", min_degree1=0, cap=256, device="cpu",
        options=lt.PredictOptions(max_edges=300)))
    names = _names(spans)
    assert PLAN | API | TILES | {"plan.expand", "plan.emit",
                                 "scan.merge_segments"} <= names
    assert "plan.edge_stream" not in names
    assert counter("scan.segments") > 0
    # the hub sub-plan's plan.build sits inside the main plan's routing
    builds = [s for s in spans if s.name == "plan.build"]
    by_id = {s.id: s for s in spans}
    assert len(builds) == 2
    assert sorted(by_id[s.parent].name for s in builds) == ["api.call",
                                                            "plan.route"]
    _check_call(spans, p)


def test_spans_of_an_edge_stream_plan(rng, monkeypatch):
    gp = _graph(rng)
    monkeypatch.setattr(plan, "SLOT_BUDGET", 0)
    monkeypatch.setattr(plan, "HUGE_DEVICE_MAX", 1)
    p = plan.build_plan(gp, 0, 256, device="cpu")
    assert not p.packed and p.host_src.size, "test premise"
    profiling.reset_counters()
    _, spans = _recorded(lambda: lt.predict_links(
        gp, "adamic_adar", min_degree1=0, cap=256, device="cpu",
        options=lt.PredictOptions(max_edges=300)))
    names = _names(spans)
    assert PLAN | API | TILES | {"plan.edge_stream", "api.host_hubs"} \
        <= names
    assert not names & {"plan.expand", "plan.emit"}
    _check_call(spans, p)


def test_spans_in_serving_mode(rng):
    gp = _graph(rng)
    users = np.sort(rng.choice(np.nonzero(gp.degrees > 0)[0], 16,
                               replace=False))
    p = plan.build_plan(gp, 0, sources=users, device="cpu")
    profiling.reset_counters()
    res, spans = _recorded(lambda: lt.predict_links(
        gp, "adamic_adar", min_degree1=0, sources=users, device="cpu",
        options=lt.PredictOptions(max_edges=160)))
    _check_call(spans, p)
    assert PLAN | API | TILES <= _names(spans)
    top, more = _recorded(lambda: lt.top_per_source(res, 5))
    assert [s.name for s in more] == ["api.top_per_source"]
    assert more[0].parent is None and more[0].call == more[0].id
    # a plan built directly is a call of its own
    _, direct = _recorded(lambda: plan.build_plan(
        gp, 0, sources=users, device="cpu"))
    root = [s for s in direct if s.parent is None]
    assert [s.name for s in root] == ["plan.build"]
    assert {s.call for s in direct} == {root[0].id}
    assert {"plan.firsthop", "plan.route"} <= _names(direct)


def test_every_span_named_in_the_module_docs_is_produced(rng, monkeypatch):
    """The union over the four kinds of call is every span the program
    has: a span nothing produces, or one produced and not listed, fails."""
    gp = _graph(rng)
    users = np.sort(rng.choice(np.nonzero(gp.degrees > 0)[0], 16,
                               replace=False))
    opts = lt.PredictOptions(max_edges=300)
    seen = set()
    monkeypatch.setattr(scoring, "SEG_LANES", 2048)
    _, s1 = _recorded(lambda: lt.predict_links(
        gp, "cn", min_degree1=0, cap=256, device="cpu", options=opts))
    # a request whose plan has a wide-degree side plan
    from test_torch_serve_side import D1, USERS, port_hub_graph

    _, side = _recorded(lambda: lt.predict_links(
        port_hub_graph(), "cn", min_degree1=D1, sources=USERS, device="cpu",
        options=opts))
    assert "scan.side" in _names(side)
    monkeypatch.setattr(plan, "SLOT_BUDGET", 0)
    monkeypatch.setattr(plan, "HUGE_DEVICE_MAX", 1)
    _, s2 = _recorded(lambda: lt.predict_links(
        gp, "cn", min_degree1=0, cap=256, device="cpu", options=opts))
    _, s3 = _recorded(lambda: lt.top_per_source(lt.predict_links(
        gp, "cn", min_degree1=0, sources=users, device="cpu",
        options=opts), 3))
    for spans in (s1, side, s2, s3):
        seen |= _names(spans)
    assert seen == EVERY


@pytest.mark.parametrize("slot_budget", [None, 0])
def test_answers_are_bit_equal_with_recording_on_and_off(rng, monkeypatch,
                                                         slot_budget):
    gp = _graph(rng)
    monkeypatch.setattr(plan, "SLOT_BUDGET", slot_budget)
    names = ["jaccard_coefficient", "adamic_adar"]

    def call():
        return lt.predict_links_multi(gp, names, min_degree1=0, cap=256,
                                      device="cpu",
                                      options=lt.PredictOptions(
                                          max_edges=500))

    off = call()
    on, spans = _recorded(call)
    assert spans
    for name in names:
        for f in ("u", "v", "score"):
            a, b = getattr(off[name], f), getattr(on[name], f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, f)


@pytest.mark.parametrize("recording", [True, False])
def test_spans_are_profiler_annotations_on_its_clock(rng, tmp_path,
                                                     recording):
    """Under a profiler session each span is a ``user_annotation`` of its
    name; a recorded span's start, placed on the wall clock through the
    anchor, lies within 1 ms of the annotation's start in the chrome
    trace (``ts`` us after ``baseTimeNanoseconds``)."""
    from torch.profiler import ProfilerActivity, profile

    gp = _graph(rng, 200, 800)
    p = plan.build_plan(gp, 0, 256, device="cpu")
    if recording:
        profiling.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        lt.predict_links(gp, "cn", min_degree1=0, plan=p, device="cpu",
                         options=lt.PredictOptions(max_edges=100))
    profiling.disable()
    spans = profiling.drain()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        data = json.load(fh)
    marks = sorted((e for e in data["traceEvents"]
                    if e.get("cat") == "user_annotation"),
                   key=lambda e: float(e["ts"]))
    got = [e["name"] for e in marks]
    assert set(got) == API | TILES, "every span a call makes, no other"
    if not recording:
        assert spans == []
        return
    spans.sort(key=lambda s: s.start)
    assert [s.name for s in spans] == got
    base = int(data["baseTimeNanoseconds"])
    off_ms = [abs(profiling.wall_ns(s.start) - (float(e["ts"]) * 1e3 + base))
              / 1e6 for s, e in zip(spans, marks)]
    assert max(off_ms) < 1.0, max(off_ms)


# ------------------------------------------------------- the benchmark

@pytest.fixture
def _lpbench(monkeypatch, tmp_path):
    if ROOT not in sys.path:
        monkeypatch.syspath_prepend(ROOT)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from lpbench import drive

    enabled = []
    real = profiling.enable
    monkeypatch.setattr(profiling, "enable",
                        lambda: enabled.append(1) or real())
    return drive, enabled


def _cfg(name, **kw):
    with open(os.path.join(ROOT, "lpbench", *name)) as fh:
        out = json.load(fh)
    out.update(kw)
    return out


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("config,mix,shrink", [
    ("lhub-rmat23", "batch", dict(scale=9, min_degree1=16)),
    ("ihub-rmat18", "batch", dict(scale=8)),
    ("ihub-rmat18", "serve", dict(scale=8)),
])
def test_the_benchmark_never_turns_recording_on(_lpbench, monkeypatch,
                                                config, mix, shrink, trace):
    """A run of the benchmark's drive, traced or not, leaves recording off;
    a traced run's profiler slice holds the program's spans as
    annotations, so its idle gaps are named by them."""
    drive, enabled = _lpbench
    cfg = _cfg(("configs", f"{config}.json"), **shrink)
    traffic = _cfg(("traffic", f"{mix}.json"), trace_seconds=0.05)
    if mix == "serve":
        traffic.update(users=8, warmup_requests=1)
    elif config.startswith("ihub"):
        # the edge stream at a tiny size, as the configuration's scale has
        monkeypatch.setattr(plan, "SLOT_BUDGET", 0)
    rec = drive.run(cfg, traffic, 2147483659, 0.3, bool(trace),
                    device="cpu")
    assert enabled == [] and not profiling._on
    assert profiling.drain() == []
    assert rec.failed == 0 and rec.attempted >= 1
    if trace:
        marks = {e["name"] for e in rec.events
                 if e.get("cat") == "user_annotation"}
        assert {"api.call", "api.score", "scan.tile", "tile.k1",
                "api.merge"} <= marks
        if mix == "serve":
            assert {"plan.build", "plan.firsthop",
                    "api.top_per_source"} <= marks
