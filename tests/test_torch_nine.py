"""The nine-metric whole-graph pass (``predict_links_multi`` with the nine
metrics of the reference paper's evaluation) on the CPU: the span
``select.metric`` and the counters ``select.full_sort``,
``api.merge_rows`` and ``api.rows_back`` against the plan's passes and
segments, the answers bit-equal with the span, without it and with the
recorder on, and the pass on a small Graph500 graph against the
benchmark's plain float64 reference under the nine-metric mix's
per-metric limits."""
import contextlib
import json
import os
import sys

import numpy as np
import pytest

from conftest import random_graph

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import convert
from linkpred_tpu_torch.predict import api, plan, scoring
from linkpred_tpu_torch.utils import profiling
from linkpred_tpu_torch.utils.profiling import counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lpbench_json(*parts):
    with open(os.path.join(ROOT, "lpbench", *parts)) as fh:
        return json.load(fh)


MIX = _lpbench_json("traffic", "allmetrics.json")
NINE = tuple(MIX["metrics"])


@pytest.fixture(autouse=True)
def _recorder():
    """Every test starts and ends with recording off and nothing kept."""
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _port(gr):
    return convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                     gr.n, gr.m)


def _passes(p):
    return [p, *api._sub_plans(p)]


def _segments(p) -> list:
    """Each pass's segment count at nine metrics."""
    return [scoring._segments(len(q.tile_start) - 1, q.cap, len(NINE),
                              "cpu")[0] for q in _passes(p)]


def _selections(p) -> int:
    """Selections of one metric in one scoring of the plan: a segmented
    pass's segments and their merge, one for every other pass."""
    return sum(s + 1 if s > 1 else 1 for s in _segments(p))


def _recorded(fn):
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.drain()


def _graph500(scale: int = 10, d1: int = 16):
    """The benchmark's configuration cut to ``scale`` with hub threshold
    ``d1``: ``(graph500 graph, k, program graph, d1)``."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from lpbench import graph500
    from lpbench.drive import _program_graph

    cfg = _lpbench_json("configs", "lhub9-rmat23.json")
    cfg.update(scale=scale, min_degree1=d1)
    g, k = graph500.make_graph(cfg, 2147483659, "cpu")
    return g, k, _program_graph(g), d1


def _small_segments(mp):
    """Tiles of 1,024 lanes at scale 10, and seg lanes 8192 * 12 // 44 =
    2,234 at nine metrics: the main pass's 7 tiles select over 4 segments
    of 2, the hub sub-plan's one tile over one."""
    mp.setattr(plan, "AUTO_CAP_MIN", 1024)
    mp.setattr(scoring, "SEG_LANES", 8192)


@pytest.fixture
def segmented(monkeypatch):
    """A packed LHub plan whose main pass selects over several segments at
    nine metrics and whose other passes over one; and a call on it."""
    _small_segments(monkeypatch)
    _, _, y, d1 = _graph500()
    p = plan.build_plan(y, d1, device="cpu")
    segs = _segments(p)
    assert segs[0] > 1 and len(segs) > 1 and set(segs[1:]) == {1}, \
        "test premise"

    def call():
        return lt.predict_links_multi(
            y, NINE, d1, plan=p, device="cpu",
            options=lt.PredictOptions(max_edges=300))

    return p, call


def test_select_metric_spans_one_per_selection(segmented):
    p, call = segmented
    profiling.reset_counters()
    _, spans = _recorded(call)
    by_id = {s.id: s for s in spans}
    sel = [s for s in spans if s.name == "select.metric"]
    # a warm-up scoring and the timed one
    assert len(sel) == 2 * len(NINE) * _selections(p)
    assert len(sel) == 2 * 9 * ((_segments(p)[0] + 1)
                                + len(_passes(p)) - 1)
    parents = [by_id[s.parent].name for s in sel]
    assert set(parents) == {"scan.select", "scan.merge_segments"}
    segmented_passes = sum(s > 1 for s in _segments(p))
    assert parents.count("scan.merge_segments") == \
        2 * len(NINE) * segmented_passes
    for s in sel:
        up = by_id[s.parent]
        assert up.start <= s.start <= s.end <= up.end
    # no buffer here reaches the pack's size: every selection sorts
    assert counter("select.full_sort") == len(sel)
    assert counter("select.packed_arm") == counter("select.sort_arm") == 0
    assert counter("scan.segments") == 2 * sum(
        s for s in _segments(p) if s > 1)


def test_full_sort_counts_the_selections_that_do_not_try_the_pack(
        rng, monkeypatch):
    """Where a pass's buffer takes the survivor pack, its selections are
    counted by the pack's arms and not as full sorts."""
    gp = _port(random_graph(rng, 300, 8))
    monkeypatch.setattr(scoring, "SEL_PACK_MIN", 1 << 12)
    p = plan.build_plan(gp, 0, 1024, device="cpu")
    profiling.reset_counters()
    _, spans = _recorded(lambda: lt.predict_links_multi(
        gp, NINE, min_degree1=0, plan=p, device="cpu",
        options=lt.PredictOptions(max_edges=100)))
    sel = sum(s.name == "select.metric" for s in spans)
    tried = counter("select.packed_arm") + counter("select.sort_arm")
    assert tried > 0, "test premise: a selection tried the pack"
    assert counter("select.full_sort") + tried == sel
    assert sel == 2 * len(NINE) * _selections(p)


def test_rows_back_counts_the_rows_merged(segmented, monkeypatch):
    p, call = segmented
    tops = []
    real = api.score_tiles
    monkeypatch.setattr(api, "score_tiles",
                        lambda *a, **kw: tops.append(real(*a, **kw))
                        or tops[-1])
    profiling.reset_counters()
    res = call()
    timed = tops[-len(_passes(p)):]
    rows = sum(int(t.scores.shape[1]) for t in timed)
    assert not p.host_src.size, "test premise: every row is a pass's"
    # every pass's winners enter the device merge; only its rows come back
    assert counter("api.merge_rows") == len(NINE) * rows > 0
    assert counter("api.rows_back") == sum(len(res[m]) for m in NINE)
    for name in NINE:
        assert 0 < len(res[name]) <= min(rows, 300)


def test_answers_bit_equal_with_and_without_the_span(segmented, monkeypatch):
    p, call = segmented
    assert profiling.span("select.metric") is profiling.span("x"), \
        "with the recorder off the span is the shared no-op"
    off = call()
    on, spans = _recorded(call)
    assert any(s.name == "select.metric" for s in spans)
    real = scoring.span
    monkeypatch.setattr(scoring, "span", lambda name: (
        contextlib.nullcontext() if name == "select.metric"
        else real(name)))
    without = call()
    for name in NINE:
        for f in ("u", "v", "score"):
            a = getattr(without[name], f)
            for b in (getattr(off[name], f), getattr(on[name], f)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")


# ------------------------------------ the deployment against its reference

@pytest.fixture(scope="module")
def judged():
    """The nine-metric call on a scale-10 Graph500 graph (LHub, d1 16,
    which skips the intermediates of higher degree), its main pass
    selecting over several segments, judged by the benchmark's judge
    against the float64 reference."""
    g, k, y, d1 = _graph500()
    from lpbench import judge

    with pytest.MonkeyPatch.context() as mp:
        _small_segments(mp)
        p = plan.build_plan(y, d1, device="cpu")
        premise = dict(segments=_segments(p)[0],
                       skipped=int((y.degrees > d1).sum()))
        res = lt.predict_links_multi(y, NINE, d1, plan=p, device="cpu",
                                     options=lt.PredictOptions(max_edges=k))
    answer = {m: (r.u, r.v, r.score) for m, r in res.items()}
    numbers = judge.judge_whole_graph(g, MIX, d1, k, [answer])
    return premise, res, numbers, judge.flat_limits(MIX), judge.PER_METRIC


@pytest.mark.parametrize("metric", NINE)
def test_nine_metrics_against_the_plain_reference(judged, metric):
    premise, res, numbers, limits, per_metric = judged
    assert premise["segments"] > 1 and premise["skipped"] > 0, premise
    assert len(res[metric]) > 0
    for number in per_metric:
        check = f"{number}.{metric}"
        assert numbers[check] <= limits[check], (check, numbers[check])
    assert numbers[f"count_off.{metric}"] == 0
    assert numbers[f"invalid_rows.{metric}"] == 0
