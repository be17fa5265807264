"""The API's warm-up on the CPU: ``predict_links_multi`` runs the untimed
warm-up pass only on a plan's first scoring of a shape (its metrics, its k,
min_score and max_factor2, under a mesh the mesh's size) on a device.  A
second call with the same plan and shape scores the plan once: one
``scan.pass`` span a pass, one ``scan.tile`` a non-empty tile, no
``api.warmup`` span, one count of ``api.warmup_skips``, and the first
call's answers bit for bit.  A new k,
metric set, weighted metric, min_score, max_factor2 or plan warms up again,
a ``PlanCache`` hit skips, and a first scoring that raised is not noted."""
import dataclasses

import numpy as np
import pytest

from conftest import powerlaw_graph
from test_torch_nine import NINE, _graph500, _small_segments

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import convert
from linkpred_tpu_torch.predict import api, plan
from linkpred_tpu_torch.utils import profiling
from linkpred_tpu_torch.utils.profiling import counter


@pytest.fixture(autouse=True)
def _recorder():
    """Every test starts and ends with recording off and nothing kept."""
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _recorded(fn):
    """``fn()`` with recording on and the counters zeroed: (its result,
    the names of the spans it recorded)."""
    profiling.reset_counters()
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, [s.name for s in profiling.drain()]


def _passes(p):
    return [p, *api._sub_plans(p)]


def _nonempty_tiles(p) -> int:
    return sum(int((np.diff(np.asarray(q.tile_start)) > 0).sum())
               for q in _passes(p))


def _edge_graph():
    gr = powerlaw_graph(np.random.default_rng(0), 400, 2400)
    return convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                     gr.n, gr.m)


def _packed_nine(mp):
    """A packed LHub plan whose main pass selects by segments at nine
    metrics (``tests/test_torch_nine.py``'s set-up)."""
    _small_segments(mp)
    _, _, y, d1 = _graph500()
    p = plan.build_plan(y, d1, device="cpu")
    assert p.packed and p.huge_plan is not None, "test premise"
    return y, d1, p


def _edge_hubs(mp):
    """An IHub edge-stream plan with a hub sub-plan and hubs scored on the
    host."""
    mp.setattr(plan, "SLOT_BUDGET", 0)
    mp.setattr(plan, "HUGE_DEVICE_MAX", 1000)
    gp = _edge_graph()
    p = plan.build_plan(gp, 0, 256, device="cpu")
    assert not p.packed and p.huge_plan is not None and p.host_src.size, \
        "test premise"
    return gp, 0, p


PLANS = {"packed_nine": _packed_nine, "edge_hubs": _edge_hubs}


def _assert_bit_equal(got, want, names):
    for name in names:
        for f in ("u", "v", "score"):
            a, b = getattr(got[name], f), getattr(want[name], f)
            assert a.dtype == b.dtype, f"{name}.{f}"
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{f}")


@pytest.mark.parametrize("kind", list(PLANS))
def test_a_second_call_on_the_same_plan_scores_it_once(kind, monkeypatch):
    g, d1, p = PLANS[kind](monkeypatch)

    def call():
        return lt.predict_links_multi(
            g, NINE, d1, plan=p, device="cpu",
            options=lt.PredictOptions(max_edges=300))

    first, names = _recorded(call)
    assert "api.warmup" in names and counter("api.warmup_skips") == 0
    assert names.count("scan.pass") == 2 * len(_passes(p))
    assert counter("scan.tiles") == 2 * _nonempty_tiles(p) > 0
    again, names = _recorded(call)
    assert "api.warmup" not in names and "api.score" in names
    assert counter("api.warmup_skips") == 1
    assert names.count("scan.pass") == len(_passes(p))
    assert counter("scan.tiles") == _nonempty_tiles(p)
    assert all(len(first[m]) > 0 for m in NINE)
    _assert_bit_equal(again, first, NINE)


# each case: (the first call's metrics and max_edges, the second's, or
# "new_plan" / "replaced_plan" for the same shape on another plan object;
# the second call's min_score and max_factor2)
SHAPES = {
    "k": (("jaccard",), 300, ("jaccard",), 3000, 0.0, 0),
    "metrics": (("jaccard",), 300, ("jaccard", "cn"), 300, 0.0, 0),
    "weighted": (("jaccard",), 300, ("adamic_adar",), 300, 0.0, 0),
    "min_score": (("jaccard",), 300, ("jaccard",), 300, 0.05, 0),
    "max_factor2": (("jaccard",), 300, ("jaccard",), 300, 0.0, 64),
    "new_plan": (("jaccard",), 300, "new_plan", 300, 0.0, 0),
    "replaced_plan": (("jaccard",), 300, "replaced_plan", 300, 0.0, 0),
}


@pytest.mark.parametrize("case", list(SHAPES))
def test_a_new_shape_or_plan_warms_up_again(case, monkeypatch):
    metrics, max_edges, then, then_edges, min_score, maxf2 = SHAPES[case]
    g, d1, p = _edge_hubs(monkeypatch)
    k = api._exact_k(p, max_edges)
    lt.predict_links_multi(g, metrics, d1, plan=p, device="cpu",
                           options=lt.PredictOptions(max_edges=max_edges))
    q = p
    if then == "new_plan":
        q, then = plan.build_plan(g, d1, 256, device="cpu"), metrics
    elif then == "replaced_plan":
        q, then = dataclasses.replace(p, keyed=False), metrics
    if case == "k":
        assert api._exact_k(p, then_edges) != k, "test premise"
    res, names = _recorded(lambda: lt.predict_links_multi(
        g, then, d1, max_factor2=maxf2, plan=q, device="cpu",
        options=lt.PredictOptions(max_edges=then_edges,
                                  min_score=min_score)))
    assert "api.warmup" in names and counter("api.warmup_skips") == 0
    assert names.count("scan.pass") == 2 * len(_passes(q))
    assert all(len(r) > 0 for r in res.values())


def test_the_warm_up_is_noted_per_device(monkeypatch):
    g, d1, p = _edge_hubs(monkeypatch)
    shape = (("jaccard_coefficient",), 1024, None)
    assert p.first_scoring("cpu", shape)
    p.note_scored("cpu", shape)
    assert not p.first_scoring("cpu", shape)
    assert p.first_scoring("cuda", shape)
    assert p.first_scoring("cpu", (*shape[:2], 2))
    assert dataclasses.replace(p).first_scoring("cpu", shape)
    assert p == dataclasses.replace(p), "the memo is not part of equality"


def test_a_plan_cache_hit_skips_the_warm_up(monkeypatch):
    g, d1, _ = _edge_hubs(monkeypatch)
    cache = lt.PlanCache()

    def call(metric):
        return _recorded(lambda: lt.predict_links(
            g, metric, d1, cap=256, plan_cache=cache, device="cpu",
            options=lt.PredictOptions(max_edges=300)))

    first, names = call("jaccard")
    assert "api.warmup" in names
    other, names = call("cn")
    assert "api.warmup" in names, "another metric is another shape"
    again, names = call("jaccard")
    assert "api.warmup" not in names and counter("api.warmup_skips") == 1
    assert len(cache._cache) == 2, "one plan and one device CSR"
    _assert_bit_equal({"j": again}, {"j": first}, ["j"])


def test_a_first_scoring_that_raised_is_not_noted(monkeypatch):
    g, d1, p = _edge_hubs(monkeypatch)
    real = api.score_tiles

    def fail(*a, **kw):
        raise RuntimeError("the first scoring fails")

    monkeypatch.setattr(api, "score_tiles", fail)
    with pytest.raises(RuntimeError, match="first scoring fails"):
        lt.predict_links(g, "jaccard", d1, plan=p, device="cpu")
    monkeypatch.setattr(api, "score_tiles", real)
    res, names = _recorded(lambda: lt.predict_links(
        g, "jaccard", d1, plan=p, device="cpu"))
    assert "api.warmup" in names and counter("api.warmup_skips") == 0
    assert len(res) > 0
