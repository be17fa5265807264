"""The slice as a whole: the port's ``predict_links_multi`` on the CPU
(which runs both kernels' twins) against ``linkpred_tpu.predict_links_multi``
on the CPU and against the dense oracle ``tests/oracle.py``; the
reference's own plan pushed through the port's scorer; the segmented scan;
the survivor pack inside a full run; serving mode; ``top_per_source``;
what raises.  ``device="cuda"`` against the CPU is in test_torch_cuda.py.

Tolerances: unweighted scores bit-equal, except Salton (within 2 ulp of
the reference, whose XLA divides by a * rsqrt(b)); AA/RA rtol 1e-5 (three
float32 summation orders and another float32 log); pair sets equal, up to
ties at the k boundary.
"""
import dataclasses

import numpy as np
import pytest
import torch

from conftest import powerlaw_graph, random_graph
from oracle import oracle_scores

import linkpred_tpu as lp
from linkpred_tpu.predict import plan as ref_plan

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import convert
from linkpred_tpu_torch.predict import api, plan, scoring
from linkpred_tpu_torch.utils.profiling import counter

ALL = list(lt.METRICS)
SALTON = "salton_cosine_similarity"


def _port_graph(gr):
    return convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                     gr.n, gr.m)


def _rows(res):
    return {(int(u), int(v)): float(s)
            for u, v, s in zip(res.u, res.v, res.score)}


def _assert_same_result(got, want, name):
    """Same length, matching score multisets, and the same pairs above the
    k-boundary score (ties at the boundary may pick other pairs)."""
    assert len(got) == len(want), name
    if not len(want):
        return
    a, b = np.sort(got.score), np.sort(want.score)
    if lt.METRICS[name].needs_weight:
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=name)
    elif name == SALTON:
        np.testing.assert_allclose(a, b, rtol=3e-7, err_msg=name)
    else:
        np.testing.assert_array_equal(a, b, err_msg=name)
    cut = want.score.min() * (1 + 1e-5)
    above_g = {p for p, s in _rows(got).items() if s > cut}
    above_w = {p for p, s in _rows(want).items() if s > cut}
    assert above_g == above_w, name
    rows_w = _rows(want)
    for p, s in _rows(got).items():
        if p in rows_w:
            assert np.isclose(s, rows_w[p], rtol=1e-5), (name, p)


@pytest.mark.parametrize("d1", [0, 4])
def test_all_metrics_vs_reference_and_oracle(rng, d1):
    gr = random_graph(rng, 200, 3)
    gp = _port_graph(gr)
    opts = dict(max_edges=100_000)
    got = lt.predict_links_multi(gp, ALL, min_degree1=d1,
                                 options=lt.PredictOptions(**opts),
                                 device="cpu")
    want = lp.predict_links_multi(gr, ALL, min_degree1=d1,
                                  options=lp.PredictOptions(**opts))
    for name in ALL:
        _assert_same_result(got[name], want[name], name)
        pairs = oracle_scores(gr, name, d1)
        assert len(got[name]) == len(pairs) > 0, name
        for (u, v), s in _rows(got[name]).items():
            assert np.isclose(s, pairs[(u, v)], rtol=1e-5), (name, u, v)
        assert got[name].scoring_ms > 0


def test_k_boundary_ties_vs_reference(rng):
    gr = random_graph(rng, 250, 6)
    gp = _port_graph(gr)
    for name in ("jaccard_coefficient", "common_neighbors", "adamic_adar"):
        got = lt.predict_links(gp, name, min_degree1=32,
                               options=lt.PredictOptions(max_edges=77),
                               device="cpu")
        want = lp.predict_links(gr, name, min_degree1=32,
                                options=lp.PredictOptions(max_edges=77))
        _assert_same_result(got, want, name)


def test_reference_plan_through_port_scorer(rng):
    """The reference's own plan, carried over with convert.plan_from_fields,
    gives the reference's results through the port's device engine."""
    gr = random_graph(rng, 300, 4)
    rp = ref_plan.build_plan(gr, 0, 512)
    pp = convert.plan_from_fields(**dataclasses.asdict(rp))
    names = ["jaccard_coefficient", "resource_allocation", "hub_promoted"]
    opts = dict(max_edges=5000)
    got = lt.predict_links_multi(_port_graph(gr), names, min_degree1=0,
                                 plan=pp, options=lt.PredictOptions(**opts),
                                 device="cpu")
    want = lp.predict_links_multi(gr, names, min_degree1=0, plan=rp,
                                  options=lp.PredictOptions(**opts))
    for name in names:
        _assert_same_result(got[name], want[name], name)


def test_hub_subplan(rng):
    """A forced hub sub-plan (power-law graph, small cap) runs through the
    same packed engine and merges as the reference's does."""
    gr = powerlaw_graph(rng, n=300, m=2000)
    gp = _port_graph(gr)
    assert plan.build_plan(gp, 0, 512, device="cpu").huge_plan is not None
    names = ["jaccard_coefficient", "adamic_adar"]
    got = lt.predict_links_multi(gp, names, min_degree1=0, cap=512,
                                 options=lt.PredictOptions(max_edges=10**5),
                                 device="cpu")
    want = lp.predict_links_multi(gr, names, min_degree1=0, cap=512,
                                  options=lp.PredictOptions(max_edges=10**5))
    for name in names:
        _assert_same_result(got[name], want[name], name)


def test_side_plan_wide_degrees():
    """tests/test_degsplit.py's one-hub graph (degree 65,600): the pairs
    with the hub ride the side plan, whose tail takes the wide degree
    pair."""
    n_ring, n_pairs = 10, 32800
    k = 2 * n_pairs
    ring = np.arange(n_ring)
    sat = n_ring + np.arange(k)
    con = n_ring + k + np.arange(k)
    hub = n_ring + 2 * k
    e = np.concatenate([np.stack([ring, (ring + 1) % n_ring], 1),
                        np.stack([sat, con], 1),
                        np.stack([con, np.full(k, hub)], 1)])
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    gr = lp.from_edges(src, dst, n=hub + 1)
    gp = lt.from_edges(src, dst, n=hub + 1)
    assert plan.build_plan(gp, 2, 1 << 16, device="cpu").side_plan is not None
    names = ["jaccard_coefficient", "adamic_adar"]
    got = lt.predict_links_multi(gp, names, min_degree1=2, cap=1 << 16,
                                 options=lt.PredictOptions(max_edges=10**5),
                                 device="cpu")
    want = lp.predict_links_multi(gr, names, min_degree1=2, cap=1 << 16,
                                  options=lp.PredictOptions(max_edges=10**5))
    for name in names:
        _assert_same_result(got[name], want[name], name)
    assert np.isclose(_rows(got["jaccard_coefficient"])[(n_ring, hub)],
                      1.0 / k, rtol=1e-6)


def test_segmented_scan_equals_single_segment(rng, monkeypatch):
    gr = random_graph(rng, 300, 6)
    gp = _port_graph(gr)
    p = plan.build_plan(gp, 0, 256, device="cpu")
    assert p.num_tiles_padded >= 8, "test premise: many tiles"
    names = ["jaccard_coefficient", "adamic_adar"]
    kw = dict(min_degree1=0, plan=p, device="cpu",
              options=lt.PredictOptions(max_edges=700))
    single = lt.predict_links_multi(gp, names, **kw)
    # 2 metrics: seg lanes = SEG_LANES*12 // 16 -> 3 tiles of 256 a segment
    monkeypatch.setattr(scoring, "SEG_LANES", 1024)
    calls = []
    real = scoring._merge_stacked
    monkeypatch.setattr(scoring, "_merge_stacked",
                        lambda *a: calls.append(1) or real(*a))
    seg = lt.predict_links_multi(gp, names, **kw)
    assert calls, "test premise: the segmented branch ran"
    want = lp.predict_links_multi(gr, names, min_degree1=0, cap=256,
                                  options=lp.PredictOptions(max_edges=700))
    for name in names:
        _assert_same_result(seg[name], single[name], name)
        _assert_same_result(seg[name], want[name], name)


def test_survivor_pack_inside_full_run(rng, monkeypatch):
    gr = random_graph(rng, 300, 8)
    gp = _port_graph(gr)
    opts = dict(max_edges=100)
    want = lp.predict_links(gr, "jaccard_coefficient", min_degree1=0,
                            cap=1024, options=lp.PredictOptions(**opts))
    monkeypatch.setattr(scoring, "SEL_PACK_MIN", 1 << 12)
    before = counter("select.packed_arm")
    got = lt.predict_links(gp, "jaccard_coefficient", min_degree1=0,
                           cap=1024, options=lt.PredictOptions(**opts),
                           device="cpu")
    assert counter("select.packed_arm") > before
    _assert_same_result(got, want, "jaccard_coefficient")


def test_serving_mode_sources_and_top_per_source(rng):
    gr = random_graph(rng, 200, 4)
    gp = _port_graph(gr)
    sources = np.array([0, 5, 17, 99, 150])
    got = lt.predict_links(gp, "resource_allocation", min_degree1=0,
                           sources=sources, device="cpu",
                           options=lt.PredictOptions(max_edges=10_000))
    want = lp.predict_links(gr, "resource_allocation", min_degree1=0,
                            sources=sources,
                            options=lp.PredictOptions(max_edges=10_000))
    _assert_same_result(got, want, "resource_allocation")
    pairs = oracle_scores(gr, "resource_allocation", 0, sources=sources)
    assert len(got) == len(pairs) > 0
    assert set(np.unique(got.u)) <= set(sources.tolist())
    for (u, v), s in _rows(got).items():
        assert np.isclose(s, pairs[(u, v)], rtol=1e-5)
    from linkpred_tpu.predict.api import top_per_source as ref_tps
    a, b = api.top_per_source(got, 3), ref_tps(want, 3)
    # per source: the same best scores (ties inside a source's cut may
    # keep other pairs), each a row of the input result
    assert len(a) == len(b)
    for s in sources:
        np.testing.assert_allclose(np.sort(a.score[a.u == s]),
                                   np.sort(b.score[b.u == s]), rtol=1e-5)
    assert set(_rows(a)) <= set(_rows(got))
    assert np.all(np.diff(a.score) <= 0)


def test_plan_cache_reuses_plans(rng):
    gp = _port_graph(random_graph(rng, 100, 4))
    cache = lt.PlanCache()
    r1 = lt.predict_links(gp, "cn", min_degree1=0, plan_cache=cache,
                          device="cpu")
    r2 = lt.predict_links(gp, "jaccard", min_degree1=0, plan_cache=cache,
                          device="cpu")
    assert len(cache._cache) == 1 and len(r1) == len(r2) > 0


def test_not_ported_paths_raise(rng, monkeypatch):
    """``key64=False`` still raises, and so does a ``mesh=`` that is not
    the port's (the sharded pass is held in test_torch_parallel.py);
    edge-stream plans and mega-hub sources (``host_src``) give the
    reference's results."""
    gr = random_graph(rng, 100, 4)
    gp = _port_graph(gr)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        lt.predict_links(gp, "cn", mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="int64 key"):
        lt.predict_links(gp, "cn", key64=False, device="cpu")
    opts = dict(max_edges=5000)
    edge = plan.build_plan(gp, 0, 1024, slot_budget=0, device="cpu")
    assert not edge.packed
    got = lt.predict_links(gp, "cn", min_degree1=0, plan=edge, device="cpu",
                           options=lt.PredictOptions(**opts))
    want = lp.predict_links(gr, "cn", min_degree1=0, cap=1024,
                            options=lp.PredictOptions(**opts))
    _assert_same_result(got, want, "common_neighbors")
    monkeypatch.setattr(plan, "HUGE_DEVICE_MAX", 1)
    monkeypatch.setattr(ref_plan, "HUGE_DEVICE_MAX", 1)
    assert plan.build_plan(gp, 0, 8, device="cpu").host_src.size
    got = lt.predict_links(gp, "cn", min_degree1=0, cap=8, device="cpu",
                           options=lt.PredictOptions(**opts))
    want = lp.predict_links(gr, "cn", min_degree1=0, cap=8,
                            options=lp.PredictOptions(**opts))
    _assert_same_result(got, want, "common_neighbors")


def test_entry_points_default_to_the_card(rng, monkeypatch):
    """Without ``device=`` every entry point targets the CUDA card; with no
    card it raises rather than run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gp = _port_graph(random_graph(rng, 60, 4))
    for call in (lambda: lt.predict_links(gp, "cn"),
                 lambda: lt.predict_links_multi(gp, ["cn", "aa"]),
                 lambda: plan.build_plan(gp, 0),
                 lambda: lt.PlanCache().get(gp, 0, None),
                 lambda: lt.PlanCache().device_graph(gp)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()

