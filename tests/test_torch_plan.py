"""The port's NumPy copies of the host layer against the reference: graphs,
transforms, R-MAT synthesis, the deletion pipeline and ``build_plan``, every
array field ``np.array_equal`` (dtype included) and every scalar equal.
``build_plan`` for a source set reads only those rows of the CSR where the
reference masks every edge: the plans, the first hop's counters and the
serving answers are held against the reference and a full-scan plan.

The port cannot import the reference's host modules (they import jax, and
the machine with the card has none), so these tests pin the copies.
"""
import dataclasses

import numpy as np
import pytest

from conftest import powerlaw_graph

import linkpred_tpu as lp
from linkpred_tpu.bench import synth as ref_synth
from linkpred_tpu.ops import batch as ref_batch
from linkpred_tpu.ops import transform as ref_transform
from linkpred_tpu.predict import plan as ref_plan

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import convert
from linkpred_tpu_torch.bench import synth
from linkpred_tpu_torch.io import native
from linkpred_tpu_torch.ops import batch, transform
from linkpred_tpu_torch.predict import plan
from linkpred_tpu_torch.utils import profiling


def _both_graphs(src, dst, n):
    gr = ref_transform.remove_self_loops(
        ref_transform.symmetrize(lp.from_edges(src, dst, n=n)))
    gp = transform.remove_self_loops(
        transform.symmetrize(lt.from_edges(src, dst, n=n)))
    return gr, gp


def _assert_graph_equal(gp, gr):
    assert (gp.n, gp.m) == (gr.n, gr.m)
    for f in ("offsets", "indices", "degrees"):
        a, b = np.asarray(getattr(gp, f)), np.asarray(getattr(gr, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (gp.weights is None) == (gr.weights is None)


def _assert_plan_equal(pp, rp, path="plan"):
    assert (pp is None) == (rp is None), path
    if rp is None:
        return
    for f in dataclasses.fields(rp):
        if f.name == "_device":
            continue
        a, b = getattr(pp, f.name), getattr(rp, f.name)
        where = f"{path}.{f.name}"
        if f.name in ("huge_plan", "side_plan"):
            _assert_plan_equal(a, b, where)
        elif isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), where
            assert a.dtype == b.dtype and np.array_equal(a, b), where
        else:
            assert a == b and type(a) is type(b), where


def _random_edges(rng, n, avg_deg):
    m = int(n * avg_deg)
    return rng.integers(0, n, m), rng.integers(0, n, m)


@pytest.mark.parametrize("d1,cap", [(0, None), (4, None), (64, 1024),
                                    (0, 512)])
def test_build_plan_random_graph(rng, d1, cap):
    src, dst = _random_edges(rng, 300, 6)
    gr, gp = _both_graphs(src, dst, 300)
    _assert_graph_equal(gp, gr)
    _assert_plan_equal(plan.build_plan(gp, d1, cap, device="cpu"),
                       ref_plan.build_plan(gr, d1, cap))


def test_build_plan_numpy_fallback(rng, monkeypatch):
    """Without the native library the port's NumPy pipeline gives the same
    plan as the reference's native one."""
    monkeypatch.setattr(native, "native_lib", lambda: None)
    src, dst = _random_edges(rng, 300, 6)
    gr, gp = _both_graphs(src, dst, 300)
    _assert_plan_equal(plan.build_plan(gp, 0, 1024, device="cpu"),
                       ref_plan.build_plan(gr, 0, 1024))


def test_build_plan_hub_subplan(rng):
    """conftest's power-law graph + small cap: the hub sub-plan is forced."""
    gr = powerlaw_graph(rng, n=300, m=2000)
    gp = convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                   gr.n, gr.m)
    rp = ref_plan.build_plan(gr, 0, 512)
    assert rp.huge_plan is not None, "test premise: hub sub-plan"
    _assert_plan_equal(plan.build_plan(gp, 0, 512, device="cpu"), rp)


def test_build_plan_side_plan_wide_degrees():
    """One hub of degree 65,600 (tests/test_degsplit.py's graph): the
    oversized-degree pairs ride a wide side plan."""
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
    rp = ref_plan.build_plan(gr, 2, cap=1 << 16)
    assert rp.side_plan is not None and not rp.side_plan.deg16
    _assert_plan_equal(plan.build_plan(gp, 2, cap=1 << 16, device="cpu"), rp)


def test_build_plan_sources_and_edge_stream(rng):
    src, dst = _random_edges(rng, 200, 5)
    gr, gp = _both_graphs(src, dst, 200)
    sources = np.array([3, 17, 42, 199])
    _assert_plan_equal(
        plan.build_plan(gp, 0, 1024, sources=sources, device="cpu"),
        ref_plan.build_plan(gr, 0, 1024, sources=sources))
    # slot_budget=0 forces the edge stream: the plan still matches
    _assert_plan_equal(plan.build_plan(gp, 8, 1024, slot_budget=0,
                                       device="cpu"),
                       ref_plan.build_plan(gr, 8, 1024, slot_budget=0))


# A Zipf-skewed graph on vertices 0..299 of 320: 300..319 have no edge, and
# the first few vertices are hubs whose second hop exceeds a small cap.
_N_LIVE, _N = 300, 320
# (d1, cap): IHub and LHub at caps where hubs get a sub-plan
_HUB_CAPS = [(0, 256), (2, 64), (64, 128)]
_SOURCE_SETS = {
    "unsorted_dups": [140, 5, 77, 5, 250, 140, 33, 6],
    "zero_degree": [310, 12, 300, 319, 45],
    "hubs": [2, 0, 1, 250, 0, 7],
    "out_of_range": [-3, 7, 320, 99, 10 ** 6, 1],
    "empty": [],
}


def _hub_graphs():
    rng = np.random.default_rng(5)
    w = 1.0 / np.arange(1, _N_LIVE + 1) ** 1.2
    src = rng.choice(_N_LIVE, size=2000, p=w / w.sum())
    dst = rng.integers(0, _N_LIVE, 2000)
    gr, gp = _both_graphs(src, dst, _N)
    assert not np.asarray(gp.degrees)[_N_LIVE:].any(), "test premise"
    return gr, gp


@pytest.fixture
def _hubs_on_device(monkeypatch):
    """Both planners keep every hub of these graphs on the device."""
    monkeypatch.setattr(plan, "HUGE_DEVICE_MAX", 1 << 20)
    monkeypatch.setattr(ref_plan, "HUGE_DEVICE_MAX", 1 << 20)


@pytest.mark.parametrize("slot_budget", [None, 0])
@pytest.mark.parametrize("kind", sorted(_SOURCE_SETS))
@pytest.mark.parametrize("d1,cap", _HUB_CAPS)
def test_source_plan_reads_rows_and_equals_reference(_hubs_on_device, d1, cap,
                                                     kind, slot_budget):
    """A plan for a source set reads only those rows of the CSR, and equals
    the reference's, which masks every edge: unsorted ids, duplicates,
    zero-degree vertices, ids outside the graph, and hubs, whose serving
    sub-plan (the sources within the hubs) is built the same way."""
    gr, gp = _hub_graphs()
    sources = np.asarray(_SOURCE_SETS[kind], dtype=np.int64)
    rp = ref_plan.build_plan(gr, d1, cap, slot_budget=slot_budget,
                             sources=sources)
    if kind == "hubs":
        assert rp.huge_plan is not None, "test premise: serving sub-plan"
    _assert_plan_equal(plan.build_plan(gp, d1, cap, slot_budget=slot_budget,
                                       sources=sources, device="cpu"), rp)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("d1,cap", _HUB_CAPS)
def test_whole_graph_plan_with_hub_subplan(_hubs_on_device, monkeypatch, d1,
                                           cap, use_native):
    """A whole-graph plan scans every edge (natively or in NumPy); its hub
    sub-plan (``upper_only`` with ``_keep_src``) reads the hubs' rows."""
    if not use_native:
        monkeypatch.setattr(native, "native_lib", lambda: None)
    gr, gp = _hub_graphs()
    rp = ref_plan.build_plan(gr, d1, cap)
    assert rp.huge_plan is not None and rp.upper_only, "test premise"
    _assert_plan_equal(plan.build_plan(gp, d1, cap, device="cpu"), rp)


def _device_hubs(p) -> int:
    """The rows of ``p``'s hub sub-plan: its hubs scored on the device."""
    return 0 if p.huge_plan is None else p.huge_src.size - p.host_src.size


@pytest.mark.parametrize("kind", ["hubs", "out_of_range", "zero_degree"])
@pytest.mark.parametrize("d1,cap", _HUB_CAPS)
def test_serving_build_counts_rows_and_no_scan(_hubs_on_device, d1, cap,
                                               kind):
    _, gp = _hub_graphs()
    sources = np.asarray(_SOURCE_SETS[kind], dtype=np.int64)
    distinct = np.unique(sources)
    in_range = int(((distinct >= 0) & (distinct < gp.n)).sum())
    profiling.reset_counters()
    p = plan.build_plan(gp, d1, cap, sources=sources, device="cpu")
    if kind == "hubs":
        assert _device_hubs(p) > 0, "test premise: serving sub-plan"
    assert profiling.counter("plan.firsthop_scans") == 0
    assert profiling.counter("plan.firsthop_rows") == (in_range
                                                       + _device_hubs(p))


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("d1,cap", _HUB_CAPS)
def test_whole_graph_build_counts_one_scan(_hubs_on_device, monkeypatch, d1,
                                           cap, use_native):
    if not use_native:
        monkeypatch.setattr(native, "native_lib", lambda: None)
    _, gp = _hub_graphs()
    profiling.reset_counters()
    p = plan.build_plan(gp, d1, cap, device="cpu")
    assert _device_hubs(p) > 0, "test premise: hub sub-plan"
    assert profiling.counter("plan.firsthop_scans") == 1
    assert profiling.counter("plan.firsthop_rows") == _device_hubs(p)


def _masked_row_edges(g, deg, offsets64, rows):
    """The first hop of a source set as a mask over every edge: each
    edge's source tested against ``rows``."""
    src = np.repeat(np.arange(g.n, dtype=np.int64), deg)
    mid = np.asarray(g.indices, dtype=np.int64)[: g.m]
    keep = np.isin(src, rows)
    return src[keep], mid[keep]


@pytest.mark.parametrize("metric", ["adamic_adar", "jaccard_coefficient"])
@pytest.mark.parametrize("d1,cap", _HUB_CAPS)
def test_serving_answers_equal_a_full_scan_plan(_hubs_on_device, monkeypatch,
                                                d1, cap, metric):
    """A serving call's answer is bit for bit the one it gives with a plan
    whose first hop masked every edge."""
    _, gp = _hub_graphs()
    users = np.asarray(_SOURCE_SETS["hubs"] + _SOURCE_SETS["unsorted_dups"])
    opts = lt.PredictOptions(max_edges=200)
    with monkeypatch.context() as m:
        m.setattr(plan, "_row_edges", _masked_row_edges)
        scanned = plan.build_plan(gp, d1, cap, sources=users, device="cpu")
    assert scanned.huge_plan is not None, "test premise: serving sub-plan"
    _assert_plan_equal(plan.build_plan(gp, d1, cap, sources=users,
                                       device="cpu"), scanned)
    got = lt.predict_links(gp, metric, min_degree1=d1, cap=cap,
                           sources=users, options=opts, device="cpu")
    want = lt.predict_links(gp, metric, min_degree1=d1, cap=cap,
                            sources=users, options=opts, plan=scanned,
                            device="cpu")
    assert len(got) > 0
    for f in ("u", "v", "score"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_plan_from_fields_roundtrip(rng):
    n, m = 300, 2000
    src = rng.integers(0, n, m) ** 2 % n
    dst = rng.integers(0, n, m)
    gr, _ = _both_graphs(src, dst, n)
    rp = ref_plan.build_plan(gr, 0, 512)
    _assert_plan_equal(convert.plan_from_fields(**dataclasses.asdict(rp)), rp)
    gp = convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                   gr.n, gr.m)
    _assert_graph_equal(gp, gr)


def test_rmat_and_deletion_pipeline():
    gr = ref_synth.rmat_graph(9, edge_factor=8, seed=42)
    gp = synth.rmat_graph(9, edge_factor=8, seed=42)
    _assert_graph_equal(gp, gr)
    dr = ref_batch.generate_edge_deletions(np.random.default_rng(0), gr,
                                           int(0.1 * gr.size / 2))
    dp = batch.generate_edge_deletions(np.random.default_rng(0), gp,
                                       int(0.1 * gp.size / 2))
    np.testing.assert_array_equal(dp, dr)
    none = np.empty((0, 2), np.int64)
    dr, ir = ref_batch.tidy_batch(dr, none, gr)
    dp, ip = batch.tidy_batch(dp, none, gp)
    np.testing.assert_array_equal(dp, dr)
    np.testing.assert_array_equal(ip, ir)
    yr = ref_batch.apply_batch(gr, dr, ir)
    yp = batch.apply_batch(gp, dp, ip)
    _assert_graph_equal(yp, yr)
    assert yp.m == gp.m - dp.shape[0]
    _assert_plan_equal(plan.build_plan(yp, 64, device="cpu"),
                       ref_plan.build_plan(yr, 64))


def test_planted_partition_graph():
    _assert_graph_equal(synth.planted_partition_graph(8, 32, seed=1),
                        ref_synth.planted_partition_graph(8, 32, seed=1))


def test_a_graph_gives_its_int64_rows_once():
    """Every build on one graph reads the same read-only int64 copies of its
    degrees and row starts, and its largest degree; the memo lets them go
    with the graph."""
    import gc

    _, gp = _hub_graphs()
    sources = np.asarray(_SOURCE_SETS["hubs"], dtype=np.int64)
    first = plan._int64_rows(gp.host())
    plan.build_plan(gp, 4, None, sources=sources, device="cpu")
    again = plan._int64_rows(gp.host())
    assert all(a is b for a, b in zip(first[:2], again[:2]))
    deg, offsets64, max_deg = again
    for arr, f in ((deg, "degrees"), (offsets64, "offsets")):
        assert arr.dtype == np.int64 and not arr.flags.writeable
        assert np.array_equal(arr, np.asarray(getattr(gp, f)))
    assert max_deg == int(np.asarray(gp.degrees).max())
    key = id(gp.degrees)
    assert key in plan._ROWS64
    del gp, first, again, deg, offsets64
    gc.collect()
    assert key not in plan._ROWS64


@pytest.mark.parametrize("use_native", [True, False])
def test_source_plans_in_turn_equal_the_reference(_hubs_on_device,
                                                  monkeypatch, use_native):
    """Builds for one source set after another on one graph (the native
    expansion counts into one buffer a thread) each equal the reference's
    plan for that set alone."""
    if not use_native:
        monkeypatch.setattr(native, "native_lib", lambda: None)
    gr, gp = _hub_graphs()
    for kind in ("hubs", "unsorted_dups", "zero_degree", "hubs", "empty"):
        sources = np.asarray(_SOURCE_SETS[kind], dtype=np.int64)
        _assert_plan_equal(
            plan.build_plan(gp, 4, None, sources=sources, device="cpu"),
            ref_plan.build_plan(gr, 4, None, sources=sources), kind)
