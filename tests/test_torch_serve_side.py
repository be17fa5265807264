"""A served request whose plan has a wide-degree side plan, on the CPU.

The graph is ``tests/test_degsplit.py``'s: one hub of degree 65,600
(>= 2^16) reached from degree-1 satellites through degree-2 connectors,
beside a ring of ten.  A request over a few satellites and ring vertices
puts every (satellite, hub) slot on the side plan and the ring's slots on
the main one, so ``predict_links(..., sources=...)`` scores two passes and
merges their winners.  Its answer after ``top_per_source`` is held to the
benchmark's float64 reference (``lpbench.reference.linkpred.served_topk``)
under the ``serve`` mix's limits and to the JAX package's, and each side
pass scored is one span ``scan.side``.  The module imports the JAX package
only inside what compares with it, so a test of the port alone can take
the port's graph from :func:`port_hub_graph`."""
import json
import os
import sys

import numpy as np
import pytest
import torch

import linkpred_tpu_torch as lt
from linkpred_tpu_torch.predict import plan
from linkpred_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from lpbench import judge  # noqa: E402
from lpbench.graph500 import Graph  # noqa: E402
from lpbench.reference.linkpred import served_topk  # noqa: E402

N_RING, N_PAIRS = 10, 32800
K = 2 * N_PAIRS                 # satellites, connectors, the hub's degree
HUB = N_RING + 2 * K
D1 = 64                         # the serving cell's hub threshold
with open(os.path.join(ROOT, "lpbench", "traffic", "serve.json")) as fh:
    SERVE = json.load(fh)
PER_USER = int(SERVE["per_user"])
METRICS = ("jaccard_coefficient", "adamic_adar")
# satellites (each has the hub as its one candidate) and ring vertices
USERS = np.array([0, 3, 7, N_RING, N_RING + 5, N_RING + 1000,
                  N_RING + K - 1], dtype=np.int64)
MAX_EDGES = USERS.size * int(SERVE["edges_per_user"])


def _hub_edges():
    """The graph's directed edges ``(src, dst)``, both ways."""
    ring = np.arange(N_RING)
    sat = N_RING + np.arange(K)
    con = N_RING + K + np.arange(K)
    e = np.concatenate([np.stack([ring, (ring + 1) % N_RING], 1),
                        np.stack([sat, con], 1),
                        np.stack([con, np.full(K, HUB)], 1)])
    return (np.concatenate([e[:, 0], e[:, 1]]),
            np.concatenate([e[:, 1], e[:, 0]]))


def port_hub_graph():
    """The port's graph."""
    return lt.from_edges(*_hub_edges(), n=HUB + 1)


@pytest.fixture(scope="module")
def graphs():
    """``(JAX package's graph, the port's, the reference's)``."""
    import linkpred_tpu as lp

    gp = port_hub_graph()
    h = gp.host()
    ref = Graph(torch.as_tensor(np.asarray(h.offsets, np.int64)),
                torch.as_tensor(np.asarray(h.indices[: h.m], np.int64)),
                h.n)
    return lp.from_edges(*_hub_edges(), n=HUB + 1), gp, ref


@pytest.fixture(autouse=True)
def _recorder():
    """Every test starts and ends with recording off and nothing kept."""
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def _nonempty_tiles(p) -> int:
    return int(np.count_nonzero(np.diff(np.asarray(p.tile_start)) > 0))


def _serve(gp, metric, **kw):
    res = lt.predict_links(gp, metric, D1, sources=USERS, device="cpu",
                           options=lt.PredictOptions(max_edges=MAX_EDGES),
                           **kw)
    return res, lt.top_per_source(res, PER_USER)


def _rows(u, v, s):
    return {(int(a), int(b)): float(c) for a, b, c in zip(u, v, s)}


def test_the_request_has_a_side_plan(graphs):
    _, gp, _ = graphs
    p = plan.build_plan(gp, D1, sources=USERS, device="cpu")
    assert p.packed and p.deg16 and not p.upper_only
    side = p.side_plan
    assert side is not None and side.packed and not side.deg16
    # one (satellite, hub) slot for each satellite of the request
    assert side.total_slots == int(np.sum(USERS >= N_RING))
    assert p.total_slots > 0 and p.huge_plan is None
    assert p.host_src.size == 0


@pytest.mark.parametrize("slot_budget", [None, 0])
def test_the_served_plan_equals_the_jax_packages(graphs, slot_budget):
    """Field for field, side plan included: the request's counts and
    prefixes run over its own sources, the JAX package's over every
    vertex.  A zero slot budget takes the edge stream."""
    from linkpred_tpu.predict import plan as ref_plan
    from test_torch_plan import _assert_plan_equal

    gr, gp, _ = graphs
    _assert_plan_equal(
        plan.build_plan(gp, D1, sources=USERS, slot_budget=slot_budget,
                        device="cpu"),
        ref_plan.build_plan(gr, D1, sources=USERS, slot_budget=slot_budget))


@pytest.mark.parametrize("metric", METRICS)
def test_served_side_pass_matches_the_float64_reference(graphs, metric):
    _, gp, ref = graphs
    _, top = _serve(gp, metric)
    sources = torch.as_tensor(USERS)
    want = _rows(*served_topk(ref, metric, D1, sources, MAX_EDGES, PER_USER))
    got = _rows(top.u, top.v, top.score)
    assert set(got) == set(want)
    assert (min(USERS[USERS >= N_RING]), HUB) in got
    # the judge's own numbers of the request, under the serve mix's limits
    numbers = judge.judge_served(
        ref, metric, D1, [(USERS, (top.u, top.v, top.score))],
        max_edges=MAX_EDGES, per_user=PER_USER,
        band=float(SERVE["limits"]["rank_gap"]))
    numbers["missing"] = 0
    ok, checks = judge.verdict(numbers, judge.flat_limits(SERVE))
    assert ok, checks


@pytest.mark.parametrize("metric", METRICS)
def test_served_side_pass_matches_the_jax_package(graphs, metric):
    import linkpred_tpu as lp
    from linkpred_tpu.predict.api import top_per_source as ref_top_per_source

    gr, gp, _ = graphs
    res, top = _serve(gp, metric)
    want = lp.predict_links(gr, metric, D1, sources=USERS,
                            options=lp.PredictOptions(max_edges=MAX_EDGES))
    want_top = ref_top_per_source(want, PER_USER)
    for a, b in ((res, want), (top, want_top)):
        got, exp = _rows(a.u, a.v, a.score), _rows(b.u, b.v, b.score)
        assert set(got) == set(exp)
        pairs = sorted(got)
        np.testing.assert_allclose([got[q] for q in pairs],
                                   [exp[q] for q in pairs], rtol=1e-5)


def test_side_plans_tiles_and_slots(graphs):
    """Served and whole-graph builds alike: the side plan's tiles are all
    non-empty and hold its slots, one (satellite, hub) pair each; a request
    over the ring alone makes none."""
    _, gp, _ = graphs
    for kw, slots in ((dict(sources=USERS), int(np.sum(USERS >= N_RING))),
                      (dict(cap=1 << 16), K)):
        side = plan.build_plan(gp, D1, device="cpu", **kw).side_plan
        assert side is not None, kw
        assert _nonempty_tiles(side) == side.num_tiles > 0
        assert side.total_slots == slots
        assert int(np.asarray(side.tile_start)[side.num_tiles]) == slots
    assert plan.build_plan(gp, D1, sources=USERS[:3],
                           device="cpu").side_plan is None


def test_one_scan_side_span_for_each_side_pass_scored(graphs):
    _, gp, _ = graphs
    p = plan.build_plan(gp, D1, sources=USERS, device="cpu")
    opts = lt.PredictOptions(max_edges=MAX_EDGES)

    def call():
        return lt.predict_links(gp, "adamic_adar", D1, sources=USERS,
                                plan=p, options=opts, device="cpu")

    ons = []
    for scorings in (2, 1):     # a first scoring warms up, a repeat not
        profiling.enable()
        try:
            ons.append(call())
        finally:
            profiling.disable()
        spans = profiling.drain()
        by_id = {s.id: s for s in spans}
        side = [s for s in spans if s.name == "scan.side"]
        assert len(side) == scorings
        assert {by_id[s.parent].name for s in side} <= {"api.warmup",
                                                        "api.score"}
        # the side pass is ``scan.side`` in place of ``scan.pass``: one
        # of each a scoring, the side plan's tiles inside its own
        passes = [s for s in spans if s.name == "scan.pass"]
        assert len(passes) == scorings
        side_ids = {s.id for s in side}
        assert sum(s.name == "scan.tile" and s.parent in side_ids
                   for s in spans) == scorings * p.side_plan.num_tiles
    off = call()
    for on in ons:
        for a, b in ((on.u, off.u), (on.v, off.v), (on.score, off.score)):
            np.testing.assert_array_equal(a, b)
    # with recording off nothing is kept
    assert profiling.drain() == []
