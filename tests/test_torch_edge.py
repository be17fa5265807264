"""The edge stream (IHub at scale) and the mega-hub host scorer: the port on
the CPU (K1's twin, killer branch) against ``linkpred_tpu`` on the CPU
(Pallas in interpret mode) and against the dense oracle ``tests/oracle.py``.
Mirrors ``tests/test_predict.py``'s edge-stream and mega-hub cases.

Plans are forced to the edge stream with ``slot_budget=0``.  The sentinel
two-key branch (ids too wide for the w key, n > 2^30) is reached with
``keyed=False`` on the port's plan and ``LINKPRED_EDGE_SENTINEL=1`` on the
reference's.  Tolerances are test_torch_predict.py's: unweighted scores
bit-equal (Salton within 2 ulp), AA/RA rtol 1e-5, pair sets equal up to
ties at the k boundary.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import powerlaw_graph, random_graph
from oracle import oracle_scores
from test_torch_predict import _assert_same_result, _port_graph, _rows

import linkpred_tpu as lp
from linkpred_tpu.predict import metrics as ref_metrics
from linkpred_tpu.predict import plan as ref_plan
from linkpred_tpu.predict import scoring as ref_scoring

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import convert
from linkpred_tpu_torch.ops import fused_tail as ft
from linkpred_tpu_torch.ops.topk import desc_key_score
from linkpred_tpu_torch.predict import plan, scoring

ALL = list(lt.METRICS)
OPTS = dict(max_edges=10_000)


def _check_oracle(got, gr, d1, sources=None):
    for name, res in got.items():
        pairs = oracle_scores(gr, name, d1, sources=sources)
        assert len(res) == min(OPTS["max_edges"], len(pairs)) > 0, name
        for (u, v), s in _rows(res).items():
            assert np.isclose(s, pairs[(u, v)], rtol=1e-5), (name, u, v)


def _edge_plans(gr, d1, cap, sources=None):
    pp = plan.build_plan(_port_graph(gr), d1, cap, slot_budget=0,
                         sources=sources, device="cpu")
    rp = ref_plan.build_plan(gr, d1, cap, slot_budget=0, sources=sources)
    assert not pp.packed and pp.keyed and not rp.packed
    return pp, rp


@pytest.mark.parametrize("d1", [0, 4])
def test_keyed_edge_stream_vs_reference_and_oracle(rng, d1):
    gr = random_graph(rng, 150, 5)
    pp, rp = _edge_plans(gr, d1, 4096)
    launches = ft.LAUNCHES
    got = lt.predict_links_multi(_port_graph(gr), ALL, min_degree1=d1,
                                 plan=pp, options=lt.PredictOptions(**OPTS),
                                 device="cpu")
    assert ft.LAUNCHES == launches, "CPU tensors take the twin"
    want = lp.predict_links_multi(gr, ALL, min_degree1=d1, plan=rp,
                                  options=lp.PredictOptions(**OPTS))
    for name in ALL:
        _assert_same_result(got[name], want[name], name)
    _check_oracle(got, gr, d1)


@pytest.mark.parametrize("d1", [0, 4])
def test_sentinel_edge_stream_vs_reference_and_oracle(rng, monkeypatch, d1):
    gr = random_graph(rng, 120, 5)
    pp, rp = _edge_plans(gr, d1, 4096)
    calls = []
    real = scoring._sentinel_reduce
    monkeypatch.setattr(scoring, "_sentinel_reduce",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = lt.predict_links_multi(_port_graph(gr), ALL, min_degree1=d1,
                                 plan=dataclasses.replace(pp, keyed=False),
                                 options=lt.PredictOptions(**OPTS),
                                 device="cpu")
    assert calls, "test premise: the sentinel branch ran"
    monkeypatch.setenv("LINKPRED_EDGE_SENTINEL", "1")
    want = lp.predict_links_multi(gr, ALL, min_degree1=d1, plan=rp,
                                  options=lp.PredictOptions(**OPTS))
    for name in ALL:
        _assert_same_result(got[name], want[name], name)
    _check_oracle(got, gr, d1)


def test_edge_stream_serving_mode(rng):
    """Directed candidates (w != u) over the edge stream: the per-slot
    ``w == u`` dead test and the killer rows' bitwise-NOT sources."""
    gr = random_graph(rng, 150, 5)
    sources = np.array([3, 17, 42, 99])
    pp, rp = _edge_plans(gr, 0, 4096, sources=sources)
    assert not pp.upper_only
    got = lt.predict_links_multi(_port_graph(gr), ALL, min_degree1=0,
                                 plan=pp, sources=sources, device="cpu",
                                 options=lt.PredictOptions(**OPTS))
    want = lp.predict_links_multi(gr, ALL, min_degree1=0, plan=rp,
                                  sources=sources,
                                  options=lp.PredictOptions(**OPTS))
    for name in ALL:
        _assert_same_result(got[name], want[name], name)
        assert set(np.unique(got[name].u)) <= set(sources.tolist())
    _check_oracle(got, gr, 0, sources=sources)


def test_edge_stream_segmented_selection(rng, monkeypatch):
    """A many-tile edge plan with the segment bound shrunk: the pass
    selects per segment and merges the winners, as IHub does at scale."""
    gr = random_graph(rng, 300, 6)
    pp, rp = _edge_plans(gr, 0, 256)
    assert pp.num_tiles_padded >= 8, "test premise: many tiles"
    names = ["jaccard_coefficient", "adamic_adar", "common_neighbors"]
    # 3 metrics: seg lanes = SEG_LANES * 12 // 20 -> 3 tiles of 256
    monkeypatch.setattr(scoring, "SEG_LANES", 1280)
    calls = []
    real = scoring._merge_stacked
    monkeypatch.setattr(scoring, "_merge_stacked",
                        lambda *a: calls.append(1) or real(*a))
    opts = dict(max_edges=900)
    got = lt.predict_links_multi(_port_graph(gr), names, min_degree1=0,
                                 plan=pp, options=lt.PredictOptions(**opts),
                                 device="cpu")
    assert calls, "test premise: the segmented branch ran"
    want = lp.predict_links_multi(gr, names, min_degree1=0, plan=rp,
                                  options=lp.PredictOptions(**opts))
    for name in names:
        _assert_same_result(got[name], want[name], name)


def test_reference_edge_plan_through_port_scorer(rng):
    """The reference's own edge plan (with a hub sub-plan), carried over
    with convert.plan_from_fields, gives the reference's results."""
    gr = powerlaw_graph(rng, n=300, m=2000)
    rp = ref_plan.build_plan(gr, 0, 512, slot_budget=0)
    assert not rp.packed and rp.huge_plan is not None
    pp = convert.plan_from_fields(**dataclasses.asdict(rp))
    names = ["jaccard_coefficient", "resource_allocation", "hub_promoted"]
    got = lt.predict_links_multi(_port_graph(gr), names, min_degree1=0,
                                 plan=pp, options=lt.PredictOptions(**OPTS),
                                 device="cpu")
    want = lp.predict_links_multi(gr, names, min_degree1=0, plan=rp,
                                  options=lp.PredictOptions(**OPTS))
    for name in names:
        _assert_same_result(got[name], want[name], name)


@pytest.mark.parametrize("upper_only", [True, False])
def test_edge_tile_vs_reference_tile(rng, upper_only):
    """One edge tile, lane for lane: the port's ``tile_candidates`` (slot
    map, gathers, int64 sort, K1's twin with killers) against the
    reference's keyed XLA tile on the same plan arrays."""
    gr = random_graph(rng, 200, 6)
    sources = None if upper_only else np.arange(0, 200, 3)
    pp, rp = _edge_plans(gr, 0, 1024, sources=sources)
    names = ("jaccard_coefficient", "adamic_adar", "salton_cosine_similarity")
    t0, t1 = int(pp.tile_edge_start[0]), int(pp.tile_edge_start[1])
    stream = pp.device_stream("cpu", weighted=True)
    gp = _port_graph(gr)
    keys, ku, kw = scoring.tile_candidates(
        torch.as_tensor(gp.indices), torch.as_tensor(gp.degrees), stream,
        t0, t1, metrics=[lt.METRICS[m] for m in names], cap=pp.cap, maxf2=0,
        min_score=0.0, w_bits=pp.w_bits, deg16=pp.deg16,
        upper_only=upper_only)
    fe = tuple(jnp.asarray(a) for a in (rp.fe_work, rp.fe_adr, rp.fe_usrc,
                                        rp.fe_middeg))
    scores, rku, rkw = ref_scoring.tile_candidates(
        jnp.asarray(gr.indices), jnp.asarray(gr.degrees), *fe, t0, t1,
        metrics=tuple(ref_metrics.METRICS[m] for m in names), cap=rp.cap,
        maxf2=0, min_score=jnp.float32(0.0), w_bits=rp.w_bits,
        deg16=rp.deg16, upper_only=upper_only, key64=True, fused=False)
    np.testing.assert_array_equal(ku.numpy(), np.asarray(rku))
    np.testing.assert_array_equal(kw.numpy(), np.asarray(rkw))
    scores = np.asarray(scores)
    for i, name in enumerate(names):
        got = desc_key_score(keys[i]).numpy()
        np.testing.assert_array_equal(np.isneginf(got),
                                      np.isneginf(scores[i]))
        fin = np.isfinite(scores[i])
        assert fin.sum() > 0, name
        np.testing.assert_allclose(got[fin], scores[i][fin], rtol=1e-5)


def test_edge_window_past_stream_raises(rng):
    gr = random_graph(rng, 100, 4)
    pp, _ = _edge_plans(gr, 0, 1024)
    stream = pp.device_stream("cpu")
    gp = _port_graph(gr)
    with pytest.raises(ValueError, match="runs past"):
        scoring.tile_candidates(
            torch.as_tensor(gp.indices), torch.as_tensor(gp.degrees), stream,
            int(pp.fe_work.shape[0]) - 10, int(pp.fe_work.shape[0]),
            metrics=[lt.METRICS["common_neighbors"]], cap=pp.cap, maxf2=0,
            min_score=0.0, w_bits=pp.w_bits, deg16=pp.deg16, upper_only=True)


def _cummax_slot_map(fe_work, t_start, t_end, cap):
    """The oracle: the reference's slot map (``scoring.py`` of
    ``linkpred_tpu``, ``.at[pos].max(iota, mode="drop")`` + ``cummax``) as
    the port first carried it.  Over the whole window, rows past the tile
    masked: each row with work writes its id at its first slot, the rest
    go to a drop slot, and a running max fills the lanes.  Returns
    ``(eloc, eprefix, total)`` over the window's ``cap`` rows."""
    iota = torch.arange(cap, dtype=torch.int32)
    ework = torch.where(iota < (t_end - t_start),
                        fe_work[t_start: t_start + cap], 0)
    incl = torch.cumsum(ework, 0, dtype=torch.int32)
    eprefix = incl - ework
    pos = torch.where(ework > 0, eprefix, cap).to(torch.int64)
    starts = torch.zeros(cap + 1, dtype=torch.int32)
    starts.scatter_reduce_(0, pos, iota, reduce="amax")
    return torch.cummax(starts[:cap], 0).values.to(torch.int64), eprefix, \
        incl[-1]


CAP = 16
# (rows of the tile, rows of the next tile inside the window); a tile's
# rows carry at most CAP slots
SLOT_TILES = {
    "zero-work rows at the start, middle and end": (
        [0, 0, 3, 0, 2, 0, 0, 4, 1, 0, 0], [5, 2, 7]),
    "one row fills the tile": ([CAP], [3, 1]),
    "one row fills the tile between zero-work rows": ([0, CAP, 0], [9]),
    "every row without work": ([0, 0, 0, 0], [4, 4]),
    "one row without work": ([0], [6]),
    "no row": ([], [3, 3]),
    "rows up to the cap, then the next tile": ([2] * 8, [1] * 20),
    "more zero-work rows than lanes": ([0] * (CAP + 5) + [4], [2]),
}


def _slot_stream(rows, nxt, t_start, rng):
    """An edge stream with ``t_start`` rows before the tile, the tile's
    ``rows``, the next tile's ``nxt`` and padding to a full window.  Each
    row's source is its own index (every third row a killer, stored as
    ``~index``), so the gathered ``u`` names the row a lane read."""
    work = np.concatenate([rng.integers(0, 5, t_start), rows, nxt,
                           np.zeros(CAP, np.int64)]).astype(np.int32)
    m = work.shape[0]
    ids = np.arange(m, dtype=np.int32)
    usrc = np.where(ids % 3 == 2, ~ids, ids).astype(np.int32)
    adr = rng.integers(0, 200, m).astype(np.int32)
    middeg = rng.integers(1, 50, m).astype(np.int32)
    return tuple(torch.as_tensor(a) for a in (work, adr, usrc, middeg))


def _check_slots(stream, indices, t_start, t_end):
    """``_slot_map``'s rows and ``_edge_slots``' gathers against the
    oracle's map on every lane, the dead ones included."""
    fe_work, fe_adr, fe_usrc, fe_middeg = stream
    want, eprefix, total = _cummax_slot_map(fe_work, t_start, t_end, CAP)
    rows, _, got_total, eloc = scoring._slot_map(
        fe_work, t_start, t_end, torch.arange(CAP, dtype=torch.int32))
    np.testing.assert_array_equal(eloc.numpy(), want.numpy())
    assert int(got_total) == int(total)
    iota, svalid, w, u, real, dmid = scoring._edge_slots(
        indices, stream, t_start, t_end, cap=CAP, weighted=True)
    win = slice(t_start, t_start + CAP)
    adr = ((fe_adr[win] - eprefix)[want] + iota).clamp(
        max=indices.shape[0] - 1)
    raw = fe_usrc[win][want]
    np.testing.assert_array_equal(u.numpy(), (t_start + want).numpy())
    np.testing.assert_array_equal(real.numpy(), (raw >= 0).numpy())
    np.testing.assert_array_equal(w.numpy(), indices[adr.long()].numpy())
    np.testing.assert_array_equal(dmid.numpy(), fe_middeg[win][want].numpy())
    np.testing.assert_array_equal(svalid.numpy(), (iota < total).numpy())


@pytest.mark.parametrize("case", list(SLOT_TILES))
@pytest.mark.parametrize("t_start", [0, 5])
def test_edge_slot_map_vs_cummax_oracle(rng, case, t_start):
    """The edge tile's slot map (a binary search of the tile's own rows)
    gives every lane the row the reference's scatter-max + cummax gives it:
    zero-work rows anywhere, a row that fills the tile, a tile without
    work, and the next tile's rows inside the window, which must not leak
    in."""
    rows, nxt = SLOT_TILES[case]
    stream = _slot_stream(rows, nxt, t_start, rng)
    indices = torch.as_tensor(rng.integers(0, 1000, 300).astype(np.int32))
    _check_slots(stream, indices, t_start, t_start + len(rows))


def test_edge_slot_map_random_tiles_vs_cummax_oracle(rng):
    """500 random tiles: row counts 0-24 (zero-work rows one in three),
    slot totals up to the cap, next-tile rows in the window."""
    indices = torch.as_tensor(rng.integers(0, 1000, 300).astype(np.int32))
    for _ in range(500):
        nrows = int(rng.integers(0, 25))
        rows = np.where(rng.random(nrows) < 1 / 3, 0,
                        rng.integers(1, 6, nrows))
        while rows.sum() > CAP:
            rows[int(np.argmax(rows))] -= 1
        nxt = rng.integers(0, 6, int(rng.integers(0, 8)))
        t_start = int(rng.integers(0, 7))
        _check_slots(_slot_stream(rows, nxt, t_start, rng), indices,
                     t_start, t_start + nrows)


def _star_ring(n_leaves=900, n_sat=50):
    """tests/test_predict.py's mega-hub graph (a hub 0 joined to every leaf
    of a ring), plus satellites hung on the first leaves, so the hub has
    second-order candidates."""
    leaves = np.arange(1, 1 + n_leaves)
    ring = leaves % n_leaves + 1
    sat = 1 + n_leaves + np.arange(n_sat)
    e = np.concatenate([np.stack([np.zeros(n_leaves, np.int64), leaves], 1),
                        np.stack([leaves, ring], 1),
                        np.stack([leaves[:n_sat], sat], 1)])
    return (np.concatenate([e[:, 0], e[:, 1]]),
            np.concatenate([e[:, 1], e[:, 0]]))


@pytest.mark.parametrize("maxf2,upper_only", [(0, True), (1, True),
                                              (0, False)])
def test_host_scorer_vs_reference(rng, maxf2, upper_only):
    gr = powerlaw_graph(rng, n=250, m=1800)
    hubs = np.argsort(np.asarray(gr.degrees))[-3:].astype(np.int64)
    names = ["jaccard_coefficient", "adamic_adar", "common_neighbors"]
    got = scoring.score_huge_sources_host_multi(
        _port_graph(gr), hubs, [lt.METRICS[m] for m in names], 0, maxf2,
        0.0, k=40, upper_only=upper_only)
    want = ref_scoring.score_huge_sources_host_multi(
        gr, hubs, [ref_metrics.METRICS[m] for m in names], 0, maxf2, 0.0,
        k=40, upper_only=upper_only)
    for name in names:
        (gs, gu, gv), (ws, wu, wv) = got[name], want[name]
        assert gs.size > 0 and gs.dtype == ws.dtype and gu.dtype == wu.dtype
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gu, wu)
        np.testing.assert_array_equal(gv, wv)
    single = scoring.score_huge_sources_host(
        _port_graph(gr), hubs, lt.METRICS["adamic_adar"], 0, maxf2, 0.0,
        k=40, upper_only=upper_only)
    for a, b in zip(single, got["adamic_adar"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("slot_budget", [None, 0])
def test_mega_hub_host_scorer_in_predict(monkeypatch, slot_budget):
    """A hub past HUGE_DEVICE_MAX goes to plan.host_src and the host
    scorer; its rows merge with the device rows (packed or edge stream)."""
    monkeypatch.setattr(plan, "HUGE_DEVICE_MAX", 2048)
    monkeypatch.setattr(ref_plan, "HUGE_DEVICE_MAX", 2048)
    src, dst = _star_ring()
    gr, gp = lp.from_edges(src, dst), lt.from_edges(src, dst)
    pp = plan.build_plan(gp, 8, 1024, slot_budget=slot_budget, device="cpu")
    assert 0 in pp.host_src
    assert pp.packed == (slot_budget is None)
    rp = ref_plan.build_plan(gr, 8, 1024, slot_budget=slot_budget)
    names = ["jaccard_coefficient", "adamic_adar"]
    opts = dict(max_edges=20_000)
    got = lt.predict_links_multi(gp, names, min_degree1=8, plan=pp,
                                 options=lt.PredictOptions(**opts),
                                 device="cpu")
    want = lp.predict_links_multi(gr, names, min_degree1=8, plan=rp,
                                  options=lp.PredictOptions(**opts))
    for name in names:
        _assert_same_result(got[name], want[name], name)
        pairs = oracle_scores(gr, name, 8)
        assert len(got[name]) == min(20_000, len(pairs))
        assert any(u == 0 for u, _ in _rows(got[name])), "hub rows merged"
        for (u, v), s in _rows(got[name]).items():
            assert np.isclose(s, pairs[(u, v)], rtol=1e-5)
