"""The merge of each metric's winners on the device
(``predict.api._merge_winners``) on the CPU, bit for bit against the host
merge it replaced, which this file keeps as its oracle
(:func:`host_merge`): the same rows, in the same order, with the same
score bits.  Synthetic winners (ties inside a pass and across passes, +-inf
and NaN, -0.0 against +0.0, the host scorer's rows appended last, empty
parts, fewer finite rows than ``max_edges``, nine metrics with different
finite counts), and ``predict_links_multi(device="cpu")`` on a single, a
segmented, a side-and-hub and a host-hub plan against the oracle over the
winners the call's timed scoring produced.  Also the ``merge`` item of
``device_bytes`` and the memory check that refuses a pass whose merge does
not fit.

Every graph is small (n <= 300) but the side-and-hub one, which needs a
vertex of degree 2^16 for the wide-degree side plan (~71k vertices, under
a second)."""
import numpy as np
import pytest
import torch

from conftest import random_graph

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import convert
from linkpred_tpu_torch.ops.topk import TopK
from linkpred_tpu_torch.parallel import mesh as pmesh
from linkpred_tpu_torch.predict import api, plan, scoring
from linkpred_tpu_torch.predict.metrics import METRICS
from linkpred_tpu_torch.utils import profiling
from linkpred_tpu_torch.utils.profiling import counter

NINE = tuple(METRICS)


def host_merge(tops, host_rows, names, max_edges):
    """The host merge ``predict_links_multi`` ran before the merge moved to
    the device: each pass's winners copied back, the host scorer's rows
    appended, the non-finite scores dropped, a stable descending argsort.
    ``{name: (u, v, score)}``."""
    out = {}
    for i, name in enumerate(names):
        parts = [(t.scores[i].cpu().numpy(), t.u[i].cpu().numpy(),
                  t.v[i].cpu().numpy()) for t in tops]
        if name in host_rows:
            parts.append(host_rows[name])
        scores, us, vs = (np.concatenate(x) for x in zip(*parts))
        valid = np.isfinite(scores)
        scores, us, vs = scores[valid], us[valid], vs[valid]
        order = np.argsort(-scores, kind="stable")[:max_edges]
        out[name] = (us[order].astype(np.int32), vs[order].astype(np.int32),
                     scores[order].astype(np.float32))
    return out


def device_merge(tops, host_rows, names, max_edges):
    """``_merge_winners`` on the CPU, split back into ``{name: (u, v,
    score)}`` as ``predict_links_multi`` splits it."""
    rows, lengths = api._merge_winners(tops, host_rows, names, max_edges,
                                       torch.device("cpu"))
    back, out, start = rows.numpy(), {}, 0
    assert back.dtype == np.int32 and back.shape == (3, sum(lengths))
    for name, n in zip(names, lengths):
        r = back[:, start:start + n]
        start += n
        out[name] = (r[1], r[2], r[0].view(np.float32))
    return out


def assert_bit_equal(got, want, names):
    for name in names:
        for f, a, b in zip(("u", "v", "score"), got[name], want[name]):
            assert a.dtype == b.dtype, (name, f)
            np.testing.assert_array_equal(
                a.view(np.int32), b.view(np.int32), err_msg=f"{name}.{f}")


def _tops(scores, rng):
    """A pass's winners ``TopK [M, k]`` with the given scores and distinct
    pairs, so that any change of order shows in ``u`` and ``v``."""
    s = torch.as_tensor(np.asarray(scores, dtype=np.float32))
    ids = rng.permutation(2 * s.numel()).astype(np.int32)
    u = torch.as_tensor(ids[:s.numel()]).reshape(s.shape)
    v = torch.as_tensor(ids[s.numel():]).reshape(s.shape)
    return TopK(s, u, v)


def _host(scores, rng):
    s = np.asarray(scores, dtype=np.float32)
    return (s, rng.integers(0, 1 << 30, s.shape[0]).astype(np.int32),
            rng.integers(0, 1 << 30, s.shape[0]).astype(np.int32))


NAN = np.float32(np.nan)
NEG_NAN = np.array([0xFFC00001], dtype=np.uint32).view(np.float32)[0]


def _case(name, rng):
    """``(tops, host_rows, names, max_edges)`` of one synthetic case."""
    two = ("common_neighbors", "adamic_adar")
    if name == "ties":
        # three distinct scores over three passes: ties inside and across
        return ([_tops(rng.choice([1.0, 2.0, 3.0], (2, k)), rng)
                 for k in (40, 25, 7)], {}, two, 50)
    if name == "nonfinite":
        pool = [np.inf, -np.inf, NAN, NEG_NAN, 1.5, 2.5, -3.0, 0.25]
        return ([_tops(rng.choice(pool, (2, k)), rng) for k in (60, 30)],
                {}, two, 40)
    if name == "signed_zero":
        # what a negative min_score lets through: -0.0 ties with +0.0
        pool = np.array([0.0, -0.0, -0.5, 0.5, -0.0], dtype=np.float32)
        return ([_tops(rng.choice(pool, (2, k)), rng) for k in (50, 20)],
                {}, two, 45)
    if name == "host_rows":
        tops = [_tops(rng.choice([1.0, 2.0], (2, k)), rng) for k in (30, 10)]
        host = {two[0]: _host(rng.choice([1.0, 2.0, np.inf], 12), rng),
                two[1]: _host(rng.choice([2.0, -np.inf], 5), rng)}
        return tops, host, two, 35
    if name == "empty_parts":
        tops = [_tops(np.empty((2, 0)), rng),
                _tops(rng.choice([1.0, -np.inf], (2, 16)), rng),
                _tops(np.empty((2, 0)), rng)]
        host = {two[0]: _host([], rng), two[1]: _host([4.0, 1.0], rng)}
        return tops, host, two, 10
    if name == "all_empty":
        return ([_tops(np.empty((2, 0)), rng)], {two[0]: _host([], rng)},
                two, 10)
    if name == "short":
        # max_edges beyond the finite rows: all of them, in order
        return ([_tops(rng.choice([1.0, 2.0, -np.inf, NAN], (2, k)), rng)
                 for k in (20, 12)], {}, two, 1000)
    if name == "nine":
        # each metric its own count of finite rows, none for one of them
        k = 64
        s = rng.choice([0.5, 1.0, 2.0], (len(NINE), k)).astype(np.float32)
        for i in range(len(NINE)):
            s[i, rng.permutation(k)[:7 * i + 1]] = -np.inf
        s[3] = -np.inf
        t2 = rng.choice([0.5, 1.0, np.nan], (len(NINE), 9))
        t2[3] = np.nan
        return [_tops(s, rng), _tops(t2, rng)], {}, NINE, 40
    raise AssertionError(name)


CASES = ["ties", "nonfinite", "signed_zero", "host_rows", "empty_parts",
         "all_empty", "short", "nine"]


@pytest.mark.parametrize("case", CASES)
def test_device_merge_is_the_host_merge_bit_for_bit(rng, case):
    tops, host, names, max_edges = _case(case, rng)
    want = host_merge(tops, host, names, max_edges)
    got = device_merge(tops, host, names, max_edges)
    assert_bit_equal(got, want, names)
    for name in names:
        assert len(got[name][0]) <= max_edges


def test_case_premises(rng):
    """What each synthetic case is meant to hold, it holds."""
    tops, _, names, max_edges = _case("signed_zero", rng)
    got = host_merge(tops, {}, names, max_edges)
    bits = got[names[0]][2].view(np.int32)
    assert (bits == 0).any() and (bits == np.int32(-2**31)).any()
    tops, _, names, max_edges = _case("short", rng)
    got = host_merge(tops, {}, names, max_edges)
    assert all(0 < len(got[n][0]) < max_edges for n in names)
    tops, _, names, max_edges = _case("nine", rng)
    lens = [len(x[0]) for x in host_merge(tops, {}, names, max_edges)
            .values()]
    assert len(set(lens)) > 3 and 0 in lens and max(lens) == max_edges
    tops, host, names, _ = _case("host_rows", rng)
    s = np.concatenate([t.scores[0].numpy() for t in tops])
    assert np.isin(host[names[0]][0], s).any(), "host rows tie pass rows"


# ------------------------------------------- through predict_links_multi

def _port(gr):
    return convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                     gr.n, gr.m)


def _side_and_hub_graph():
    """A 200-vertex random part, 16 satellites of 4,096 connectors each
    and one of 5,000, every connector tied to one hub of degree 70,096:
    at hub threshold 16 and cap 8,192 the satellites' pairs with the hub
    ride the wide-degree side plan and the big satellite's a hub
    sub-plan."""
    rng = np.random.default_rng(7)
    a, b = rng.integers(0, 200, 600), rng.integers(0, 200, 600)
    sizes = [4096] * 16 + [5000]
    sats = 200 + np.arange(len(sizes))
    cons = 200 + len(sizes) + np.arange(sum(sizes))
    hub = int(cons[-1]) + 1
    e = np.concatenate([np.stack([a[a != b], b[a != b]], 1),
                        np.stack([np.repeat(sats, sizes), cons], 1),
                        np.stack([cons, np.full(cons.size, hub)], 1)])
    return lt.from_edges(np.concatenate([e[:, 0], e[:, 1]]),
                         np.concatenate([e[:, 1], e[:, 0]]), n=hub + 1)


def _plan_case(name, rng, mp):
    """``(graph, plan, d1, options)`` of one plan case, its premise
    checked."""
    opts = lt.PredictOptions(max_edges=400)
    if name == "single":
        gp = _port(random_graph(rng, 300, 6))
        p = plan.build_plan(gp, 0, 1 << 16, device="cpu")
        assert p.packed and not api._sub_plans(p) and p.num_tiles == 1
        return gp, p, 0, opts
    if name == "segmented":
        mp.setattr(scoring, "SEG_LANES", 4096)
        gp = _port(random_graph(rng, 300, 6))
        p = plan.build_plan(gp, 0, 256, device="cpu")
        assert scoring._segments(p.num_tiles_padded, p.cap, len(NINE),
                                 "cpu")[0] > 1
        return gp, p, 0, opts
    if name == "side_and_hub":
        gp = _side_and_hub_graph()
        p = plan.build_plan(gp, 16, 8192, device="cpu")
        assert p.side_plan is not None and p.huge_plan is not None
        return gp, p, 16, opts
    if name == "host_hubs":
        mp.setattr(plan, "HUGE_DEVICE_MAX", 1)
        gp = _port(random_graph(rng, 200, 3))
        p = plan.build_plan(gp, 0, 32, device="cpu")
        assert p.host_src.size and p.num_tiles
        return gp, p, 0, opts
    if name == "negative_min_score":
        gp = _port(random_graph(rng, 300, 6))
        p = plan.build_plan(gp, 0, 1024, device="cpu")
        return gp, p, 0, lt.PredictOptions(max_edges=300, min_score=-1.0)
    if name == "short":
        gp = _port(random_graph(rng, 120, 3))
        p = plan.build_plan(gp, 0, 1024, device="cpu")
        return gp, p, 0, lt.PredictOptions(max_edges=10 ** 5)
    raise AssertionError(name)


@pytest.mark.parametrize("case", ["single", "segmented", "side_and_hub",
                                  "host_hubs", "negative_min_score",
                                  "short"])
def test_predict_links_multi_merges_like_the_host(rng, monkeypatch, case):
    """The call's results are the host merge of the winners its timed
    scoring produced (and of the host scorer's rows), bit for bit; the
    counters say how many rows entered the merge and how many came
    back."""
    gp, p, d1, opts = _plan_case(case, rng, monkeypatch)
    tops, host = [], []
    real_score, real_host = api.score_tiles, api.score_huge_sources_host_multi
    monkeypatch.setattr(api, "score_tiles", lambda *a, **kw: tops.append(
        real_score(*a, **kw)) or tops[-1])
    monkeypatch.setattr(api, "score_huge_sources_host_multi",
                        lambda *a, **kw: host.append(real_host(*a, **kw))
                        or host[-1])
    profiling.reset_counters()
    res = lt.predict_links_multi(gp, NINE, min_degree1=d1, plan=p,
                                 options=opts, device="cpu")
    timed = tops[-len([p, *api._sub_plans(p)]):]
    host_rows = host[0] if host else {}
    assert bool(host_rows) == bool(p.host_src.size)
    want = host_merge(timed, host_rows, NINE, opts.max_edges)
    assert_bit_equal({n: (r.u, r.v, r.score) for n, r in res.items()}, want,
                     NINE)
    rows = sum(int(t.scores.shape[1]) for t in timed)
    hosted = sum(host_rows[n][0].shape[0] for n in host_rows)
    assert counter("api.merge_rows") == len(NINE) * rows + hosted
    assert counter("api.rows_back") == sum(len(r) for r in res.values())
    assert all(0 < len(r) <= opts.max_edges for r in res.values())
    if case == "short":
        assert all(len(r) < opts.max_edges for r in res.values())


def test_results_do_not_share_memory_across_calls(rng):
    """Each call's arrays are its own: a later call neither reuses nor
    writes them."""
    gp = _port(random_graph(rng, 200, 6))
    p = plan.build_plan(gp, 0, 1024, device="cpu")
    call = lambda: lt.predict_links_multi(  # noqa: E731
        gp, ("cn", "aa"), min_degree1=0, plan=p, device="cpu",
        options=lt.PredictOptions(max_edges=200))
    first = call()
    kept = {n: (r.u.copy(), r.v.copy(), r.score.copy())
            for n, r in first.items()}
    second = call()
    for n, r in first.items():
        assert_bit_equal({n: (r.u, r.v, r.score)}, {n: kept[n]}, [n])
        for a in (r.u, r.v, r.score):
            for b in (second[n].u, second[n].v, second[n].score):
                assert not np.shares_memory(a, b)


# ----------------------------------------------- the merge's device bytes

def test_device_bytes_prices_the_merge(rng, monkeypatch):
    """The ``merge`` item: ``k`` rows a pass with tiles, ``D x k`` a pass
    under a mesh of ``D > 1`` ranks (and ``min(k, n)`` a host-scored hub)
    x ``MERGE_BYTES_PER_ROW``, and every metric's merged rows twice; the
    ``gather`` item is the mesh's ``gather_bytes``."""
    gp = _port(random_graph(rng, 200, 6))
    for kw in (dict(), dict(slot_budget=0)):
        p = plan.build_plan(gp, 0, 256, device="cpu", **kw)
        passes = [p, *api._sub_plans(p)]
        k = api._exact_k(p, 300)
        need = api.device_bytes(gp, passes, 3, k, False, "cpu")
        rows = sum(k for q in passes if q.num_tiles_padded)
        assert need["merge"] == (rows * api.MERGE_BYTES_PER_ROW
                                 + 2 * 3 * min(k, rows) * 12) > 0
        assert need["total"] == sum(v for n, v in need.items()
                                    if n != "total")
    # under a mesh of D > 1 ranks every rank joins the gather with k rows,
    # tiles or not: D x k a pass
    for d in (2, 4):
        for r in range(d):
            mesh = pmesh.Mesh(group=None, device=torch.device("cpu"),
                              rank=r, size=d)
            need = api.device_bytes(gp, passes, 3, k, False, "cpu", mesh)
            rows = len(passes) * d * k
            assert need["merge"] == (rows * api.MERGE_BYTES_PER_ROW
                                     + 2 * 3 * min(k, rows) * 12)
            assert need["gather"] == pmesh.gather_bytes(mesh, 3, k) == \
                2 * d * 3 * 3 * k * 4
    monkeypatch.setattr(plan, "HUGE_DEVICE_MAX", 1)
    p = plan.build_plan(gp, 0, 32, device="cpu")
    assert p.host_src.size, "test premise"
    passes = [p, *api._sub_plans(p)]
    k = api._exact_k(p, 300)
    rows = (p.host_src.size * min(k, gp.n)
            + sum(k for q in passes if q.num_tiles_padded))
    assert api.device_bytes(gp, passes, 1, k, False, "cpu")["merge"] == \
        rows * api.MERGE_BYTES_PER_ROW + 2 * min(k, rows) * 12


def test_memory_check_refuses_a_merge_that_does_not_fit(rng, monkeypatch):
    """Free memory for every item but the merge refuses the pass before
    anything is uploaded, and the message names the merge's bytes; at the
    total it runs."""
    gp = _port(random_graph(rng, 200, 6))
    p = plan.build_plan(gp, 0, 1024, device="cpu")
    names = ("cn", "jaccard", "aa")
    need = api.device_bytes(gp, [p, *api._sub_plans(p)], len(names),
                            api._exact_k(p, 50), True, "cpu")
    call = lambda: lt.predict_links_multi(  # noqa: E731
        gp, names, min_degree1=0, plan=p, device="cpu",
        options=lt.PredictOptions(max_edges=50))
    for free in (need["total"] - need["merge"], need["total"] - 1):
        monkeypatch.setattr(api, "free_bytes", lambda d, free=free: free)
        with pytest.raises(MemoryError, match=rf"merge {need['merge']}\b"):
            call()
        assert p._device == {}, "uploaded before the check"
    monkeypatch.setattr(api, "free_bytes", lambda d: need["total"])
    assert all(len(r) > 0 for r in call().values())


def test_a_cards_total_memory_is_read_once(monkeypatch):
    """Budgets size from the card's total memory, read from the card once
    per card and not on every plan and pass; the free memory the check
    reads stays live."""
    from linkpred_tpu_torch.utils import device as dev

    reads = []

    def mem_get_info(index):
        reads.append(index)
        return (len(reads) << 30, 80 << 30)

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 0)
    dev._card_bytes.cache_clear()
    try:
        assert dev.hbm_bytes("cuda:0") == 80 << 30
        budgets = [dev.auto_slot_budget("cuda:0"), dev.auto_seg_lanes("cuda:0")]
        assert budgets == [(1 << 31) - (1 << 22), 1 << 29]   # both capped
        assert reads == [0]
        assert dev.hbm_bytes("cuda:1") == 80 << 30 and reads == [0, 1]
        assert dev.free_bytes("cuda:0") == 3 << 30
        assert dev.free_bytes("cuda:0") == 4 << 30
    finally:
        dev._card_bytes.cache_clear()
