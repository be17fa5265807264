"""The port's sharded pass (``linkpred_tpu_torch.parallel``) on the CPU with
gloo, against the JAX package's ``parallel.mesh`` on the 8-device virtual
CPU mesh of tests/conftest.py, the port's single-process pass and the
dense oracle; and the port's own device-memory check (C3).

* ``pad_tiles_for_mesh`` is bit-equal to the reference's.
* ``shard_layout``'s cuts and block-local tile bounds equal those of the
  reference's ``shard_stream_for_mesh`` for the same plan (carried across
  with ``convert.plan_from_fields``), packed and edge; each rank's block
  equals the reference's row d up to the reference's power-of-two padding,
  and the port pads by ``_pad_bucket`` (C2 is not copied).
* World sizes 2 and 8 through ``python -m linkpred_tpu_torch.parallel.sim``
  (rank processes meeting through a ``file://`` store): rank 0's results
  equal the port's single-process pass exactly up to ties at the k-th
  score, agree with ``linkpred_tpu.predict_links_multi(mesh=make_mesh(8))``
  within rtol 1e-5, and with the dense oracle within rtol 1e-5.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import powerlaw_graph, random_graph
from oracle import oracle_scores, oracle_topk_scores

import linkpred_tpu as lp
from linkpred_tpu.parallel import mesh as ref_mesh
from linkpred_tpu.predict import plan as ref_plan

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import convert
from linkpred_tpu_torch.bench.synth import rmat_graph
from linkpred_tpu_torch.io.npz import save_graph
from linkpred_tpu_torch.parallel import distributed
from linkpred_tpu_torch.parallel import mesh as pmesh
from linkpred_tpu_torch.parallel import sim
from linkpred_tpu_torch.predict import api, plan, scoring
from linkpred_tpu_torch.utils.numeric import next_pow2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIM_TIMEOUT = 300


@pytest.fixture(scope="module")
def mesh8():
    import jax

    assert jax.device_count() >= 8
    return ref_mesh.make_mesh(8)


def _port_graph(gr):
    return convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                     gr.n, gr.m)


def _rows(res):
    return {(int(u), int(v)): float(s)
            for u, v, s in zip(res.u, res.v, res.score)}


def _agree(got, want, where, rtol=1e-5):
    """Same length, score multisets within ``rtol``, the same pairs above
    the k-th score."""
    assert len(got) == len(want), where
    if not len(want):
        return
    np.testing.assert_allclose(np.sort(got.score), np.sort(want.score),
                               rtol=rtol, err_msg=where)
    cut = want.score.min() * (1 + 1e-5)
    assert ({p for p, s in _rows(got).items() if s > cut}
            == {p for p, s in _rows(want).items() if s > cut}), where


# ------------------------------------------------------------ the layout

@pytest.mark.parametrize("tes,d", [
    ([0, 5, 9, 12, 12], 3),
    ([0, 5, 9, 12, 12], 4),
    ([0, 3, 3, 8, 20, 21, 30], 2),
    ([0, 7], 8),
], ids=["4t-3d", "4t-4d", "6t-2d", "1t-8d"])
def test_pad_tiles_for_mesh_matches_reference(tes, d):
    tes = np.asarray(tes, dtype=np.int32)
    for empty_at in (None, 99):
        got = pmesh.pad_tiles_for_mesh(tes, d, empty_at)
        want = ref_mesh.pad_tiles_for_mesh(tes, d, empty_at)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _ref_and_port_plan(kind):
    rng = np.random.default_rng(3)
    if kind == "packed":
        gr = random_graph(rng, n=400, avg_deg=8)
        rp = ref_plan.build_plan(gr, 0, cap=1024)
        assert rp.packed
    else:
        gr = random_graph(rng, n=300, avg_deg=7)
        rp = ref_plan.build_plan(gr, 0, cap=1024, slot_budget=0)
        assert not rp.packed
    return rp, convert.plan_from_fields(**dataclasses.asdict(rp))


@pytest.mark.parametrize("kind", ["packed", "edge"])
@pytest.mark.parametrize("d", [2, 8])
def test_shard_layout_matches_reference(mesh8, kind, d):
    rp, pp = _ref_and_port_plan(kind)
    mesh = mesh8 if d == 8 else ref_mesh.make_mesh(2)
    stream, ts, te = ref_mesh.shard_stream_for_mesh(rp, mesh)
    lay = pmesh.shard_layout(pp, d)
    np.testing.assert_array_equal(lay.tile_s, np.asarray(ts))
    np.testing.assert_array_equal(lay.tile_e, np.asarray(te))
    # the cuts partition the real tiles; each rank's windows sit in its
    # block
    assert lay.cuts[0] == 0 and lay.cuts[-1] == pp.num_tiles
    assert np.all(np.diff(lay.cuts) >= 0)
    assert int(lay.span.sum()) == int(pp.tile_start[pp.num_tiles])
    ref_width = int(stream[0].shape[1])
    assert lay.l_pad == plan._pad_bucket(int(lay.span.max()) + pp.cap)
    assert lay.l_pad <= ref_width == next_pow2(int(lay.span.max()) + pp.cap)
    for r in range(d):
        got = pmesh.block_arrays(pp, lay, r, weighted=True)
        assert len(got) == len(stream)
        for a, ref in zip(got, stream):
            row = np.asarray(ref)[r]
            if a.shape[0] == 1:
                np.testing.assert_array_equal(a, row)
                continue
            assert a.shape == (lay.l_pad,)
            np.testing.assert_array_equal(a, row[: lay.l_pad])
            assert not row[lay.l_pad:].any()


def test_block_just_past_a_power_of_two_is_bucket_padded():
    """C2: a block of 2^10 + 1 window lanes takes _pad_bucket's 1,152, not
    the reference's 2,048."""
    cap, span = 8, (1 << 10) + 1 - 8
    total = 2 * span - 1
    s_pad = plan._pad_bucket(total + cap)
    z = np.zeros(s_pad, dtype=np.int32)
    slot_w = np.arange(s_pad, dtype=np.int32)
    one = np.zeros(1, dtype=np.int32)
    starts = np.asarray([0, span - 1, total], dtype=np.int32)
    p = plan.TilePlan(
        fe_work=one, fe_adr=one, fe_usrc=one, fe_middeg=one,
        tile_edge_start=starts, cap=cap, num_tiles=2,
        huge_src=np.empty(0, np.int64), total_slots=total, huge_slots=0,
        w_bits=11, upper_only=True, deg16=True, keyed=True, packed=True,
        slot_w=slot_w, slot_u=z, slot_udeg=z, slot_wdeg=one, slot_middeg=z,
        tile_slot_start=starts)
    lay = pmesh.shard_layout(p, 2)
    assert list(lay.cuts) == [0, 1, 2] and list(lay.span) == [span - 1, span]
    assert lay.l_pad == 1152 < next_pow2(span + cap) == 2048
    w1 = pmesh.block_arrays(p, lay, 1)[0]
    np.testing.assert_array_equal(w1[: span + cap],
                                  slot_w[span - 1: total + cap])
    assert not w1[span + cap:].any()


@pytest.mark.parametrize("kind", ["lhub-packed", "ihub-edge"])
def test_stream_bytes_per_rank_s15(kind):
    """An s15-class plan: each rank's stream is about the padded total /
    D plus one cap window (VERDICT r5 next #4).  The layout only; no
    process group."""
    g = rmat_graph(15, edge_factor=16, seed=42)
    p = (plan.build_plan(g, 64, device="cpu") if kind == "lhub-packed"
         else plan.build_plan(g, 0, slot_budget=0, device="cpu"))
    assert p.packed == (kind == "lhub-packed")
    arrays = [a for a in p.host_stream(weighted=True) if a.shape[0] > 1]
    total = sum(a.nbytes for a in arrays)
    row = sum(a.itemsize for a in arrays)
    starts = np.asarray(p.tile_start[: p.num_tiles + 1], dtype=np.int64)
    widest = int(np.diff(starts).max())
    for d in (2, 4, 8):
        lay = pmesh.shard_layout(p, d)
        per_rank = [sum(a.nbytes for a in pmesh.block_arrays(
            p, lay, r, weighted=True) if a.shape[0] > 1) for r in range(d)]
        assert per_rank[0] == lay.l_pad * row
        # balanced to within one tile, plus the window tail, plus the
        # bucket's at most 1/8
        assert max(per_rank) <= 1.125 * (total / d + (widest + p.cap) * row)
        assert max(per_rank) < total or d == 1
        assert int(lay.span.sum()) == int(starts[-1])


# --------------------------------------------------- the mesh and group

def test_make_mesh_without_a_group(monkeypatch):
    m = pmesh.make_mesh(device="cpu")
    assert (m.group, m.rank, m.size, m.device.type, m.axis) == \
        (None, 0, 1, "cpu", "workers")
    assert pmesh.make_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="need 2 ranks, have 1"):
        pmesh.make_mesh(2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        pmesh.make_mesh()
    assert distributed.process_info() == (0, 1)


def test_init_distributed_single_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.init_distributed()
    monkeypatch.setenv("WORLD_SIZE", "1")
    distributed.init_distributed()
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="world_size and rank"):
        distributed.init_distributed("file:///nonexistent/x", world_size=2)


def test_default_backend_is_named_from_the_host(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert distributed.default_backend(4, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert distributed.default_backend(1) == "nccl"
    assert distributed.default_backend(2) == "gloo"   # two ranks, one card
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")
    assert distributed.default_backend(4) == "nccl"   # one rank a host


def test_one_rank_mesh_equals_the_plain_pass(rng):
    gr = powerlaw_graph(rng, n=250, m=2000)
    gp = _port_graph(gr)
    names = ["salton_cosine_similarity", "adamic_adar"]
    opts = lt.PredictOptions(max_edges=500)
    mesh = pmesh.make_mesh(device="cpu")
    got = lt.predict_links_multi(gp, names, min_degree1=16, cap=2048,
                                 options=opts, mesh=mesh)
    want = lt.predict_links_multi(gp, names, min_degree1=16, cap=2048,
                                  options=opts, device="cpu")
    for name in names:
        sim.same_result(got[name], want[name], name)


def test_one_rank_mesh_neither_gathers_nor_merges(rng, monkeypatch):
    """A one-rank mesh's own top k is the answer: the pass returns it
    as the plain pass does, with no all-gather and no second selection."""
    gp = _port_graph(powerlaw_graph(rng, n=250, m=2000))
    opts = lt.PredictOptions(max_edges=300)
    want = lt.predict_links(gp, "jaccard", min_degree1=16, cap=2048,
                            options=opts, device="cpu")

    def refuse(*a, **kw):
        raise AssertionError("a one-rank mesh gathered or merged")

    monkeypatch.setattr(pmesh, "gather_topk", refuse)
    monkeypatch.setattr(scoring, "_merge_stacked", refuse)
    got = lt.predict_links(gp, "jaccard", min_degree1=16, cap=2048,
                           options=opts, mesh=pmesh.make_mesh(device="cpu"))
    sim.same_result(got, want, "one rank")


# ------------------------------------------------------ ranks through sim

def _cases(tmp):
    """(spec, {case: (ref graph, kwargs)}) of the sim cases."""
    rng = np.random.default_rng(5)
    graphs = {
        "random": random_graph(rng, n=200, avg_deg=6),
        "edge": random_graph(rng, n=300, avg_deg=7),
        "powerlaw": powerlaw_graph(rng, n=250, m=2000),
        "small": random_graph(rng, n=60, avg_deg=3),
    }
    for name, gr in graphs.items():
        save_graph(_port_graph(gr), os.path.join(tmp, f"{name}.npz"))
    cases = [
        ("lhub_packed", "random", dict(metrics=["jaccard_coefficient"],
                                       min_degree1=16, cap=1024,
                                       max_edges=10_000)),
        ("ihub_edge", "edge", dict(metrics=["adamic_adar"], min_degree1=0,
                                   cap=1024, slot_budget=0,
                                   max_edges=5000)),
        ("multi_metric", "random", dict(
            metrics=["common_neighbors", "jaccard_coefficient",
                     "resource_allocation", "salton_cosine_similarity",
                     "hub_promoted"], min_degree1=0, cap=1024,
            max_edges=3000)),
        ("hub_subplan", "powerlaw", dict(metrics=["jaccard_coefficient",
                                                  "adamic_adar"],
                                         min_degree1=0, cap=512,
                                         max_edges=100_000)),
        ("top25", "random", dict(metrics=["sorensen_index"], min_degree1=0,
                                 cap=1024, max_edges=25)),
        ("few_tiles", "small", dict(metrics=["common_neighbors"],
                                    min_degree1=0, cap=4096,
                                    max_edges=1000)),
        ("serving", "random", dict(metrics=["jaccard_coefficient"],
                                   min_degree1=0, cap=1024, max_edges=2000,
                                   sources=[3, 17, 42, 99, 150, 199])),
    ]
    spec = [dict(name=name, graph=os.path.join(tmp, f"{gname}.npz"), **kw)
            for name, gname, kw in cases]
    return spec, {name: (graphs[gname], kw) for name, gname, kw in cases}


def _run_sim(n, tmp, *extra):
    r = subprocess.run(
        [sys.executable, "-m", "linkpred_tpu_torch.parallel.sim", str(n),
         "--device", "cpu", "--timeout", str(SIM_TIMEOUT - 30), *extra],
        capture_output=True, text=True, timeout=SIM_TIMEOUT, cwd=REPO)
    return r


def _records(out):
    return [json.loads(line.split("SIM ", 1)[1])
            for line in out.splitlines() if "SIM {" in line]


@pytest.fixture(scope="module")
def sim_runs(tmp_path_factory):
    """Rank 0's results of every case at world sizes 2 and 8, and every
    rank's records."""
    tmp = str(tmp_path_factory.mktemp("sim"))
    spec, cases = _cases(tmp)
    with open(os.path.join(tmp, "spec.json"), "w") as f:
        json.dump(spec, f)
    runs = {}
    for n in (2, 8):
        out = os.path.join(tmp, f"out{n}.npz")
        r = _run_sim(n, tmp, "--spec", os.path.join(tmp, "spec.json"),
                     "--out", out)
        assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
        with np.load(out) as z:
            runs[n] = ({k: z[k] for k in z.files}, _records(r.stdout))
    return cases, runs


def _result(arrays, case, name):
    return lt.PredictResult(u=arrays[f"{case}/{name}/u"],
                            v=arrays[f"{case}/{name}/v"],
                            score=arrays[f"{case}/{name}/score"],
                            time_ms=0.0, scoring_ms=0.0)


CASES = ["lhub_packed", "ihub_edge", "multi_metric", "hub_subplan", "top25",
         "few_tiles", "serving"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", [2, 8])
def test_sharded_pass_through_sim(sim_runs, mesh8, world, case):
    cases, runs = sim_runs
    arrays, records = runs[world]
    gr, kw = cases[case]
    gp = _port_graph(gr)
    sources = kw.get("sources")
    opts = dict(max_edges=kw["max_edges"])
    pp = plan.build_plan(gp, kw["min_degree1"], kw["cap"],
                         slot_budget=kw.get("slot_budget"), sources=sources,
                         device="cpu")
    single = lt.predict_links_multi(gp, kw["metrics"], plan=pp,
                                    sources=sources, device="cpu",
                                    options=lt.PredictOptions(**opts))
    rp = ref_plan.build_plan(gr, kw["min_degree1"], kw["cap"],
                             slot_budget=kw.get("slot_budget"),
                             sources=sources)
    ref = lp.predict_links_multi(gr, kw["metrics"], plan=rp, sources=sources,
                                 mesh=mesh8,
                                 options=lp.PredictOptions(**opts))
    mine = [r for r in records if r["case"] == case]
    assert sorted(r["rank"] for r in mine) == list(range(world))
    assert all(r["world"] == world and r["backend"] == "gloo" for r in mine)
    if case == "hub_subplan":
        assert pp.huge_plan is not None and mine[0]["passes"] >= 2
    if case == "few_tiles":
        assert pp.num_tiles < world or world == 2
    for name in kw["metrics"]:
        got = _result(arrays, case, name)
        sim.same_result(got, single[name], f"{case}/{name} single")
        _agree(got, ref[name], f"{case}/{name} jax mesh8")
        pairs = oracle_scores(gr, name, kw["min_degree1"], sources=sources)
        assert len(got) == min(kw["max_edges"], len(pairs)) > 0
        for (u, v), s in _rows(got).items():
            assert np.isclose(s, pairs[(u, v)], rtol=1e-5), (case, name)
        np.testing.assert_allclose(np.sort(got.score)[::-1],
                                   oracle_topk_scores(pairs, len(got)),
                                   rtol=1e-5)


@pytest.mark.parametrize("world", [2, 8])
def test_sim_ranks_print_their_blocks(sim_runs, world):
    """Each rank's stream is at most its share of the padded total plus a
    window tail and the bucket's eighth, and the results agree across
    ranks."""
    _, runs = sim_runs
    _, records = runs[world]
    for r in records:
        if r["passes"] == 1 and r["packed"]:
            # a tile holds at most cap slots, so the cuts leave a rank at
            # most one tile over its share
            assert r["stream_bytes"] <= 1.125 * (
                r["padded_total_bytes"] / world + 2 * r["cap_tail_bytes"]), r
        assert r["priced_bytes"] <= r["free_bytes"]
        assert r["k1_launches"] == r["k2_launches"] == 0   # no card here
    by_case = {}
    for r in records:
        by_case.setdefault(r["case"], set()).add(r["results"])
    assert all(len(v) == 1 for v in by_case.values()), by_case


def test_sim_dryrun(tmp_path):
    r = _run_sim(2, str(tmp_path), "--dryrun")
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    recs = _records(r.stdout)
    assert len(recs) == 2 and recs[0]["results"] == recs[1]["results"] > 0
    assert [x for x in recs if x["rank"] == 0][0]["recall"] > 0


def test_sim_fails_when_a_rank_fails(tmp_path):
    """A rank that dies makes the run fail, without waiting for the
    others' collective timeout."""
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps([dict(name="bad",
                                     graph=str(tmp_path / "missing.npz"))]))
    r = _run_sim(2, str(tmp_path), "--spec", str(spec))
    assert r.returncode != 0
    assert "sim: FAILED" in r.stdout


# -------------------------------------------------- C3: the memory check

def test_memory_check_raises_before_upload(rng, monkeypatch):
    gp = _port_graph(random_graph(rng, 200, 6))
    for kw in (dict(), dict(slot_budget=0)):
        p = plan.build_plan(gp, 0, 1024, device="cpu", **kw)
        monkeypatch.setattr(api, "free_bytes", lambda d: 4096)
        with pytest.raises(MemoryError, match=r"needs \d+ B on cpu"):
            lt.predict_links(gp, "adamic_adar", min_degree1=0, plan=p,
                             device="cpu")
        assert p._device == {}, "uploaded before the check"
        monkeypatch.undo()
        res = lt.predict_links(gp, "adamic_adar", min_degree1=0, plan=p,
                               device="cpu")
        assert len(res) > 0 and "cpu" in p._device


def test_memory_check_reads_the_hosts_free_memory_on_the_cpu(rng,
                                                             monkeypatch):
    """On the CPU the check prices against the host's free pages, not a
    fixed basis: a host with three free pages refuses the pass."""
    from linkpred_tpu_torch.utils import device as udev

    pages, real = {"SC_AVPHYS_PAGES": 3, "SC_PAGE_SIZE": 4096}, os.sysconf
    monkeypatch.setattr(udev.os, "sysconf",
                        lambda name: pages.get(name) or real(name))
    assert udev.free_bytes("cpu") == 3 * 4096
    gp = _port_graph(random_graph(rng, 200, 6))
    p = plan.build_plan(gp, 0, 1024, device="cpu")
    with pytest.raises(MemoryError, match=r"but 12288 B are free"):
        lt.predict_links(gp, "jaccard", min_degree1=0, plan=p, device="cpu")
    assert p._device == {}, "uploaded before the check"


def test_memory_check_prices_what_the_pass_uploads(rng):
    gp = _port_graph(powerlaw_graph(rng, n=250, m=2000))
    p = plan.build_plan(gp, 0, 512, device="cpu")
    passes = [p, *api._sub_plans(p)]
    assert len(passes) == 2
    k = api._exact_k(p, 1000)
    need = api.device_bytes(gp, passes, 2, k, True, "cpu")
    stream = sum(a.nbytes for q in passes for a in q.host_stream(True)[:-1])
    middeg = sum(q.host_stream(True)[-1].nbytes for q in passes)
    seg = max(q.num_tiles_padded * q.cap * (4 * 2 + 8) for q in passes)
    assert need == dict(stream=stream, middeg=middeg, csr=0, selection=seg,
                        gather=0, total=stream + middeg + seg)
    # what is already on the device is not priced again
    for q in passes:
        q.device_stream("cpu", weighted=True)
    again = api.device_bytes(gp, passes, 2, k, True, "cpu")
    assert again["stream"] == again["middeg"] == 0
    # an edge plan adds the CSR
    e = plan.build_plan(gp, 0, 512, slot_budget=0, device="cpu")
    h = gp.host()
    assert api.device_bytes(gp, [e], 1, k, False, "cpu")["csr"] == \
        h.indices.nbytes + h.degrees.nbytes


def test_memory_check_prices_only_this_ranks_block(rng):
    gp = _port_graph(random_graph(rng, 300, 7))
    p = plan.build_plan(gp, 0, 1024, slot_budget=0, device="cpu")
    lay = pmesh.shard_layout(p, 4)
    for r in range(4):
        mesh = pmesh.Mesh(group=None, device=torch.device("cpu"), rank=r,
                          size=4)
        need = api.device_bytes(gp, [p], 1, 1024, True, "cpu", mesh)
        block = pmesh.block_arrays(p, lay, r, weighted=True)
        want = sum(a.nbytes for a in block) if lay.tiles(r) else 0
        assert need["stream"] + need["middeg"] == want
        assert need["gather"] == 2 * 4 * 3 * 1 * 1024 * 4
        if lay.tiles(r):
            _, seg = scoring_segments(lay.tiles(r), p.cap)
            assert need["selection"] == seg * p.cap * 12


def scoring_segments(tiles, cap):
    from linkpred_tpu_torch.predict.scoring import _segments

    return _segments(tiles, cap, 1, torch.device("cpu"))
