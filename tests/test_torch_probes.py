"""The engine's design probes (``linkpred_tpu_torch/experiments/``) on the
CPU, at small sizes, with the kernels' plain versions.

Every probe's arms give equal results (each probe checks them itself and
raises otherwise; the tests run its ``main`` or its arms).  Where the JAX
probe's import is light it is loaded by file path with its environment,
and the port's data and order are held against it: ``ab_select``
(``make_data``, ``desc_key``), ``ab_pack_sel`` (``LANES=2^14``, ``KK=200``:
the selection's kk-th key and winners), ``ab_width2`` (``LANES_LOG2=10``:
its operands, and the sorts of ``iterated(ops, 1)``).  The other JAX probes
build RMAT-18+ graphs, read ``/tmp`` caches or allocate 2^25-lane arrays
when imported, or call engine functions under signatures the package no
longer has, so the port's probes are held against the JAX package's
current functions: ``predict_links`` for the graph probes (1-5, 9),
``_keyed_sort_reduce`` for ``ab_deg_gather``, the edge plan keyed and
sentinel for ``ab_edge2``, and ``scoring._desc_score_key``'s order and
numpy's stable ``argsort`` for the arms local to a JAX ``main()``
(``ab_select``, ``ab_sel2``, ``ab_batchsort``).  Graphs are RMAT-8 to 10.
"""
import importlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import linkpred_tpu as lp
from linkpred_tpu.graph import CSRGraph as RefGraph
from linkpred_tpu.predict import plan as ref_plan
from linkpred_tpu.predict import metrics as ref_metrics
from linkpred_tpu.predict import scoring as ref_scoring

from linkpred_tpu_torch import experiments
from linkpred_tpu_torch.experiments import (_probe, ab_batchsort,
                                            ab_deg_gather, ab_edge2,
                                            ab_edge3, ab_merge, ab_pack_sel,
                                            ab_sel2, ab_select, ab_split,
                                            ab_width2, amort2, campaign_r5,
                                            diag_pack, diag_s21, diag_scale,
                                            mesh_overhead, profile_bench)
from linkpred_tpu_torch.ops import compact
from linkpred_tpu_torch.predict import api, scoring
from linkpred_tpu_torch.utils.profiling import counter
from linkpred_tpu_torch.predict.plan import build_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# The design probes ported, one module each (ab_deferred.py is ab_split's
# --deferred).
PROBES = ["profile_bench", "profile_tiles", "diag_scale", "diag_s21",
          "ab_split", "ab_select", "ab_sel2", "ab_pack_sel", "diag_pack",
          "ab_width2", "ab_batchsort", "ab_deg_gather", "ab_edge3",
          "ab_edge2", "ab_merge", "amort2", "mesh_overhead", "campaign_r5"]


def _load_jax_probe(monkeypatch, name, **env):
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    spec = importlib.util.spec_from_file_location(
        f"_jax_probe_{name}", os.path.join(REPO, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_graph(y):
    return RefGraph(offsets=np.asarray(y.offsets),
                    indices=np.asarray(y.indices),
                    degrees=np.asarray(y.degrees), weights=None, n=y.n, m=y.m)


def _same(got, want, where):
    _probe.same_result(got, want, where)


# ------------------------------------------------------------ the catalog

def test_not_ported_names_three_probes_with_reasons():
    assert set(experiments.NOT_PORTED) == {"ab_stable", "ab_width", "ab_cond"}
    assert all(isinstance(r, str) and r.strip()
               for r in experiments.NOT_PORTED.values())
    assert experiments.FOLDED_INTO == {"ab_deferred": "ab_split"}


def test_every_jax_probe_has_a_counterpart_or_a_reason():
    """Walks the top-level experiments/, so a probe added later cannot slip
    past: each file is a module here, folded into one, or not ported."""
    stems = sorted(f[:-3] for f in os.listdir(os.path.join(REPO,
                                                           "experiments"))
                   if f.endswith(".py"))
    here = os.path.dirname(experiments.__file__)
    for stem in stems:
        ported = os.path.isfile(os.path.join(here, f"{stem}.py"))
        folded = experiments.FOLDED_INTO.get(stem)
        assert ported + (folded is not None) \
            + (stem in experiments.NOT_PORTED) == 1, stem
        if folded:
            assert os.path.isfile(os.path.join(here, f"{folded}.py"))
    assert set(PROBES) <= set(stems)


@pytest.mark.parametrize("name", PROBES)
def test_probe_defaults_to_the_card_and_raises_without_one(name,
                                                           monkeypatch):
    """``main()`` names no device: it resolves the card and, with none,
    raises before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"linkpred_tpu_torch.experiments.{name}")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main([])


def test_sizes_read_the_jax_probes_environment(monkeypatch):
    monkeypatch.setenv("LANES", "4096")
    monkeypatch.setenv("KK", "33")
    args = _probe.parser(ab_pack_sel.__doc__, ab_pack_sel.SIZES) \
        .parse_args([])
    assert (args.lanes, args.kk, args.device) == (4096, 33, "cuda")
    monkeypatch.delenv("LANES")
    args = _probe.parser(ab_pack_sel.__doc__, ab_pack_sel.SIZES) \
        .parse_args(["--lanes", "8"])
    assert args.lanes == 8 and ab_pack_sel.SIZES["LANES"][0] == 68 << 21


# ------------------------------------------- A: where a pass spends its time

SCALE = 10
CAP = 4096


@pytest.fixture(scope="module")
def bench10(tmp_path_factory):
    """RMAT-10 at the bench protocol through the probes' cache, its
    cap-4096 plan, k = the removed edges / 2, and the JAX package's
    ``predict_links`` on the same graph and cap."""
    y, deletions = _probe.bench_graph(
        SCALE, str(tmp_path_factory.mktemp("cache")))
    k = deletions.shape[0] // 2
    want = lp.predict_links(_ref_graph(y), "jaccard_coefficient",
                            min_degree1=64, cap=CAP,
                            options=lp.PredictOptions(max_edges=k))
    return y, deletions, k, want


@pytest.fixture
def pack_small(monkeypatch):
    """Small buffers take the survivor pack (K2's plain version)."""
    monkeypatch.setattr(scoring, "SEL_PACK_MIN", 1 << 14)


def _rows(name):
    return _probe.Rows(name, CPU)


def test_profile_bench_vs_jax(bench10, pack_small):
    y, _, k, want = bench10
    plan = build_plan(y, 64, cap=CAP, device="cpu")
    packed = counter("select.packed_arm")
    rows = _rows("profile_bench")
    got = profile_bench.profile_pass(y, plan, k, CPU, rows, top=5)
    _same(got, want, "profile_bench")
    assert counter("select.packed_arm") > packed, "the pack arm ran"
    ops = rows.rows[-1]["ops"]
    assert rows.rows[0]["card"] is None and len(ops) == 5 \
        and all(ms >= 0 for _, ms, _ in ops)


def test_profile_tiles_vs_jax(tmp_path):
    from linkpred_tpu_torch.experiments import profile_tiles

    rows = profile_tiles.main(["--device", "cpu", "--scale", "9", "--cap",
                               "4096", "--prof-maxe", "300"])
    g, _ = _probe.bench_graph(9, removal=False)
    plan = build_plan(g, 64, cap=CAP, device="cpu")
    got = profile_bench.profile_pass(g, plan, 300, CPU, _rows("t"), top=3)
    want = lp.predict_links(_ref_graph(g), "jaccard_coefficient",
                            min_degree1=64, cap=CAP,
                            options=lp.PredictOptions(max_edges=300))
    _same(got, want, "profile_tiles")
    assert [r.get("row") for r in rows] == [None, "pass", "ops"]
    assert rows[1]["k"] == 300 and rows[1]["results"] == 300


def test_diag_scale_vs_jax(bench10, pack_small):
    y, _, k, want = bench10
    plan = build_plan(y, 64, cap=CAP, device="cpu")
    rows = _rows("diag_scale")
    got = diag_scale.diagnose(y, plan, k, CPU, rows, repeat=1, trace=True)
    _same(got, want, "diag_scale")
    kinds = [r["row"] for r in rows.rows[1:]]
    assert kinds[0] == "graph" and kinds[-1] == "total" and "ops" in kinds
    labels = [r["plan"] for r in rows.rows if r.get("row") == "pass"]
    assert labels == [name for name, _ in _probe.passes(plan)]
    assert len(labels) > 1, "test premise: the plan has a sub-plan"
    total = rows.rows[-1]
    assert total["slots"] == sum(p.total_slots for _, p in
                                 _probe.passes(plan))


def test_diag_scale_segments_reported(monkeypatch):
    """``by_segment`` is ``scoring._segments``' answer."""
    g, _ = _probe.bench_graph(8, removal=False)
    monkeypatch.setattr(scoring, "SEG_LANES", 2 * CAP)
    plan = build_plan(g, 64, cap=1024, device="cpu")
    d = diag_scale.describe(plan, CPU)
    n_seg, seg = scoring._segments(plan.num_tiles_padded, 1024, 1, CPU)
    assert (d["segments"], d["segment_tiles"]) == (n_seg, seg) and n_seg > 1
    assert d["by_segment"] and d["sel_lanes"] == plan.num_tiles_padded * 1024


@pytest.mark.parametrize("sel_pack_min", [1 << 14, 1 << 30])
def test_diag_pack_vs_jax(bench10, monkeypatch, sel_pack_min):
    """At the engine's k the pack engages when the buffer reaches
    SEL_PACK_MIN and the reproduction names the arm ``_argselect`` took;
    the selection's top k equals the JAX package's predict_links at that
    k (the adaptive plan has no sub-plan here)."""
    y, deletions, k, _ = bench10
    monkeypatch.setattr(scoring, "SEL_PACK_MIN", sel_pack_min)
    plan = build_plan(y, 64, device="cpu")
    assert not api._sub_plans(plan) and not plan.host_src.size, "premise"
    rows = _rows("diag_pack")
    got = diag_pack.decision(y, plan, k, CPU, rows)
    kk = api._exact_k(plan, k)
    want = lp.predict_links(_ref_graph(y), "jaccard_coefficient",
                            min_degree1=64,
                            options=lp.PredictOptions(max_edges=kk))
    _same(got, want, "diag_pack")
    row = rows.rows[-1]
    assert row["k"] == kk and kk % 1024 == 0 and kk >= k
    packs = sel_pack_min < row["lanes"]
    assert row["arm"] == ("packed" if packs else "sort")
    assert row["capacity"] == row["lanes"] // compact.PACK_RATIO
    assert row["survivors"] >= kk


def test_diag_s21_vs_jax(bench10, pack_small):
    y, _, k, want = bench10
    plan = build_plan(y, 64, cap=CAP, device="cpu")
    rows = _rows("diag_s21")
    got = diag_s21.diagnose(y, plan, k, CPU, rows, top=3)
    _same(got, want, "diag_s21")
    arms = next(r for r in rows.rows if r.get("row") == "arms")
    assert arms["packed_arm_runs"] > 0 and arms["sort_arm_runs"] == 0
    assert rows.rows[-1]["row"] == "decision"


@pytest.mark.parametrize("deferred", [False, True])
def test_ab_split_vs_jax(bench10, pack_small, deferred):
    y, _, k, want = bench10
    if deferred:
        y, _ = _probe.bench_graph(SCALE, removal=False)
        want = lp.predict_links(_ref_graph(y), "jaccard_coefficient",
                                min_degree1=64, cap=CAP,
                                options=lp.PredictOptions(max_edges=k))
    plan = build_plan(y, 64, cap=CAP, device="cpu")
    rows = _rows("ab_split")
    got = ab_split.split(y, plan, k, CPU, rows, repeat=1)
    _same(got, want, "ab_split")
    r = rows.rows[-1]
    assert r["sel_lanes"] == plan.num_tiles_padded * CAP
    assert all(r[f"{a}_ms"] > 0 for a in ("full", "scan", "sel"))


def test_ab_split_main_deferred_row():
    rows = ab_split.main(["--device", "cpu", "--deferred", "--bench-scale",
                          "8", "--cap", "4096", "--k", "500", "--repeat",
                          "1"])
    assert rows[0]["probe"] == "ab_deferred" and rows[-1]["k"] == 500


def test_ab_split_fake_buffer_shape():
    keys, us, vs, s = ab_split.fake_buffer(1000, CPU)
    assert keys.shape == (1, 1000) and int(torch.isfinite(s).sum()) == 350
    assert torch.equal(us, vs) and not us.any()


# ------------------------------------------------------ B: the selection

def _winners(key_np, k):
    """The lanes strictly before the k-th key in the stable order of a
    numpy key, and the sorted top-k keys."""
    order = np.argsort(key_np, kind="stable")
    top = key_np[order[:k]]
    return set(order[:k][top < top[-1]].tolist()), top


@pytest.fixture
def jax_ab_select(monkeypatch):
    return _load_jax_probe(monkeypatch, "ab_select")


def test_ab_select_data_and_key_equal_the_jax_probes(jax_ab_select):
    x = ab_select.make_data(12)
    np.testing.assert_array_equal(x, np.asarray(jax_ab_select.make_data(12)))
    jkey = np.asarray(jax_ab_select.desc_key(jnp.asarray(x)))
    pkey = ab_select.desc_key(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(pkey.view(np.uint32) ^ np.uint32(1 << 31),
                                  jkey)
    np.testing.assert_array_equal(np.argsort(pkey, kind="stable"),
                                  np.argsort(jkey, kind="stable"))


@pytest.mark.parametrize("arm", [name for name, _ in ab_select.ARMS])
def test_ab_select_arm_vs_jax_order(jax_ab_select, arm):
    """Each arm's top-k keys and its lanes above the k-th key are the JAX
    ``desc_key`` order's."""
    k = 700
    x = ab_select.make_data(14)
    want_lanes, want_keys = _winners(
        np.asarray(jax_ab_select.desc_key(jnp.asarray(x))), k)
    fn = dict(ab_select.ARMS)[arm]
    keys, lanes = fn(torch.as_tensor(x), k)
    got = keys.numpy().view(np.uint32) ^ np.uint32(1 << 31)
    np.testing.assert_array_equal(got, want_keys)
    lanes, keys = lanes.numpy(), keys.numpy()
    assert set(lanes[keys < keys[-1]].tolist()) == want_lanes


def test_ab_select_main_holds_the_arms_equal():
    rows = ab_select.main(["--device", "cpu", "--log2n", "13", "--k", "300",
                           "--iters", "1"])
    assert [r["arm"] for r in rows[1:]] == [n for n, _ in ab_select.ARMS]
    assert len({r["kth_key"] for r in rows[1:]}) == 1


@pytest.mark.parametrize("arm", [name for name, _ in ab_sel2.ARMS])
def test_ab_sel2_arm_vs_jax_order(arm):
    """Each arm's scores are the top k of the JAX package's
    ``_desc_score_key`` order (numpy's stable argsort), and its (u, v)
    above the k-th score the same lanes'."""
    t, cap, k = 3, 2048, 900
    scores, us, vs = ab_sel2.make_data(t, cap)
    flat = scores.reshape(-1)
    jkey = np.asarray(ref_scoring._desc_score_key(jnp.asarray(flat)))
    want_lanes, _ = _winners(jkey, k)
    s, u, v, lanes = dict(ab_sel2.ARMS)[arm](
        *(torch.as_tensor(a) for a in (scores, us, vs)), k)
    np.testing.assert_array_equal(
        np.sort(s.numpy()), np.sort(flat[np.argsort(jkey,
                                                    kind="stable")[:k]]))
    above = s.numpy() > s.numpy().min()
    lanes = lanes.numpy()[above]
    assert set(lanes.tolist()) == want_lanes
    np.testing.assert_array_equal(u.numpy()[above], us.reshape(-1)[lanes])
    np.testing.assert_array_equal(v.numpy()[above], vs.reshape(-1)[lanes])


def test_ab_sel2_main_holds_the_arms_equal():
    rows = ab_sel2.main(["--device", "cpu", "--t", "2", "--cap", "4096",
                         "--k", "1000", "--repeat", "1"])
    assert [r["arm"] for r in rows[1:]] == ["A sort2", "B sort1", "C topk",
                                            "D approx"]
    assert "not exact" in rows[-1]["reason"]


@pytest.fixture
def jax_ab_pack_sel(monkeypatch):
    return _load_jax_probe(monkeypatch, "ab_pack_sel", LANES=1 << 14, KK=200,
                           ITERS=2, REPEAT=1)


def test_ab_pack_sel_vs_jax(jax_ab_pack_sel):
    """The port's keys are the JAX probe's in the int32 form; its whole
    arms select the JAX selection's kk-th key and winners."""
    mod = jax_ab_pack_sel
    n, kk = 1 << 14, 200
    key = ab_pack_sel.make_keys(n, 0.2)
    np.testing.assert_array_equal(key.view(np.uint32) ^ np.uint32(1 << 31),
                                  np.asarray(mod.key0))
    jkeys, jlanes = mod.scoring._argselect_blocked(mod.key0, mod.idx0, kk)
    jkeys, jlanes = np.asarray(jkeys)[:kk], np.asarray(jlanes)[:kk]
    pk, pl = mod.scoring._argselect_packed(mod.key0, mod.idx0, kk)
    np.testing.assert_array_equal(np.asarray(pk), jkeys)
    want = set(jlanes[jkeys < jkeys[-1]].tolist())
    t = torch.as_tensor(key)
    fns = ab_pack_sel.arms(t, kk, 0.2)
    packed = counter("select.packed_arm")
    for name in ("sort_full", "packed_full"):
        sk, lanes = fns[name]()
        got = sk.numpy().view(np.uint32) ^ np.uint32(1 << 31)
        np.testing.assert_array_equal(got, jkeys, err_msg=name)
        lanes, sk = lanes.numpy(), sk.numpy()
        assert set(lanes[sk < sk[-1]].tolist()) == want, name
    assert counter("select.packed_arm") == packed + 1, "the pack arm packed"
    thr = ab_pack_sel.fixed_threshold(n, kk, 0.2)
    assert thr + (1 << 31) == int(np.uint32(0x44000000 * 0.2
                                            * (kk / n / 0.2) * 1.3))
    _, _, cnt = fns["pack"]()
    assert int(cnt) == int((t <= thr).sum())
    assert int(fns["count"]()) >= kk


def test_ab_pack_sel_main_holds_the_arms_equal():
    rows = ab_pack_sel.main(["--device", "cpu", "--lanes", "32768", "--kk",
                             "300", "--iters", "1", "--repeat", "1"])
    assert [r["arm"] for r in rows[1:6]] == ["sort_full", "packed_full",
                                             "sample", "pack", "count"]
    assert rows[-1]["packed_full_took"] == "packed"
    assert rows[-1]["capacity"] == 32768 // compact.PACK_RATIO


# ------------------------------------- C: the tile's sort and its gathers

@pytest.fixture
def jax_ab_width2(monkeypatch):
    return _load_jax_probe(monkeypatch, "ab_width2", LANES_LOG2=10, ITERS=2,
                           REPEAT=1)


def test_ab_width2_vs_jax(jax_ab_width2):
    """The port's operands are ``mk``'s, and its rows sort the keys as the
    JAX probe's ``iterated(ops, 1)`` does (after its XOR)."""
    mod = jax_ab_width2
    ops = ab_width2.operands(1 << 10)
    for name in ("k32", "a32", "b32", "c32", "f32"):
        np.testing.assert_array_equal(ops[name].view(np.int32)
                                      if name != "f32" else ops[name],
                                      np.asarray(getattr(mod, name))
                                      .view(ops[name].dtype), err_msg=name)
    mod.rng = np.random.default_rng(123)
    trio = (mod.k32, mod.a32, mod.b32)
    want = np.asarray(mod.iterated(trio, 1)(trio))
    x = int(np.random.default_rng(123).integers(1, 1 << 21, 1)[0])
    t = {k: torch.as_tensor(v) for k, v in ops.items()}
    for stable in (True, False):
        got = ab_width2.sort_row(t["k32"] ^ x, [t["a32"], t["b32"]], stable)
        np.testing.assert_array_equal(got[0].numpy(), want.view(np.int32))


def test_ab_width2_rows_equal():
    ops = {k: torch.as_tensor(v) for k, v in ab_width2.operands(1 << 11)
           .items()}
    outs = {row[0]: ab_width2.run_row(ops, row) for row in ab_width2.ROWS}
    ab_width2.check_rows(ops, outs)
    bad = dict(outs)
    bad["i32+1"] = (outs["i32+1"][0], outs["i32+1"][1].flip(0))
    with pytest.raises(AssertionError, match="payload a32"):
        ab_width2.check_rows(ops, bad)
    rows = ab_width2.main(["--device", "cpu", "--lanes-log2", "10",
                           "--iters", "1", "--repeat", "1"])
    assert [r["sort"] for r in rows[1:-1]] == [r[0] for r in ab_width2.ROWS]
    assert rows[-1]["i64_over_i32_unstable"] > 0


def test_ab_batchsort_arms_equal_numpy_stable():
    rng = np.random.default_rng(1)
    w, u, d = (torch.as_tensor(a) for a in
               ab_batchsort.make_tiles(rng, (3, 1024)))
    # many ties, so stability shows
    w = w % 64
    a, b = ab_batchsort.batched(w, u, d), ab_batchsort.sequential(w, u, d)
    order = np.argsort(w.numpy(), axis=-1, kind="stable")
    for x, y, src in zip(a, b, (w, u, d)):
        assert torch.equal(x, y)
        np.testing.assert_array_equal(
            x.numpy(), np.take_along_axis(src.numpy(), order, -1))
    one = ab_batchsort.single(w[0], u[0], d[0])
    assert all(torch.equal(x, y[0]) for x, y in zip(one, a))
    rows = ab_batchsort.main(["--device", "cpu", "--t", "2", "--cap", "2048",
                              "--singles", "10,11", "--repeat", "1"])
    assert [r.get("arm", r.get("log2n")) for r in rows[1:]] == [
        "batched", "sequential", 10, 11]


def test_ab_deg_gather_vs_jax():
    """Arms A and B give the same lanes, their runs are the port's
    ``_keyed_sort_reduce`` (K1's twin, non-deg16) and the JAX package's
    (``key64``, wide degrees) on the same lanes."""
    cap, n, w_bits = 2048, 512, 9
    s = ab_deg_gather.make_stream(cap, 2, n, 300, CPU)
    rmets = (ref_metrics.METRICS["jaccard_coefficient"],)
    for t0 in (0, cap):
        a = ab_deg_gather.tile_a(s, t0, cap, w_bits)
        b = ab_deg_gather.tile_b(s, t0, cap, w_bits)
        ab_deg_gather.check_tile(a, b, ab_deg_gather.engine_tile(
            s, t0, cap, w_bits), "test")
        win = [jnp.asarray(s[k][t0: t0 + cap].numpy())
               for k in ("slot_w", "slot_u", "slot_udeg", "slot_wdeg")]
        scores, ku, kw = jax.jit(lambda w, u, ud, wd:
                                 ref_scoring._keyed_sort_reduce(
                                     w, u, ud, wd, [], [], rmets,
                                     w_bits=w_bits, n=n, maxf2=0,
                                     min_score=jnp.float32(0.0),
                                     deg16=False, killers=False,
                                     key64=True))(*win)
        scores = np.asarray(scores)[0]
        live = np.isfinite(scores)
        got = a[0].numpy()
        np.testing.assert_array_equal(np.isfinite(got), live)
        np.testing.assert_array_equal(got[live], scores[live])
        np.testing.assert_array_equal(a[1].numpy()[live], np.asarray(ku)[live])
        np.testing.assert_array_equal(a[2].numpy()[live], np.asarray(kw)[live])
    assert (s["slot_udeg"] >= 1 << 8).any(), "premise: wide degrees"
    rows = ab_deg_gather.main(["--device", "cpu", "--cap", "2048", "--t",
                               "2", "--n", "512", "--deg-max", "300",
                               "--repeat", "1"])
    assert [r["arm"] for r in rows[1:]] == ["A", "B"]


def test_ab_deg_gather_check_catches_a_bad_arm():
    cap, w_bits = 1024, 9
    s = ab_deg_gather.make_stream(cap, 1, 512, 300, CPU)
    a = ab_deg_gather.tile_a(s, 0, cap, w_bits)
    b = (a[0].flip(0), a[1], a[2])
    with pytest.raises(AssertionError, match="A and B differ"):
        ab_deg_gather.check_tile(a, b, ab_deg_gather.engine_tile(
            s, 0, cap, w_bits), "test")


def test_ab_edge3_refuses_a_wrapping_degree_sum():
    """The JAX probe's draw, [1, 2^12) over 2^22 vertices, sums to ~2^33:
    refused before anything is drawn on the device."""
    with pytest.raises(ValueError, match="not under 2\\^31"):
        ab_edge3.make_rows(1024, 1, 1 << 22, 32, 1 << 12, CPU)


def test_ab_edge3_bound_is_strict(monkeypatch):
    rng = np.random.default_rng(0)
    for _ in range(6):                     # the draw order of make_rows
        rng.integers(0, 2, 1)
    n, deg_max = 256, 16
    total = int(ab_edge3.make_rows(256, 1, n, 8, deg_max, CPU)["indices"]
                .shape[0])
    monkeypatch.setattr(ab_edge3, "MAX_EDGES", total)
    with pytest.raises(ValueError):
        ab_edge3.make_rows(256, 1, n, 8, deg_max, CPU)
    monkeypatch.setattr(ab_edge3, "MAX_EDGES", total + 1)
    ab_edge3.make_rows(256, 1, n, 8, deg_max, CPU)


@pytest.mark.parametrize("avg_work", [4, 16])
def test_ab_edge3_four_arms_agree(avg_work):
    """A, B, C and the engine's ``_edge_slots`` give the same lanes and
    checksums on every tile, with killer rows and tiles that overrun
    cap."""
    cap, w_bits = 2048, 10
    s = ab_edge3.make_rows(cap, 3, 1024, avg_work, 64, CPU)
    assert (s["fe_cnt"] < 0).any(), "premise: killer rows"
    wide = False
    for t0, t1 in s["bounds"]:
        wide |= int(s["fe_work"][t0:t1].sum()) > cap
        outs = [lanes(s, t0, t1, cap, w_bits) for _, lanes in ab_edge3.ARMS]
        for o in outs[1:]:
            assert all(torch.equal(x, y) for x, y in zip(o, outs[0]))
        sums = {int(ab_edge3.checksum(*o)) for o in outs}
        assert len(sums) == 1
    assert wide, "premise: a tile's rows overrun cap"


def test_ab_edge3_main():
    rows = ab_edge3.main(["--device", "cpu", "--cap", "2048", "--t", "2",
                          "--n", "1024", "--avg-work", "8", "--deg-max",
                          "64", "--repeat", "1"])
    assert rows[1]["row"] == "table" and rows[1]["edges"] > 0
    assert [r["arm"] for r in rows if r.get("row") == "arm"] == \
        ["A", "B", "C", "D"]
    assert [r["map"] for r in rows if r.get("row") == "slot_map"] == \
        ["scatter", "search"]


def _jax_edge_results(g, cap, k):
    rp = ref_plan.build_plan(g, 0, cap, slot_budget=0)
    assert not rp.packed and rp.keyed
    o = lp.PredictOptions(max_edges=k)
    import dataclasses
    return {name: lp.predict_links(g, "jaccard_coefficient", min_degree1=0,
                                   options=o, plan=p)
            for name, p in (("keyed", rp), ("sentinel", dataclasses.replace(
                rp, keyed=False)))}


def test_ab_edge2_vs_jax():
    from linkpred_tpu.bench.synth import rmat_graph as ref_rmat
    from linkpred_tpu_torch.bench.synth import rmat_graph

    g = rmat_graph(8, edge_factor=12, seed=3)
    plan = build_plan(g, 0, cap=4096, slot_budget=0, device="cpu")
    assert not plan.packed and plan.keyed
    got = ab_edge2.branches(g, plan, 200, CPU, repeat=1)
    want = _jax_edge_results(ref_rmat(8, edge_factor=12, seed=3), 4096, 200)
    for name in ("keyed", "sentinel"):
        _same(got[name], want[name], f"ab_edge2 {name}")


def test_ab_edge2_main():
    rows = ab_edge2.main(["--device", "cpu", "--scale", "8", "--cap",
                          "4096", "--maxe", "100", "--repeat", "1"])
    assert rows[1]["packed"] is False and rows[1]["keyed"] is True
    assert rows[2]["results"] == 100


def test_ab_merge_rounds_equal_and_keep_the_top_k():
    cap, k = 4096, 300
    s = torch.as_tensor(ab_merge.make_tile(cap))
    u = torch.arange(cap, dtype=torch.int32)
    tile = (s, u, u + 1)
    raw = ab_merge.rounds(ab_merge.merge_raw, tile, k, 3)
    enc = ab_merge.rounds(ab_merge.merge_encoded, tile, k, 3)
    for a, b in zip(raw, enc):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    order = np.argsort(-s.numpy(), kind="stable")[:k]
    np.testing.assert_array_equal(raw[0][0].numpy(), s.numpy()[order])
    np.testing.assert_array_equal(raw[0][1].numpy(), order)
    # each later round: the top k of the last carry and the tile
    for prev, cur in zip(raw, raw[1:]):
        both = np.concatenate([prev[0].numpy(), s.numpy()])
        np.testing.assert_array_equal(
            cur[0].numpy(), both[np.argsort(-both, kind="stable")[:k]])
    rows = ab_merge.main(["--device", "cpu", "--cap", "4096", "--k", "64",
                          "--rounds", "2", "--repeat", "1"])
    assert [r["arm"] for r in rows[1:]] == ["raw", "encoded"]


def _numpy_op(name, x):
    big, idx, pk, ones = (x[k].numpy() for k in ("big", "idx", "pk", "ones"))
    if name == "gather":
        return big[idx]
    if name == "gather_sum":
        return big[idx].sum()
    if name == "dynslice":
        start = int(idx[0]) % (big.shape[0] - idx.shape[0])
        return big[start: start + idx.shape[0]].sum()
    if name == "cumsum":
        return np.cumsum(ones)
    if name == "cummax":
        return np.maximum.accumulate(idx)
    if name == "sort1":
        return np.sort(pk)
    if name == "sort2":
        return np.sort(pk), ones
    if name == "segscan":
        start = np.r_[True, pk[1:] != pk[:-1]]
        run = np.cumsum(start) - 1
        first = np.flatnonzero(start)
        return np.arange(pk.shape[0]) - first[run] + 1
    if name == "topk":
        return np.sort(idx.astype(np.float32))[::-1][: 1 << 10]
    if name == "sortmerge":
        return np.sort(-idx.astype(np.float32)), ones
    return None


@pytest.mark.parametrize("name", amort2.OPS)
def test_amort2_op_equals_numpy(name):
    x = amort2.inputs(1 << 10, 1 << 14, CPU)
    got = amort2.op(name, x)
    want = _numpy_op(name, x)
    if name == "noop":
        assert got is None
        return
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g_, w_ in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g_.numpy()), w_)


def test_amort2_main_and_unknown_op():
    rows = amort2.main(["--device", "cpu", "--k", "1024", "--table", "4096",
                        "--iters", "1", "sort2", "segscan"])
    assert [r["op"] for r in rows[1:]] == ["sort2", "segscan"]
    with pytest.raises(ValueError, match="no primitive"):
        amort2.op("fft", amort2.inputs(8, 64, CPU))


# ------------------------------------------------- D: the ranks, the campaign

def test_mesh_overhead_one_and_two_cpu_ranks():
    """One and two CPU rank processes (gloo): each rank count's score
    multiset equals the single pass's (the probe raises otherwise)."""
    rows = mesh_overhead.main(["--device", "cpu", "--mo-scale", "9",
                               "--mo-cap-log2", "10", "--mo-k", "200",
                               "--repeat", "1", "--ranks", "1,2"])
    single, one, two = rows[1:]
    assert single["row"] == "single" and single["tiles"] > 1
    assert (one["ranks"], one["gathers"], one["recv_mb_rank"]) == (1, 0, 0.0)
    assert two["ranks"] == 2 and two["backend"] == "gloo"
    assert two["gathers"] == single["passes"]
    assert two["slots_rank"] < single["slots"]
    assert one["vs_one_rank"] == 1.0


def test_campaign_writes_every_step_failures_with_their_reason(tmp_path,
                                                                monkeypatch):
    """On the CPU the bench row and the pack's decision run; the radix
    probe needs a card and fails: its row carries the exit code and the
    reason, and no step is dropped.  The JAX campaign's on/off A/Bs are
    rows that say why they do not run."""
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path / "cache"))
    out = tmp_path / "out"
    rows = campaign_r5.main(["--device", "cpu", "--out", str(out),
                             "--scales", "8", "--diag-scales", "8"])
    by = {r["step"]: r for r in rows}
    assert by["card"]["card"] is None
    assert set(campaign_r5.NOT_RUN) <= set(by)
    assert all(by[s]["not_run"] for s in campaign_r5.NOT_RUN)
    assert by["s8"]["rc"] == 0 and by["s8"]["bench"]["metric"] \
        == "lhub_jaccard_coefficient_deg64_rmat8_rate"
    assert by["diag_pack_s8"]["rc"] == 0
    assert by["radix_probe"]["rc"] != 0
    assert "needs a CUDA device" in by["radix_probe"]["reason"]
    assert by["radix_probe"]["refused_by_memory_check"] is False
    lines = [json.loads(x) for x in
             (out / "results.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [r["step"] for r in rows]
    assert sorted(os.listdir(out / "logs")) == [
        "diag_pack_s8.log", "radix_probe.log", "s8.log"]


def test_campaign_records_a_memory_refusal(tmp_path, monkeypatch):
    """A step whose process dies of the memory check keeps its row, with
    the check's message as its reason."""
    out = tmp_path / "out"
    row = campaign_r5.run_step(
        "s99", [campaign_r5.sys.executable, "-c",
                "raise MemoryError('predict_links: the pass needs 9 B on "
                "cuda:0 but 1 B are free; nothing was uploaded')"],
        {}, str(out), 60)
    assert row["rc"] == 1 and row["refused_by_memory_check"] is True
    assert row["reason"].startswith("MemoryError: predict_links: the pass")
    assert json.loads((out / "results.jsonl").read_text()) == row
