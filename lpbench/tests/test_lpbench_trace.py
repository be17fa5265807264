"""The trace arithmetic and the per-layer readers on a small canned chrome
trace, and the roofline byte counts."""
import gzip
import json

import numpy as np
import pytest

from lpbench import drive, roofline, trace
from lpbench.run import load_reader


def _k(name, ts, dur, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"stream": stream}}


def _h(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


# A traced window [100, 300) us: two calls, each a memset and K1, a radix
# sort, K2 (memset, pack, fill) and a copy; overlapping kernels on two
# streams; one kernel half outside the window.
EVENTS = [
    _h(trace.WINDOW, 100, 200, cat="user_annotation"),
    _h("lpbench.predict_links", 100, 95, cat="user_annotation"),
    _h("lpbench.predict_links", 200, 100, cat="user_annotation"),
    _h("aten::sort", 110, 20),
    _h("aten::item", 180, 14),
    _k("Memset (Device)", 110, 2, cat="gpu_memset"),
    _k("void tail_onepass<true, false, 0>(TailArgs)", 112, 8),
    _k("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>(int)",
       120, 10),
    _k("void other<float>(float)", 125, 10, stream=9),
    _k("Memset (Device)", 140, 1, cat="gpu_memset"),
    _k("pack_onepass(int const*)", 141, 4),
    _k("pack_fill(int const*)", 145, 1),
    _k("Memcpy DtoH (Device -> Pageable)", 150, 20, cat="gpu_memcpy"),
    _k("Memset (Device)", 210, 2, cat="gpu_memset"),
    _k("void tail_onepass<true, false, 0>(TailArgs)", 212, 8),
    _k("void at_cuda_detail::cub::DeviceRadixSortHistogramKernel<int>()",
       230, 5),
    _k("Memset (Device)", 240, 1, cat="gpu_memset"),
    _k("pack_onepass(int const*)", 241, 4),
    _k("pack_fill(int const*)", 245, 1),
    _k("void late<int>(int)", 290, 40),
]


def test_window_union_and_gaps():
    t0, t1 = trace.window_of(EVENTS)
    assert (t0, t1) == (100.0, 300.0)
    # [110,135) [140,146) [150,170) [210,220) [230,235) [240,246) [290,300)
    assert trace.busy_us(EVENTS, t0, t1) == 25 + 6 + 20 + 10 + 5 + 6 + 10
    gaps = trace.idle_gaps(EVENTS, t0, t1)
    assert gaps[0] == (100.0, 110.0) and gaps[-1] == (246.0, 290.0)
    assert sum(b - a for a, b in gaps) == 200 - 82


def test_families_and_memsets():
    us, n = trace.family_us(EVENTS, r"tail_onepass", with_memset=True)
    assert (us, n) == (2 + 8 + 2 + 8, 2)
    assert trace.family_us(EVENTS, r"tail_onepass") == (16, 2)
    assert trace.family_us(EVENTS, r"(?i)radixsort") == (15, 2)
    assert trace.family_us(EVENTS, r"pack_fill") == (2, 2)


def test_breakdown_names_ops_and_the_hosts_gaps():
    b = trace.breakdown(EVENTS, 100, 300, top=3)
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pageable)", 20e-6]
    assert len(b["device_ops"]) == 3
    # the longest gap, [246, 290): the second call's span holds it
    assert b["idle_gaps"][0] == ["lpbench.predict_links", 44e-6]
    assert b["idle_gaps"][1] == ["aten::item", 40e-6]   # [170, 210): 190
    assert trace.short_name(
        "void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>(int)"
    ) == "at_cuda_detail::cub::DeviceRadixSortOnesweepKernel"


def test_load_events_reads_plain_and_gzipped(tmp_path):
    doc = {"traceEvents": EVENTS + [{"ph": "i", "name": "instant"}]}
    (tmp_path / "t.json").write_text(json.dumps(doc))
    with gzip.open(tmp_path / "t.json.gz", "wt") as fh:
        json.dump(doc, fh)
    assert trace.load_events(str(tmp_path / "t.json")) == EVENTS
    assert trace.load_events(str(tmp_path / "t.json.gz")) == EVENTS


def _record(**kw):
    spans = dict(scoring_ms=40.0, time_ms=45.0, transfer_ms=7.0)
    rec = drive.Record(kind="whole_graph", seconds=10.0, setup_s=30.0,
                       calls=[dict(wall_s=0.1, ok=True, traced=None,
                                   **spans),
                              dict(wall_s=0.2, ok=True, traced="slice",
                                   **spans),
                              dict(wall_s=0.2, ok=True, traced="slice",
                                   **spans),
                              dict(wall_s=0.3, ok=True, traced="after",
                                   **spans)],
                       attempted=4, failed=0, edges=1000, plan_s=20.0,
                       kind_of_card="NVIDIA H100 80GB HBM3", events=EVENTS,
                       traced_calls=2)
    rec.passes = [dict(packed=True, wide=False, cap=1 << 20, tiles=1,
                       lanes=np.array([1000]), filled=1000, kk=64,
                       packs=True)]
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_layer_readers_on_the_canned_trace():
    rec = _record()
    read = lambda name: load_reader("layer_metrics", name)(rec)  # noqa
    assert read("plan_s") == 20.0
    # the untraced call alone: transfer 7 + merge 45 - 40; the rest of
    # its 100 ms wall, 100 - 45 - 7, is what the program's clocks leave out
    assert read("api_host_ms.batch") == pytest.approx(12.0)
    assert read("api_untimed_ms.batch") == pytest.approx(48.0)
    assert read("sort_ms_per_pass.batch") == pytest.approx(15 / 1e3 / 2)
    # the slice's 82 us busy over two calls at the 100 ms wall of the call
    # before it, not over the slice's own (profiled) 200 us
    assert read("device_idle_pct.batch") == pytest.approx(
        100 * (1 - 82e-6 / 0.2))
    assert read("device_idle_pct.serve") is None
    assert read("plan_ms_p50.serve") is None
    k1 = 2 * roofline.k1_bytes([1000], wide_degrees=False, n_weighted=0,
                               n_metrics=1)
    assert read("k1_roofline") == pytest.approx(
        100 * k1 / 3.35e12 / 20e-6)
    k2 = 2 * roofline.k2_bytes(1000, 64)
    assert read("k2_roofline") == pytest.approx(100 * k2 / 3.35e12 / 12e-6)


def test_span_readers_read_the_slices_annotations():
    """The program's spans in the traced slice: the mean length of each
    name's host annotations; the card's copies of them are not read."""
    spans = [_h("scan.tile", 110, 40, cat="user_annotation"),
             _h("tile.k1", 112, 6, cat="user_annotation"),
             _h("scan.tile", 210, 60, cat="user_annotation"),
             _h("tile.k1", 212, 10, cat="user_annotation"),
             _h("scan.tile", 110, 500, cat="gpu_user_annotation")]
    rec = _record(events=EVENTS + spans)
    read = lambda name: load_reader("layer_metrics", name)(rec)  # noqa
    assert read("tile_host_us.batch") == pytest.approx(50.0)
    assert read("k1_host_us.batch") == pytest.approx(8.0)
    # no span in the slice, no slice, or a serving run: silent
    for rec in (_record(), _record(events=None),
                _record(kind="per_user", events=EVENTS + spans)):
        assert read("tile_host_us.batch") is None
        assert read("k1_host_us.batch") is None


def test_serving_latency_readers():
    # 20 requests before the slice (10..200 ms), two profiled, one after
    calls = [dict(wall_s=w / 1e3, ok=True, traced=None)
             for w in range(10, 201, 10)]
    calls += [dict(wall_s=5.0, ok=True, traced="slice")] * 2
    calls += [dict(wall_s=4.0, ok=True, traced="after")]
    rec = _record(kind="per_user", calls=calls, attempted=len(calls))
    e2e = lambda name: load_reader("end_to_end", name)(rec)  # noqa
    layer = lambda name: load_reader("layer_metrics", name)(rec)  # noqa
    # the end-to-end median is over every request of the window
    assert e2e("request_ms_p50") == pytest.approx(120.0)
    # the per-layer tail reads the requests before the slice alone
    assert layer("request_ms_p95.serve") == pytest.approx(190.5)
    calls[-5] = dict(wall_s=0.01, ok=False, traced=None)
    assert layer("request_ms_p95.serve") is None
    assert load_reader("layer_metrics", "request_ms_p95.serve")(
        _record()) is None


def test_passes_are_counted_from_the_launches_not_the_calls():
    # one traced call that scored its plan twice: two passes, not one
    rec = _record(traced_calls=1)
    read = lambda name: load_reader("layer_metrics", name)(rec)  # noqa
    assert read("sort_ms_per_pass.batch") == pytest.approx(15 / 1e3 / 2)
    k1 = 2 * roofline.k1_bytes([1000], wide_degrees=False, n_weighted=0,
                               n_metrics=1)
    assert read("k1_roofline") == pytest.approx(
        100 * k1 / 3.35e12 / 20e-6)


def test_roofline_readers_stay_silent_when_the_counts_disagree(capsys):
    rec = _record(traced_calls=3)
    assert load_reader("layer_metrics", "k1_roofline")(rec) is None
    assert load_reader("layer_metrics", "k2_roofline")(rec) is None
    assert load_reader("layer_metrics", "sort_ms_per_pass.batch")(rec) \
        is None
    assert "not read" in capsys.readouterr().err
    rec = _record(events=[e for e in EVENTS if "pack" not in e["name"]])
    assert load_reader("layer_metrics", "k2_roofline")(rec) is None
    rec = _record(kind_of_card="cpu")
    assert load_reader("layer_metrics", "k1_roofline")(rec) is None


def test_byte_counts_follow_the_filled_lanes_not_the_cap():
    a = roofline.k1_bytes([10, 20], wide_degrees=False, n_weighted=0,
                          n_metrics=1)
    assert a == 30 * (4 + 4 + 4 + 4 + 8)
    assert roofline.k1_bytes([10, 20], wide_degrees=True, n_weighted=1,
                             n_metrics=2) == 30 * (4 + 4 + 8 + 4 + 8 + 8)
    assert roofline.k2_bytes(1000, 64) == 4 * 1000 + 8 * 64


def test_pass_info_counts_a_plans_filled_lanes(lhub_cfg, ihub_cfg,
                                               monkeypatch):
    from linkpred_tpu_torch.predict import plan as plan_mod

    from lpbench import graph500

    g, k = graph500.make_graph(lhub_cfg, 3, "cpu")
    y = drive._program_graph(g)
    p = plan_mod.build_plan(y, 16, cap=1 << 12, device="cpu")
    info = drive._pass_info(p, k, 1, 80 << 30)
    assert info[0]["packed"] and info[0]["tiles"] == p.num_tiles
    assert info[0]["filled"] == p.total_slots
    assert info[0]["filled"] < p.num_tiles * p.cap
    # the edge stream: a tile's lanes are its rows' slots, killers with them
    monkeypatch.setattr(plan_mod, "SLOT_BUDGET", 0)
    g, k = graph500.make_graph(ihub_cfg, 3, "cpu")
    y = drive._program_graph(g)
    p = plan_mod.build_plan(y, 0, cap=1 << 12, device="cpu")
    assert not p.packed
    info = drive._pass_info(p, k, 1, 80 << 30)
    assert info[0]["filled"] == int(p.fe_work.astype(np.int64).sum())
    assert info[0]["tiles"] == p.num_tiles


def test_selection_packs_as_the_program_states():
    assert roofline.selection_packs(1 << 24, 1 << 20, 1)
    assert not roofline.selection_packs(1 << 24, (1 << 20) + 1, 1)
    assert not roofline.selection_packs(1 << 21, 1 << 10, 1)
    assert not roofline.selection_packs(1 << 24, 1 << 10, 2)
    # 68 tiles of 2^21 lanes on an 80 GB card: one segment
    assert roofline.segments(68, 1 << 21, 1, 80 << 30) == 1
    assert roofline.segments(2104, 1 << 21, 1, 80 << 30) > 1


def _packs_per_scoring(passes):
    return sum(p["packs"] + ("merge_pack" in p) for p in passes)


@pytest.mark.parametrize("segmented", [False, True])
def test_k2_is_counted_once_a_metric_as_the_program_launches_it(
        lhub_cfg, monkeypatch, segmented):
    """Nine metrics: the harness's count of K2 selections a scoring, times
    nine, is what the program's pass calls the pack for, in one segment
    and by segments whose merge packs (the pack's floor and the segment
    bound set small, the same in the program and in the harness)."""
    from linkpred_tpu_torch.predict import api, scoring
    from linkpred_tpu_torch.predict import plan as plan_mod

    from lpbench import graph500
    from lpbench.reference import METRICS

    monkeypatch.setattr(scoring, "SEL_PACK_MIN", 1 << 12)
    monkeypatch.setattr(roofline, "PACK_MIN_LANES", 1 << 12)
    device_bytes = 16 << 30
    if segmented:
        # one tile a segment: 3,000 lanes a metric's key and pair
        monkeypatch.setattr(scoring, "SEG_LANES", 3000)
        device_bytes = 180000
    lhub_cfg.update(scale=12)
    g, _ = graph500.make_graph(lhub_cfg, 3, "cpu")
    y = drive._program_graph(g)
    p = plan_mod.build_plan(y, 16, cap=1 << 10, device="cpu")
    info = drive._pass_info(p, 100, len(METRICS), device_bytes)
    assert info[0]["packs"] is not segmented
    assert ("merge_pack" in info[0]) is segmented
    calls = []
    real = scoring.pack_survivors

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(scoring, "pack_survivors", counted)
    api.predict_links_multi(y, METRICS, 16,
                            options=api.PredictOptions(max_edges=100),
                            plan=p, device="cpu")
    # the untimed warm-up pass and the timed one
    assert len(calls) == 2 * len(METRICS) * _packs_per_scoring(info) > 0


def test_k2_roofline_counts_nine_launches_a_selection():
    """A nine-metric record: K2 launches nine times a packing selection,
    and the bytes are nine selections'; nine times fewer launches are not
    read."""
    nine = []
    for e in EVENTS:
        if e.get("cat") == "gpu_memset" and e["ts"] in (140, 240):
            continue
        if "pack_onepass" in e["name"]:
            for i in range(9):
                t = e["ts"] + 0.01 * i
                nine.append(_k("Memset (Device)", t, 0.001,
                               cat="gpu_memset"))
                nine.append(_k(e["name"], t + 0.001, 4))
                nine.append(_k("pack_fill(int const*)", t + 0.005, 1))
        elif "pack_fill" not in e["name"]:
            nine.append(e)
    rec = _record(events=nine, n_metrics=9, n_weighted=2)
    read = lambda name: load_reader("layer_metrics", name)(rec)  # noqa
    k2 = 2 * 9 * roofline.k2_bytes(1000, 64)
    assert read("k2_roofline") == pytest.approx(
        100 * k2 / 3.35e12 / (18 * (0.001 + 4 + 1) * 1e-6))
    # K1: one launch a tile whatever the metrics, 64 B a lane for nine
    assert roofline.k1_bytes([1000], wide_degrees=False, n_weighted=2,
                             n_metrics=9) == 64 * 1000
    assert read("k1_roofline") == pytest.approx(
        100 * 2 * 64 * 1000 / 3.35e12 / 20e-6)
    # a merge of segments' winners that packs counts as a selection too
    rec.passes[0]["packs"] = False
    rec.passes[0]["merge_pack"] = dict(filled=5000, kk=100)
    assert read("k2_roofline") == pytest.approx(
        100 * 2 * 9 * roofline.k2_bytes(5000, 100) / 3.35e12
        / (18 * 5.001e-6))
    assert load_reader("layer_metrics", "k2_roofline")(
        _record(n_metrics=9)) is None


def test_segments_follow_the_metrics_as_the_program_cuts_them(monkeypatch):
    from linkpred_tpu_torch.predict import scoring

    assert roofline.segments(100, 1 << 21, 1, 80 << 30) == 1
    assert roofline.segments(100, 1 << 21, 9, 80 << 30) == 2
    monkeypatch.setattr(scoring, "SEG_LANES", 1 << 29)
    for tiles in (60, 100, 300, 2200):
        for m in (1, 2, 9):
            assert scoring._segments(tiles, 1 << 21, m, "cpu")[0] == \
                roofline.segments(tiles, 1 << 21, m, 80 << 30)
