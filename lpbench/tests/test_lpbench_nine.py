"""The cell ``lhub9-rmat23-allmetrics`` on the CPU at a tiny size, its
configuration beside ``lhub-rmat23``'s, its entries in ``BENCHMARK.json``,
and the reader ``select_ms_per_pass.nine`` on canned slices."""
import json
import os

import pytest

from lpbench import drive, run
from lpbench.run import load_reader

from .conftest import ROOT, _json

CELL = "lhub9-rmat23-allmetrics"
# the graph LHub 23's batch cell scores: every key but the ones that
# describe the file
GRAPH_KEYS = ("generator", "scale", "edge_factor", "a", "b", "c", "permute",
              "symmetric", "removed_fraction", "method", "min_degree1",
              "whole_graph_stream", "precision", "reduced", "published")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_the_configuration_is_lhub_rmat23s_graph():
    nine = _json("configs", "lhub9-rmat23.json")
    one = _json("configs", "lhub-rmat23.json")
    for key in GRAPH_KEYS:
        assert nine[key] == one[key], key
    assert nine["source"] != one["source"]
    assert "scale_cut" in nine["assumed"]


def test_the_cell_and_its_metrics_in_the_benchmark():
    bench = _bench()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "lhub9-rmat23", "allmetrics", 1)
    layer = {m["name"] for m in run.metrics_for(bench, CELL, True)}
    assert layer == {"plan_s", "api_host_ms.batch", "api_untimed_ms.batch",
                     "sort_ms_per_pass.batch", "tile_host_us.batch",
                     "k1_roofline", "k1_host_us.batch",
                     "device_idle_pct.batch", "select_ms_per_pass.nine"}
    assert [m["name"] for m in run.metrics_for(bench, CELL, False)] == [
        "edges_per_s", "setup_s"]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_the_cpu_and_is_correct(capsys, monkeypatch,
                                                 trace):
    """The real cell through the command, shrunk to scale 10 with d1 16
    and small tiles and segments, so that its main pass selects over
    several segments as at scale 23.  Untraced it reports every metric
    listed for it; traced, every one that does not read the card's
    timeline, which a CPU run has not."""
    from linkpred_tpu_torch.predict import plan, scoring

    monkeypatch.setattr(plan, "AUTO_CAP_MIN", 1024)
    monkeypatch.setattr(scoring, "SEG_LANES", 8192)
    rc = run.main(["--workload", CELL, "--seed", "2147483659", "--seconds",
                   "0.3", "--trace", str(trace)], device="cpu",
                  shrink={"config": {"scale": 10, "min_degree1": 16},
                          "traffic": {"trace_seconds": 0.05}})
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert "plan: main: packed, 7 tiles of cap 1024" in out
    want = run.metrics_for(_bench(), CELL, bool(trace))
    assert set(line["metrics"]) == {m["name"] for m in want
                                    if m["source"] != "device_trace"}
    metrics = _json("traffic", "allmetrics.json")["metrics"]
    assert {c.rsplit(".", 1)[-1] for c in line["checks"]} == set(
        metrics) | {"missing"}
    if trace:
        assert "select_ms_per_pass.nine: no select.metric span" in err


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"stream": 7}}


def _record(n_select, kind="whole_graph", gpu=True):
    """Two scorings of a plan of 3 + 1 non-empty tiles traced over one
    call: 8 K1 launches, and ``n_select`` spans ``select.metric`` of 10 +
    i us on the card (with their host copies, and other spans, beside
    them)."""
    events = [_k("void tail_onepass<false, false, 0>(TailArgs)", 100 * i, 5)
              for i in range(8)]
    for i in range(n_select):
        events.append(_k("select.metric", 1000 + 40 * i, 10 + i,
                         cat="gpu_user_annotation" if gpu
                         else "user_annotation"))
        events.append(_k("select.metric", 1000 + 40 * i, 30 + i,
                         cat="user_annotation"))
    events.append(_k("scan.select", 1000, 5000, cat="gpu_user_annotation"))
    passes = [dict(tiles=3), dict(tiles=1)]
    return drive.Record(kind=kind, seconds=1.0, setup_s=1.0, calls=[],
                        attempted=1, failed=0, edges=100, passes=passes,
                        n_metrics=9, traced_calls=1, events=events)


def test_select_ms_reads_the_cards_spans_a_scoring(capsys):
    read = load_reader("layer_metrics", "select_ms_per_pass.nine")
    # 9 metrics x 6 selections x 2 scorings
    n = 108
    got = read(_record(n))
    assert got == pytest.approx(sum(10 + i for i in range(n)) / 1e3 / 2,
                                rel=1e-12)
    assert "108 select.metric spans over 2 scorings, 6 selections" in \
        capsys.readouterr().err


@pytest.mark.parametrize("rec,why", [
    (_record(0), "no select.metric span"),
    (_record(108, gpu=False), "no select.metric span"),
    (_record(107), "107 select.metric spans, not a multiple of 2 scorings"),
    (_record(108, kind="per_user"), "a serving run"),
])
def test_select_ms_is_silent_where_it_cannot_read(capsys, rec, why):
    read = load_reader("layer_metrics", "select_ms_per_pass.nine")
    assert read(rec) is None
    err = capsys.readouterr().err
    assert why in err and len(err.strip().splitlines()) == 1
