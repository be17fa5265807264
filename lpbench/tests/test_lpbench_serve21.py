"""The cell ``lhub-rmat21-serve`` on the CPU at a tiny size, its
configuration beside ``lhub-rmat23``'s, its entries in ``BENCHMARK.json``,
and the reader ``side_pass_ms.serve`` on canned slices."""
import json
import os

import pytest

from lpbench import drive, run
from lpbench.run import load_reader

from .conftest import ROOT, _json

CELL = "lhub-rmat21-serve"
CONFIG = "lhub-rmat21"
# the Graph500 graph and method keys it shares with LHub 23's file
SHARED = ("generator", "edge_factor", "a", "b", "c", "permute", "symmetric",
          "removed_fraction", "method", "min_degree1", "precision",
          "reduced", "published")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_the_configuration():
    cfg = _json("configs", CONFIG + ".json")
    assert (cfg["method"], cfg["min_degree1"], cfg["scale"]) == ("LHub", 64,
                                                                  21)
    assert cfg["reduced"] == ["scale"] and cfg["published"]["scale"] == 26
    lhub23 = _json("configs", "lhub-rmat23.json")
    for key in SHARED:
        assert cfg[key] == lhub23[key], key
    assert "scale_cut" in cfg["assumed"]
    entry = next(c for c in _bench()["configs"] if c["name"] == CONFIG)
    assert entry["source"] == cfg["source"]
    assert entry["reduced"] == cfg["reduced"]
    assert entry["file"] == f"lpbench/configs/{CONFIG}.json"


def test_the_cell_and_its_metrics_in_the_benchmark():
    bench = _bench()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "serve", 1)
    assert {m["name"] for m in run.metrics_for(bench, CELL, True)} == {
        "plan_ms_p50.serve", "request_ms_p95.serve", "device_idle_pct.serve",
        "side_pass_ms.serve"}
    assert [m["name"] for m in run.metrics_for(bench, CELL, False)] == [
        "request_ms_p50", "setup_s"]
    side = next(m for m in bench["per_layer"]
                if m["name"] == "side_pass_ms.serve")
    assert (side["layer"], side["moves"], side["source"]) == (
        "tile loop", "request_ms_p50", "program_span")


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_on_the_cpu_and_is_correct(capsys, trace):
    """The real cell through the command, shrunk to scale 9 and 8 users a
    request.  No vertex reaches degree 2^16 at that size, so no request
    has a side plan and ``side_pass_ms.serve`` stays silent; traced, the
    line reports every metric that does not read the card's timeline."""
    rc = run.main(["--workload", CELL, "--seed", "2147483659", "--seconds",
                   "0.3", "--trace", str(trace)], device="cpu",
                  shrink={"config": {"scale": 9},
                          "traffic": {"users": 8, "warmup_requests": 1,
                                      "trace_seconds": 0.05}})
    out, err = capsys.readouterr()
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert "last warm-up request's plan: main: packed" in out
    if trace:
        assert set(line["metrics"]) == {"plan_ms_p50.serve",
                                        "request_ms_p95.serve"}
    else:
        assert set(line["metrics"]) == {"request_ms_p50", "setup_s"}


def _a(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _record(n_side, kind="per_user", traced=2):
    """``n_side`` spans ``scan.side`` of 100 + i us on the host (with
    their copies on the card's timeline and other spans beside them) over
    ``traced`` requests."""
    events = [_a("scan.pass", 0, 9000), _a("api.score", 0, 20000)]
    for i in range(n_side):
        events.append(_a("scan.side", 1000 * i, 100 + i))
        events.append(_a("scan.side", 1000 * i, 50, cat="gpu_user_annotation"))
    return drive.Record(kind=kind, seconds=1.0, setup_s=1.0, calls=[],
                        attempted=traced, failed=0, edges=100,
                        traced_calls=traced, events=events)


def test_side_pass_ms_sums_the_host_spans_a_request():
    read = load_reader("layer_metrics", "side_pass_ms.serve")
    # a warm-up scoring and a timed one of each of 2 requests
    assert read(_record(4)) == pytest.approx(
        sum(100 + i for i in range(4)) / 1e3 / 2, rel=1e-12)
    assert read(_record(3, traced=3)) == pytest.approx(0.101, rel=1e-12)


@pytest.mark.parametrize("rec", [
    _record(4, kind="whole_graph"),
    _record(0),
    _record(4, traced=0),
])
def test_side_pass_ms_is_silent_where_it_cannot_read(rec):
    read = load_reader("layer_metrics", "side_pass_ms.serve")
    assert read(rec) is None
