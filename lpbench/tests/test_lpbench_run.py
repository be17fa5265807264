"""The command end to end on the CPU (the program's plain twins): every
traffic mix at tiny sizes (the nine-metric mix in a cell of the tests'
own), the last line's format, a timed path broken underneath coming out
not correct, and the refusals."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from lpbench import drive, judge, run

from .conftest import ROOT

LHUB = {"config": {"scale": 9, "min_degree1": 16},
        "traffic": {"trace_seconds": 0.05}}
IHUB = {"config": {"scale": 8}, "traffic": {"trace_seconds": 0.05}}
SERVE = {"config": {"scale": 8},
         "traffic": {"users": 8, "warmup_requests": 1,
                     "trace_seconds": 0.05}}
ALL = "lhub-allmetrics"


def _bench():
    """``BENCHMARK.json`` with a cell of the nine-metric mix on LHub,
    reporting what the LHub batch cell reports."""
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["workloads"].append(dict(name=ALL, config="lhub-rmat23",
                                   traffic="allmetrics", chips=1,
                                   why="the tests' nine-metric cell"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "lhub-rmat23-batch" in m.get("workloads", []):
            m["workloads"].append(ALL)
    return bench


def _run(capsys, monkeypatch, cell, shrink, trace=0, seconds="0.3",
         seed="2147483659"):
    real = run._load_json
    monkeypatch.setattr(run, "_load_json", lambda *parts: _bench(
        ) if parts[-1] == "BENCHMARK.json" else real(*parts))
    rc = run.main(["--workload", cell, "--seed", seed, "--seconds", seconds,
                   "--trace", str(trace)], device="cpu", shrink=shrink)
    out, err = capsys.readouterr()
    return rc, out, err


def _edge_stream(monkeypatch, cell):
    """IHub's whole-graph plan on the edge stream at a tiny size."""
    from linkpred_tpu_torch.predict import plan

    if cell == "ihub-rmat18-batch":
        monkeypatch.setattr(plan, "SLOT_BUDGET", 0)


@pytest.mark.parametrize("cell,shrink", [
    ("lhub-rmat23-batch", LHUB),
    ("ihub-rmat18-batch", IHUB),
    ("ihub-rmat18-serve", SERVE),
    (ALL, LHUB),
])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_and_prints_its_line(capsys, monkeypatch, cell, shrink,
                                         trace):
    _edge_stream(monkeypatch, cell)
    rc, out, err = _run(capsys, monkeypatch, cell, shrink, trace)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    want = {m["name"] for m in run.metrics_for(_bench(), cell, bool(trace))}
    assert set(line["metrics"]) <= want
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if not trace:
        assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    else:
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    # the numbers beside their limits are stderr's last lines
    assert err.strip().splitlines()[-1].startswith("check ")
    if cell != "ihub-rmat18-serve":
        assert "plan: main: " in out
        assert "edges_per_s" in line["metrics"] or trace
        # the tile loop's spans, read in every batch cell's traced run
        if trace:
            assert line["metrics"]["tile_host_us.batch"]["value"] > 0
            assert line["metrics"]["k1_host_us.batch"]["value"] > 0
    if cell == ALL:
        # each of the nine metrics judged under its own names
        metrics = json.load(open(os.path.join(
            ROOT, "lpbench", "traffic", "allmetrics.json")))["metrics"]
        assert len(metrics) == 9
        assert set(line["checks"]) == {
            f"{n}.{m}" for m in metrics for n in judge.PER_METRIC} | {
            "missing"}


def _break_answers(monkeypatch, how):
    """Alter the answer where the device pass produces it."""
    from linkpred_tpu_torch.predict import api

    real = api.score_tiles

    def broken(*a, **kw):
        top = real(*a, **kw)
        if how == "score":
            top.scores[0, 0] = top.scores[0, 0] * 1.001
        else:
            top.v[0, 0] = top.u[0, 0]
        return top

    monkeypatch.setattr(api, "score_tiles", broken)


@pytest.mark.parametrize("cell,shrink", [
    ("lhub-rmat23-batch", LHUB),
    ("ihub-rmat18-batch", IHUB),
    ("ihub-rmat18-serve", SERVE),
])
@pytest.mark.parametrize("how", ["score", "pair"])
def test_an_answer_altered_where_it_is_produced_is_not_correct(
        capsys, monkeypatch, cell, shrink, how):
    _edge_stream(monkeypatch, cell)
    _break_answers(monkeypatch, how)
    rc, out, err = _run(capsys, monkeypatch, cell, shrink)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    bad = {n for n, c in line["checks"].items() if c["value"] > c["limit"]}
    assert bad & ({"score_gap", "rank_gap"} if how == "score"
                  else {"invalid_rows"})


@pytest.mark.parametrize("row,metric", [(1, "jaccard_coefficient"),
                                        (7, "adamic_adar")])
def test_one_metrics_answer_altered_fails_that_metric_alone(
        capsys, monkeypatch, row, metric):
    """One metric's score altered where the pass produces it: that
    metric's check fails and ``correct`` is false; the others pass."""
    from linkpred_tpu_torch.predict import api

    real = api.score_tiles

    def broken(*a, **kw):
        top = real(*a, **kw)
        assert kw["metric_names"][row] == metric
        top.scores[row, 0] = top.scores[row, 0] * 1.001
        return top

    monkeypatch.setattr(api, "score_tiles", broken)
    rc, out, err = _run(capsys, monkeypatch, ALL, LHUB)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    bad = {n for n, c in line["checks"].items() if c["value"] > c["limit"]}
    assert bad and all(n.endswith("." + metric) for n in bad), bad


def test_a_call_that_raises_is_counted_and_not_correct(capsys, monkeypatch):
    from linkpred_tpu_torch.predict import api

    calls = {"n": 0}
    real = api.score_tiles

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise MemoryError("planted")
        return real(*a, **kw)

    monkeypatch.setattr(api, "score_tiles", flaky)
    rc, out, err = _run(capsys, monkeypatch, "lhub-rmat23-batch", LHUB)
    line = json.loads(out.strip().splitlines()[-1])
    assert line["failed"] == 1 and line["correct"] is False
    assert line["checks"]["missing"] == {"value": 1, "limit": 0}
    assert "planted" in err


def test_no_card_no_result(capsys):
    rc = run.main(["--workload", "lhub-rmat23-batch", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    if rc == 0:
        pytest.skip("this machine has a card")
    assert out == "" and "no CUDA card" in err


def _command(cwd):
    return subprocess.run(
        [sys.executable, "-m", "lpbench.run", "--workload",
         "ihub-rmat18-serve", "--seed", "5", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300)


def test_the_command_without_a_card_exits_non_zero():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _command(ROOT)
    assert p.returncode != 0 and p.stdout == ""


def test_a_directory_of_the_benchmark_alone_exits_non_zero(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "lpbench"), tmp_path / "lpbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    p = _command(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "linkpred_tpu_torch_x", sys)
    assert "linkpred_tpu" not in run.forbidden()
    monkeypatch.setitem(sys.modules, "linkpred_tpu.graph", sys)
    assert "linkpred_tpu" in run.forbidden()


def _fixed_window(call, seconds, trace, trace_seconds, cuda):
    """Three calls, whatever the clock says, so that a serving run judges
    as many requests each time."""
    calls = []
    for _ in range(3):
        rec = call()
        rec["traced"] = None
        calls.append(rec)
    return calls, 1.0, None


@pytest.mark.parametrize("case,config,traffic,cfg,tr", [
    ("lhub", "lhub-rmat23", "batch", {"scale": 9, "min_degree1": 16}, {}),
    ("ihub", "ihub-rmat18", "batch", {"scale": 8}, {}),
    ("serve", "ihub-rmat18", "serve", {"scale": 8},
     {"users": 8, "warmup_requests": 1}),
])
def test_a_one_metric_record_is_what_the_one_metric_harness_gave(
        capsys, monkeypatch, case, config, traffic, cfg, tr):
    """A one-metric run's numbers, passes and plan line, and its counts,
    are those the harness gave before it took several metrics (recorded
    from it at the same seed and sizes, three calls a window)."""
    import numpy as np

    from linkpred_tpu_torch.predict import plan as plan_mod

    want = json.load(open(os.path.join(
        ROOT, "lpbench", "tests", "data", "one_metric_records.json")))[case]
    monkeypatch.setattr(drive, "_window", _fixed_window)
    if case == "ihub":
        monkeypatch.setattr(plan_mod, "SLOT_BUDGET", 0)

    def load(*parts):
        return json.load(open(os.path.join(ROOT, "lpbench", *parts)))

    c, t = load("configs", config + ".json"), load("traffic",
                                                    traffic + ".json")
    c.update(cfg)
    t.update(tr)
    capsys.readouterr()
    rec = drive.run(c, t, 2147483659, 0.1, False, device="cpu")
    passes = None if rec.passes is None else [
        {k: v.tolist() if isinstance(v, np.ndarray) else v
         for k, v in p.items()} for p in rec.passes]
    got = dict(numbers=rec.numbers, passes=passes,
               plan_line=capsys.readouterr().out.strip(), edges=rec.edges,
               n_metrics=rec.n_metrics, n_weighted=rec.n_weighted,
               attempted=rec.attempted, failed=rec.failed)
    assert got == want
