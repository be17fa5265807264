"""The command end to end on the CPU (the program's plain twins): both
traffic mixes at tiny sizes, the last line's format, a timed path broken
underneath coming out not correct, and the refusals."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from lpbench import run

from .conftest import ROOT

LHUB = {"config": {"scale": 9, "min_degree1": 16},
        "traffic": {"trace_seconds": 0.05}}
IHUB = {"config": {"scale": 8}, "traffic": {"trace_seconds": 0.05}}
SERVE = {"config": {"scale": 8},
         "traffic": {"users": 8, "warmup_requests": 1,
                     "trace_seconds": 0.05}}


def _run(capsys, cell, shrink, trace=0, seconds="0.3", seed="2147483659"):
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
])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_runs_and_prints_its_line(capsys, monkeypatch, cell, shrink,
                                         trace):
    _edge_stream(monkeypatch, cell)
    rc, out, err = _run(capsys, cell, shrink, trace)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    want = {m["name"] for m in run.metrics_for(bench, cell, bool(trace))}
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
    if cell.endswith("batch"):
        assert "plan: main: " in out


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
    rc, out, err = _run(capsys, cell, shrink)
    assert rc == 0, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False
    bad = {n for n, c in line["checks"].items() if c["value"] > c["limit"]}
    assert bad & ({"score_gap", "rank_gap"} if how == "score"
                  else {"invalid_rows"})


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
    rc, out, err = _run(capsys, "lhub-rmat23-batch", LHUB)
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
