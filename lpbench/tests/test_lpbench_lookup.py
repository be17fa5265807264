"""Name lookup: a cell's files and its metrics are found by the names
``BENCHMARK.json`` gives, so a later cell or metric is a file dropped in."""
import json
import os

import pytest

from lpbench import run

from .conftest import ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_every_entry_has_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell, cfg, traffic = run.cell_of(bench, w["name"])
        assert cfg["source"] == next(c["source"] for c in bench["configs"]
                                     if c["name"] == w["config"])
        assert traffic["kind"] in ("whole_graph", "per_user")
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["reduced"] == c["reduced"]
    for m in bench["end_to_end"]:
        assert callable(run.load_reader("end_to_end", m["name"]))
    for m in bench["per_layer"]:
        assert callable(run.load_reader("layer_metrics", m["name"]))


def test_files_dropped_in_are_found(tmp_path):
    base = tmp_path / "lpbench"
    for d in ("configs", "traffic", "layer_metrics"):
        (base / d).mkdir(parents=True)
    (base / "configs" / "newgraph.json").write_text('{"scale": 5}')
    (base / "traffic" / "burst.json").write_text('{"kind": "per_user"}')
    (base / "layer_metrics" / "queue_ms.serve.py").write_text(
        "def read(rec):\n    return rec * 2\n")
    bench = {"workloads": [{"name": "newgraph-burst", "config": "newgraph",
                            "traffic": "burst", "chips": 1}]}
    cell, cfg, traffic = run.cell_of(bench, "newgraph-burst", base=str(base))
    assert cfg == {"scale": 5} and traffic == {"kind": "per_user"}
    assert run.load_reader("layer_metrics", "queue_ms.serve",
                           base=str(base))(21) == 42


def test_metrics_for_a_cell():
    bench = _bench()
    names = lambda c, t: [m["name"] for m in run.metrics_for(bench, c, t)]  # noqa
    assert names("ihub-rmat18-serve", False) == [
        "request_ms_p50", "setup_s"]
    assert names("lhub-rmat23-batch", False) == ["edges_per_s", "setup_s"]
    assert "k2_roofline" in names("lhub-rmat23-batch", True)
    assert "plan_ms_p50.serve" in names("ihub-rmat18-serve", True)
    assert "request_ms_p95.serve" in names("ihub-rmat18-serve", True)
    assert "api_host_ms.batch" not in names("ihub-rmat18-serve", True)
    # every per-layer entry names its cells
    assert all(m["workloads"] for m in bench["per_layer"])
    bench["per_layer"].append({"name": "x", "moves": "request_ms_p50"})
    with pytest.raises(KeyError):
        names("ihub-rmat18-serve", True)
