"""Shared sizes of the benchmark's CPU tests."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _json(*parts):
    with open(os.path.join(ROOT, "lpbench", *parts)) as fh:
        return json.load(fh)


@pytest.fixture
def lhub_cfg():
    cfg = _json("configs", "lhub-rmat23.json")
    cfg.update(scale=9, min_degree1=16)
    return cfg


@pytest.fixture
def ihub_cfg():
    cfg = _json("configs", "ihub-rmat18.json")
    cfg.update(scale=8)
    return cfg


@pytest.fixture
def batch_traffic():
    return _json("traffic", "batch.json")


@pytest.fixture
def allmetrics():
    return _json("traffic", "allmetrics.json")


@pytest.fixture
def serve_traffic():
    t = _json("traffic", "serve.json")
    t.update(users=8, warmup_requests=1, trace_seconds=0.05)
    return t


@pytest.fixture(autouse=True)
def _tmpdir(tmp_path, monkeypatch):
    # traces of traced runs go to the test's own directory
    monkeypatch.setenv("TMPDIR", str(tmp_path))
