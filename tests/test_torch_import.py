"""The port stands alone: it imports neither jax nor the reference package
(every module, the port-side examples and scripts (read with ``ast``),
the scoring entry points, ``python -m linkpred_tpu_torch`` with its log
post-processor, the bench row, the sweep,
the models and the GraphSAGE family, npz files, the profiler helper, the
graph builder, the small host and device helpers, a one-rank mesh and two
rank processes of ``parallel.sim``), and its kernel builder fails loudly
without nvcc."""
import ast
import os
import subprocess
import sys

import pytest

from linkpred_tpu_torch.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import linkpred_tpu_torch as lt
for m in pkgutil.walk_packages(lt.__path__, "linkpred_tpu_torch."):
    importlib.import_module(m.name)
rng = np.random.default_rng(0)
src, dst = rng.integers(0, 40, 160), rng.integers(0, 40, 160)
g = lt.from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]),
                  n=40)
res = lt.predict_links(g, "jaccard", min_degree1=0, device="cpu",
                       options=lt.PredictOptions(max_edges=10))
assert len(res) == 10 and np.all(np.diff(res.score) <= 0), res
from linkpred_tpu_torch.predict.plan import build_plan
edge = build_plan(g, 0, 256, slot_budget=0, device="cpu")
assert not edge.packed
res_e = lt.predict_links(g, "jaccard", min_degree1=0, plan=edge,
                         device="cpu", options=lt.PredictOptions(max_edges=10))
assert np.array_equal(res_e.score, res.score), (res_e.score, res.score)
from linkpred_tpu_torch.ops import batch, properties, setops, topk, traverse
from linkpred_tpu_torch.ops import scan, vector
from linkpred_tpu_torch.utils import numeric, random as xr
assert lt.GraphBuilder(g).add_edge(0, 39).update().has_edge(0, 39)
assert traverse.bfs_levels(g, 0, device="cpu")[0] == 0
assert properties.communities_disconnected(
    g, np.zeros(40, int), device="cpu").size <= 1
assert xr.xorshift32_step(torch.tensor([1]), device="cpu").tolist() == [270369]
assert numeric.next_prime(13) == 17 and setops.unique_last([1, 1]).size == 1
assert len(topk.topk_merge(topk.topk_init(3, device="cpu"),
                           topk.topk_init(3, device="cpu")).u) == 3
assert int(scan.inclusive_scan(torch.arange(4))[-1]) == 6
assert vector.scatter_or(torch.zeros(2, dtype=torch.int32),
                         torch.tensor([0, 0]),
                         torch.tensor([1, 2], dtype=torch.int32)).tolist() \
    == [3, 0]
pairs, ok = batch.generate_edge_deletions_device(torch.Generator(), g, 5,
                                                 device="cpu")
assert pairs.shape == (5, 2)
from linkpred_tpu_torch.experiments.pallas_smoke import affine_smoke
assert affine_smoke(torch.arange(3, dtype=torch.int32)).tolist() == [1, 3, 5]
from linkpred_tpu_torch.experiments import (pallas_bitonic, pallas_bitonic2,
                                            radix_probe)
x = torch.as_tensor(rng.integers(-9, 9, 256).astype(np.int32)).reshape(2, 128)
want = torch.sort(x.reshape(-1)).values.reshape(2, 128)
assert torch.equal(pallas_bitonic.make_pallas_sort(256)(x), want)
assert torch.equal(pallas_bitonic2.make_sort(256)(x, x)[0], want)
offs, x = radix_probe.dynstore_inputs(rng)
out = radix_probe.dynstore_run(1, torch.as_tensor(offs), torch.as_tensor(x))
assert out.shape == (512, 128)
import contextlib, io, runpy, shutil, tempfile
from linkpred_tpu_torch.bench import process
tmp = tempfile.mkdtemp()
try:
    lt.write_mtx(g, tmp + "/toy.mtx")
    sys.argv = ["linkpred_tpu_torch", tmp + "/toy.mtx", "1", "0",
                "--device", "cpu", "--metrics", "cn", "--degrees", "0",
                "--repeat-batch", "1", "--repeat-method", "1",
                "--deletions-begin", "0.1", "--deletions-end", "0.1",
                "--seed", "1", "--cap", "4096"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module("linkpred_tpu_torch", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
    with open(tmp + "/run.log", "w") as f:
        f.write(out.getvalue())
    assert process.main(["csv", tmp + "/run.log", tmp + "/run.csv"]) == 0
    rows = process.read_log(tmp + "/run.log")["toy"]
    assert [r["technique"] for r in rows] == [
        "predictLinksCommonNeighborsCuda0"], rows
finally:
    shutil.rmtree(tmp)
import json, os
from linkpred_tpu_torch.bench import run, suite, sweep
from linkpred_tpu_torch.io import npz
from linkpred_tpu_torch.models import IHub, LHub, all_models
from linkpred_tpu_torch.utils import profiling, roofline
tmp = tempfile.mkdtemp()
try:
    os.environ.update(BENCH_DEVICE="cpu", BENCH_SCALE="8", BENCH_SAMPLES="1",
                      BENCH_REPEAT="1", BENCH_CACHE_DIR=tmp + "/cache")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run.main() == 0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    assert row["metric"] == "lhub_jaccard_coefficient_deg64_rmat8_rate", row
    assert row["hbm_model_bytes"] > 0 and "frac_of_peak" not in row, row
    with contextlib.redirect_stdout(io.StringIO()):
        assert sweep.main(["--synthetic", "ppart:3:20", "--out-dir",
                           tmp + "/sweep", "--device", "cpu", "--metrics",
                           "cn", "--degrees", "0", "--repeat-batch", "1",
                           "--repeat-method", "1", "--deletions-begin", "0.1",
                           "--deletions-end", "0.1", "--cap", "4096"]) == 0
    assert os.path.exists(tmp + "/sweep/ppart_c3_s20.csv")
    assert len(suite.REFERENCE_SUITE) == 17
    npz.save_graph(g, tmp + "/g.npz")
    assert np.array_equal(npz.load_graph(tmp + "/g.npz").indices, g.indices)
    models = all_models(degrees=(0,), device="cpu")
    assert [len(m.predict(g, max_edges=5)) for m in models[:2]] == [5, 5]
    assert IHub(device="cpu").name.endswith("Cuda0")
    assert LHub(device="cpu").name.endswith("Cuda64")
    _, table = profiling.profile_fn(torch.sort, torch.arange(9.0))
    assert table and roofline.device_peak_gbps("cpu") is None
finally:
    shutil.rmtree(tmp)
from linkpred_tpu_torch.models import gnn
from linkpred_tpu_torch.parallel import mesh as pmesh, sim
params, feats, loss = gnn.train_sage(g, steps=2, hidden=8, out_dim=4,
                                     fanouts=(2, 2), device="cpu")
assert np.isfinite(loss) and feats.shape == (40, 8)
assert len(gnn.GNNPredictor(params, feats, device="cpu").predict(
    g, max_edges=5)) == 5
one = lt.predict_links(g, "jaccard", min_degree1=0,
                       mesh=pmesh.make_mesh(device="cpu"),
                       options=lt.PredictOptions(max_edges=10))
assert np.array_equal(one.score, res.score)
# two rank processes; each fails if it imported jax or the reference
with contextlib.redirect_stdout(io.StringIO()) as out:
    assert sim.main(["2", "--device", "cpu", "--timeout", "240"]) == 0
assert out.getvalue().count("SIM {") == 2, out.getvalue()
bad = [m for m, mod in sys.modules.items() if mod is not None and (
    m.split(".")[0] in ("jax", "jaxlib", "linkpred_tpu"))]
assert not bad, bad
print("OK", len(res))
"""


def test_port_imports_no_jax_and_predicts():
    r = subprocess.run([sys.executable, "-c", _NO_JAX, REPO],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "OK 10"


def test_builder_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_SO", str(tmp_path / "missing.so"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_builder_flags_target_hopper_without_fast_math():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert not any("fast_math" in f or "fast-math" in f
                   for f in _build.NVCC_FLAGS)
    assert all(os.path.isfile(s) and s.endswith(".cu")
               for s in _build.SOURCES)



# The port-side examples and scripts, beside the JAX package's originals.
PORT_SCRIPTS = ["scripts/verify_torch.py", "scripts/bench_table_torch.py",
                "examples/serving/run_torch.py",
                "examples/ihub_vs_lhub/run_torch.py",
                "examples/multihost_sim/run_torch.py"]


@pytest.mark.parametrize("rel", PORT_SCRIPTS)
def test_port_scripts_import_no_jax(rel):
    """No import statement of the file, at any depth, names jax, jaxlib or
    the reference package; each defaults to the card."""
    src = open(os.path.join(REPO, rel)).read()
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "linkpred_tpu"}, (rel, tops)
    assert "linkpred_tpu_torch" in tops, rel
    assert 'default="cuda"' in src or \
        'os.environ.get("BENCH_DEVICE", "cuda")' in src, rel


# The engine's design probes (linkpred_tpu_torch/experiments/), and the
# helper they share.
PROBE_MODULES = sorted(
    f for f in os.listdir(os.path.join(REPO, "linkpred_tpu_torch",
                                       "experiments"))
    if f.endswith(".py") and f != "__init__.py")


@pytest.mark.parametrize("name", PROBE_MODULES)
def test_probe_modules_import_no_jax(name):
    """No import statement of a probe module, at any depth, names jax,
    jaxlib or the reference package; a design probe's entry point takes
    ``--device``, the card by default."""
    rel = os.path.join("linkpred_tpu_torch", "experiments", name)
    src = open(os.path.join(REPO, rel)).read()
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "linkpred_tpu"}, (rel, tops)
    if not name.startswith(("pallas_", "radix_", "_")):
        assert "resolve_device(args.device)" in src, rel
