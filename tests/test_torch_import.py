"""The port stands alone: it imports neither jax nor the reference package,
and its kernel builder fails loudly without nvcc."""
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

