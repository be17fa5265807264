"""The port's heuristic model zoo against the JAX package's on the CPU, with
the same seeded graph: ``HeuristicPredictor``, ``IHub``, ``LHub`` and
``all_models`` with ``device="cpu"`` give the JAX predictors' results (the
same scores, the same pairs above the k-th score; ties at the k-th score
may pick other pairs) and names with the ``Cuda`` tag in place of ``Tpu``;
``mesh=`` takes only a port mesh (a one-rank mesh gives the plain
result), and the default device raises without a card.

Tolerances as in test_torch_predict.py: unweighted scores bit-equal except
Salton (rtol 3e-7), AA/RA rtol 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import linkpred_tpu as lp
from linkpred_tpu import models as ref_models
from linkpred_tpu.ops.transform import remove_self_loops as ref_rsl
from linkpred_tpu.ops.transform import symmetrize as ref_sym

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import models
from linkpred_tpu_torch.ops.transform import remove_self_loops, symmetrize

from test_torch_predict import _assert_same_result

CAP = 1 << 12
K = 60


@pytest.fixture(scope="module")
def graphs():
    """A 132-vertex community graph in both packages."""
    rng = np.random.default_rng(11)
    n, blocks = 132, []
    for c in range(6):
        u, v = np.nonzero(rng.random((22, 22)) < 0.4)
        blocks.append(np.stack([c * 22 + u, c * 22 + v], axis=1))
    blocks.append(rng.integers(0, n, (200, 2)))
    e = np.concatenate(blocks)
    port = remove_self_loops(symmetrize(lt.from_edges(e[:, 0], e[:, 1], n=n)))
    ref = ref_rsl(ref_sym(lp.from_edges(e[:, 0], e[:, 1], n=n)))
    return port, ref


def test_all_models_match_reference(graphs):
    port, ref = graphs
    got = models.all_models(degrees=(0, 64), device="cpu")
    want = ref_models.all_models(degrees=(0, 64))
    assert len(got) == len(want) == 2 * len(lt.METRICS)
    cache = got[0].plan_cache
    assert cache is not None and all(p.plan_cache is cache for p in got)
    for p, r in zip(got, want):
        assert (p.metric, p.min_degree1, p.max_factor2, p.cap) == \
            (r.metric, r.min_degree1, r.max_factor2, r.cap)
        assert p.device == "cpu"
        assert p.name == r.name.replace("Tpu", "Cuda")
        assert p.name.endswith(f"Cuda{p.min_degree1}")
        p.cap = r.cap = CAP
        _assert_same_result(p.predict(port, max_edges=K),
                            r.predict(ref, max_edges=K), p.metric)


@pytest.mark.parametrize("make,kw", [
    ("IHub", dict(metric="aa")),
    ("LHub", dict(metric="jaccard")),
    ("LHub", dict(metric="salton", min_degree1=8)),
    ("HeuristicPredictor", dict(metric="cn", min_degree1=4)),
], ids=["ihub-aa", "lhub-jaccard", "lhub8-salton", "predictor-cn4"])
def test_predictors_match_reference(graphs, make, kw):
    port, ref = graphs
    p = getattr(models, make)(cap=CAP, device="cpu", **kw)
    r = getattr(ref_models, make)(cap=CAP, **kw)
    assert p.metric == r.metric == lt.get_metric(kw["metric"]).name
    assert p.min_degree1 == r.min_degree1
    assert p.name == r.name.replace("Tpu", "Cuda")
    for opts in (dict(max_edges=K), dict(max_edges=K, min_score=0.05),
                 dict(max_edges=None, repeat=2)):
        _assert_same_result(p.predict(port, **opts), r.predict(ref, **opts),
                            p.metric)


def test_predictor_serving_mode_matches_reference(graphs):
    port, ref = graphs
    sources = np.array([0, 5, 23, 77, 131])
    p = models.LHub("cn", min_degree1=16, cap=CAP, device="cpu")
    r = ref_models.LHub("cn", min_degree1=16, cap=CAP)
    got = p.predict(port, max_edges=K, sources=sources)
    _assert_same_result(got, r.predict(ref, max_edges=K, sources=sources),
                        p.metric)
    assert len(got) and set(np.asarray(got.u).tolist()) <= set(sources)


def test_model_defaults_match_reference():
    got = {f.name: f.default for f in dataclasses.fields(
        models.HeuristicPredictor)}
    want = {f.name: f.default for f in dataclasses.fields(
        ref_models.HeuristicPredictor)}
    assert got.pop("device") == "cuda"
    assert got == want
    assert models.IHub().min_degree1 == 0 and models.LHub().min_degree1 == 64
    assert models.__all__ == ref_models.__all__


def test_mesh_raises(graphs):
    """A mesh that is not the port's raises; a one-rank mesh gives the
    plain result."""
    from linkpred_tpu_torch.parallel.mesh import make_mesh

    port, _ = graphs
    p = models.LHub(device="cpu", cap=CAP)
    with pytest.raises(TypeError, match="Mesh"):
        p.predict(port, mesh=object())
    got = p.predict(port, max_edges=K, mesh=make_mesh(device="cpu"))
    _assert_same_result(got, p.predict(port, max_edges=K), p.metric)


def test_default_device_needs_the_card(graphs, monkeypatch):
    port, _ = graphs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for p in (models.HeuristicPredictor(cap=CAP), models.IHub(cap=CAP),
              models.LHub(cap=CAP), models.all_models(degrees=(4,))[0]):
        assert p.device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA card"):
            p.predict(port, max_edges=K)
