"""The port's GraphSAGE family (``linkpred_tpu_torch.models.gnn``) against
the JAX package's ``models/gnn.py`` on the CPU, with the reference's
parameters carried across by ``convert.sage_params_from_jax``.

Everything deterministic is held value for value: the encoder and the
SDDMM decoder (rtol 1e-5, atol 1e-6: the neighbour sums add in another
order), the loss and its gradients for a fixed batch (rtol 1e-4, atol
1e-6: the gradients of those sums), one and two Adam steps against
``optax.adam`` (rtol 1e-5, atol 1e-4 of the learning rate: where a
gradient is near zero eps sets the step, and the two formulas round it
differently), the degree features (equal), the
sampled encoder on a graph of degree <= 1 (where sampling is
deterministic) against the reference's and against the full-graph encode,
and the predictors' results.  The random draws (``torch.Generator`` where
the reference takes a key) cannot equal ``jax.random``'s, so sampling and
training are held by their contract: valid neighbours, intra- above
inter-community scores, held-out AUC > 0.65, full-graph and sampled.
"""
import copy

import numpy as np
import pytest
import torch

from conftest import random_graph
from test_harness import community_graph

import jax
import jax.numpy as jnp
import optax

from linkpred_tpu import models as ref_models
from linkpred_tpu.graph import edge_list as ref_edge_list
from linkpred_tpu.models import gnn as ref_gnn
from linkpred_tpu.ops.transform import remove_self_loops as ref_rsl
from linkpred_tpu.ops.transform import symmetrize as ref_sym

import linkpred_tpu as lp
from linkpred_tpu_torch import convert, models
from linkpred_tpu_torch.models import gnn
from linkpred_tpu_torch.ops.batch import (apply_batch,
                                          generate_edge_deletions,
                                          tidy_batch)

ENC = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _port_graph(gr):
    return convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                     gr.n, gr.m)


def _np_params(params):
    return jax.tree.map(np.asarray, params)


def _ref_inputs(gr):
    esrc, edst = ref_edge_list(gr)
    return (jnp.asarray(esrc, jnp.int32), jnp.asarray(edst, jnp.int32),
            jnp.asarray(gr.degrees))


def _port_inputs(gr):
    esrc, edst = ref_edge_list(gr)
    return (torch.as_tensor(np.asarray(esrc, np.int64)),
            torch.as_tensor(np.asarray(edst, np.int64)),
            torch.as_tensor(np.asarray(gr.degrees)))


def _graphs():
    rng = np.random.default_rng(2)
    return {"random": random_graph(rng, n=80, avg_deg=4),
            "community": community_graph(rng, n_comm=4, size=12, p_in=0.5)}


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


@pytest.mark.parametrize("name", ["random", "community"])
def test_degree_features_match_reference(graphs, name):
    gr = graphs[name]
    np.testing.assert_array_equal(gnn._degree_features(_port_graph(gr)),
                                  ref_gnn._degree_features(gr))


@pytest.mark.parametrize("name", ["random", "community"])
def test_encode_and_sddmm_match_reference(graphs, name):
    gr = graphs[name]
    params = ref_gnn.sage_init(jax.random.PRNGKey(0), 8, hidden=16,
                               out_dim=12)
    feats = ref_gnn._degree_features(gr)
    want = np.asarray(ref_gnn.sage_encode(params, jnp.asarray(feats),
                                          *_ref_inputs(gr)))
    model = convert.sage_params_from_jax(_np_params(params), device="cpu")
    got = gnn.sage_encode(model, torch.as_tensor(feats), *_port_inputs(gr))
    assert got.shape == (gr.n, 12)
    np.testing.assert_allclose(got.detach().numpy(), want, **ENC)
    rng = np.random.default_rng(1)
    u, v = rng.integers(0, gr.n, 50), rng.integers(0, gr.n, 50)
    np.testing.assert_allclose(
        gnn.sddmm_scores(got, torch.as_tensor(u), torch.as_tensor(v))
        .detach().numpy(),
        np.asarray(ref_gnn.sddmm_scores(jnp.asarray(want), jnp.asarray(u),
                                        jnp.asarray(v))), **ENC)
    norms = got.norm(dim=1).detach().numpy()
    np.testing.assert_allclose(norms[np.asarray(gr.degrees) > 0], 1.0,
                               atol=1e-4)


def test_sage_params_cross_by_a_copy():
    params = _np_params(ref_gnn.sage_init(jax.random.PRNGKey(3), 8))
    model = convert.sage_params_from_jax(params, device="cpu")
    assert isinstance(model, gnn.SageModel)
    for layer in ("l1", "l2"):
        for field in ("w", "b"):
            t = getattr(getattr(model, layer), field)
            assert t.dtype == torch.float32 and t.requires_grad
            np.testing.assert_array_equal(t.detach().numpy(),
                                          params[layer][field])
    assert model.l1.w.shape == (16, 64) and model.l2.w.shape == (128, 32)
    init = gnn.sage_init(torch.Generator().manual_seed(0), 8, device="cpu")
    assert [p.shape for p in init.parameters()] == \
        [p.shape for p in model.parameters()]
    # He-normal: the std of w is sqrt(2 / din)
    assert abs(float(init.l2.w.detach().std()) - np.sqrt(2 / 128)) < 0.02
    assert not any(float(p.detach().abs().sum())
               for p in (init.l1.b, init.l2.b))


def _fixed_batch(gr, b=64):
    rng = np.random.default_rng(4)
    esrc, edst = ref_edge_list(gr)
    pos = rng.integers(0, esrc.shape[0], b)
    return (esrc[pos], edst[pos], rng.integers(0, gr.n, b),
            rng.integers(0, gr.n, b))


def _ref_loss(params, feats, gr, batch):
    pu, pv, nu, nv = (jnp.asarray(x, jnp.int32) for x in batch)

    def loss_fn(p):
        emb = ref_gnn.sage_encode(p, jnp.asarray(feats), *_ref_inputs(gr))
        ps = ref_gnn.sddmm_scores(emb, pu, pv)
        ns = ref_gnn.sddmm_scores(emb, nu, nv)
        return (jnp.mean(jax.nn.softplus(-ps))
                + jnp.mean(jax.nn.softplus(ns)))

    return jax.value_and_grad(loss_fn)(params)


def _port_loss(model, feats, gr, batch):
    emb = gnn.sage_encode(model, torch.as_tensor(feats), *_port_inputs(gr))
    idx = [torch.as_tensor(np.asarray(x, np.int64)) for x in batch]
    loss = gnn.sage_loss(*(emb[i] for i in idx))
    model.zero_grad()
    loss.backward()
    return loss


@pytest.mark.parametrize("name", ["random", "community"])
def test_loss_and_gradients_match_reference(graphs, name):
    gr = graphs[name]
    params = ref_gnn.sage_init(jax.random.PRNGKey(5), 8, hidden=16,
                               out_dim=8)
    feats = ref_gnn._degree_features(gr)
    batch = _fixed_batch(gr)
    want_loss, want_grads = _ref_loss(params, feats, gr, batch)
    model = convert.sage_params_from_jax(_np_params(params), device="cpu")
    loss = _port_loss(model, feats, gr, batch)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-6)
    for layer in ("l1", "l2"):
        for field in ("w", "b"):
            np.testing.assert_allclose(
                getattr(getattr(model, layer), field).grad.numpy(),
                np.asarray(want_grads[layer][field]), **GRAD,
                err_msg=f"{layer}.{field}")


def test_adam_steps_match_optax(graphs):
    gr = graphs["community"]
    params = _np_params(ref_gnn.sage_init(jax.random.PRNGKey(6), 8,
                                          hidden=16, out_dim=8))
    feats = ref_gnn._degree_features(gr)
    lr = 1e-2
    opt = optax.adam(lr)
    ref_p = jax.tree.map(jnp.asarray, params)
    state = opt.init(ref_p)
    model = convert.sage_params_from_jax(params, device="cpu")
    torch_opt = torch.optim.Adam(model.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    for step in range(2):
        batch = _fixed_batch(gr, 32 + step)
        _, grads = _ref_loss(ref_p, feats, gr, batch)
        updates, state = opt.update(grads, state)
        ref_p = optax.apply_updates(ref_p, updates)
        # the same gradients into the port's optimizer
        for layer in ("l1", "l2"):
            for field in ("w", "b"):
                getattr(getattr(model, layer), field).grad = \
                    torch.tensor(np.asarray(grads[layer][field]))
        torch_opt.step()
        for layer in ("l1", "l2"):
            for field in ("w", "b"):
                np.testing.assert_allclose(
                    getattr(getattr(model, layer), field).detach().numpy(),
                    np.asarray(ref_p[layer][field]), rtol=1e-5,
                    atol=1e-4 * lr,
                    err_msg=f"step {step} {layer}.{field}")


def _matching_graph():
    """Six disjoint edges and eight isolated vertices: every degree <= 1,
    so every neighbour draw is determined."""
    src = np.arange(0, 12, 2)
    return ref_rsl(ref_sym(lp.from_edges(src, src + 1, n=20)))


def test_sampled_encode_is_exact_where_sampling_is_determined():
    gr = _matching_graph()
    params = ref_gnn.sage_init(jax.random.PRNGKey(7), 8, hidden=16,
                               out_dim=8)
    feats = ref_gnn._degree_features(gr)
    seeds = np.arange(gr.n)
    want = np.asarray(ref_gnn.sage_encode_sampled(
        params, jnp.asarray(feats), jnp.asarray(gr.offsets),
        jnp.asarray(gr.indices, jnp.int32), jnp.asarray(gr.degrees),
        jnp.asarray(seeds, jnp.int32), jax.random.PRNGKey(8), (3, 4)))
    model = convert.sage_params_from_jax(_np_params(params), device="cpu")
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    got = gnn.sage_encode_sampled(
        model, t(feats), t(gr.offsets), t(gr.indices), t(gr.degrees),
        torch.as_tensor(seeds), torch.Generator().manual_seed(9), (3, 4))
    np.testing.assert_allclose(got.detach().numpy(), want, **ENC)
    full = gnn.sage_encode(model, t(feats), *_port_inputs(gr))
    np.testing.assert_allclose(got.detach().numpy(), full.detach().numpy(),
                               **ENC)


def test_sample_neighbors_valid():
    gr = random_graph(np.random.default_rng(0), n=60, avg_deg=4)
    gp = _port_graph(gr)
    nodes = torch.as_tensor([0, 5, 17, 59])
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    gen = torch.Generator().manual_seed(3)
    nbr = gnn.sample_neighbors(gen, t(gp.offsets), t(gp.indices),
                               t(gp.degrees), nodes, fanout=7).numpy()
    assert nbr.shape == (4, 7)
    deg = np.asarray(gp.degrees)
    for i, v in enumerate(nodes.tolist()):
        for w in nbr[i]:
            if deg[v] == 0:
                assert w == v  # isolated vertices self-sample
            else:
                assert gp.has_edge(int(v), int(w))
    # the draws come from the generator: the same seed, the same draws
    again = gnn.sample_neighbors(torch.Generator().manual_seed(3),
                                 t(gp.offsets), t(gp.indices), t(gp.degrees),
                                 nodes, fanout=7).numpy()
    np.testing.assert_array_equal(nbr, again)


def test_train_sage_learns_structure():
    rng = np.random.default_rng(0)
    g = _port_graph(community_graph(rng, n_comm=4, size=12, p_in=0.8))
    params, feats, loss = gnn.train_sage(g, steps=120, hidden=16, out_dim=8,
                                         seed=0, device="cpu")
    assert np.isfinite(loss)
    emb = gnn.sage_encode(params, torch.as_tensor(feats),
                          *_port_inputs(g)).detach()
    intra = float(gnn.sddmm_scores(emb, torch.arange(0, 6),
                                   torch.arange(6, 12)).mean())
    inter = float(gnn.sddmm_scores(emb, torch.arange(0, 6),
                                   torch.arange(24, 30)).mean())
    assert intra > inter


@pytest.mark.parametrize("fanouts", [None, (3, 3)], ids=["full", "sampled"])
def test_train_sage_is_its_step_function_repeated(fanouts):
    """``train_sage`` is ``_sage_trainer``'s set-up and ``steps`` calls of
    its step function: the same parameters and the same last loss."""
    rng = np.random.default_rng(1)
    g = _port_graph(community_graph(rng, n_comm=3, size=10, p_in=0.7))
    kw = dict(hidden=8, out_dim=4, seed=2, fanouts=fanouts, device="cpu")
    params, feats, loss = gnn.train_sage(g, steps=4, **kw)
    params2, feats2, step = gnn._sage_trainer(g, **kw)
    for _ in range(4):
        loss2 = step()
    np.testing.assert_array_equal(feats, feats2)
    assert loss == float(loss2)
    for a, b in zip(params.parameters(), params2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("fanouts", [None, (8, 8)], ids=["full", "sampled"])
def test_gnn_ranking_quality_auc(fanouts):
    """Held-out edges rank above random non-edges (pairwise AUC) well
    beyond chance, trained on the full graph and on sampled minibatches;
    inference is the exact full-graph encode."""
    rng = np.random.default_rng(0)
    g = _port_graph(community_graph(rng, n_comm=5, size=14, p_in=0.7))
    deletions = generate_edge_deletions(rng, g, g.size // 10,
                                        undirected=True)
    deletions, ins = tidy_batch(deletions, np.empty((0, 2), np.int64), g)
    y = apply_batch(g, deletions, ins)
    params, feats, _ = gnn.train_sage(y, steps=150, hidden=16, out_dim=8,
                                      seed=0, fanouts=fanouts, device="cpu")
    emb = gnn.sage_encode(params, torch.as_tensor(feats), *_port_inputs(y))
    pos = deletions[deletions[:, 0] < deletions[:, 1]]
    neg = []
    while len(neg) < len(pos):
        u, v = int(rng.integers(0, y.n)), int(rng.integers(0, y.n))
        if u != v and not g.has_edge(u, v):
            neg.append((min(u, v), max(u, v)))
    neg = np.asarray(neg)
    ps = gnn.sddmm_scores(emb, torch.as_tensor(pos[:, 0]),
                          torch.as_tensor(pos[:, 1])).detach().numpy()
    ns = gnn.sddmm_scores(emb, torch.as_tensor(neg[:, 0]),
                          torch.as_tensor(neg[:, 1])).detach().numpy()
    auc = float(np.mean(ps[:, None] > ns[None, :])
                + 0.5 * np.mean(ps[:, None] == ns[None, :]))
    assert auc > 0.65, f"held-out ranking AUC {auc:.3f} barely beats chance"


def _agree(got, want, where, atol=0.0):
    assert len(got) == len(want) > 0, where
    np.testing.assert_allclose(np.sort(got.score), np.sort(want.score),
                               rtol=1e-5, atol=atol, err_msg=where)
    cut = want.score.min() + 1e-5 * abs(want.score.min()) + atol
    rows = [{(int(u), int(v)) for u, v, s in zip(r.u, r.v, r.score)
             if s > cut} for r in (got, want)]
    assert rows[0] == rows[1], where


def test_predictors_match_reference():
    """With the same parameters the port's predictors give the
    reference's results; the candidates (~50) are fewer than k *
    candidate_factor, so no cut at the candidate stage can hide a
    difference."""
    gr = community_graph(np.random.default_rng(1), n_comm=3, size=12,
                         p_in=0.5)
    gp = _port_graph(gr)
    params = ref_gnn.sage_init(jax.random.PRNGKey(1), 8, hidden=16,
                               out_dim=8)
    feats = ref_gnn._degree_features(gr)
    k = 20
    cand = lp.predict_links(gr, "common_neighbors", min_degree1=0,
                            options=lp.PredictOptions(max_edges=4 * k))
    assert k < len(cand) < 4 * k
    ref_p = ref_models.GNNPredictor(params=params, feats=feats)
    port_p = models.GNNPredictor(
        params=convert.sage_params_from_jax(_np_params(params), "cpu"),
        feats=feats, device="cpu")
    assert port_p.name == ref_p.name.replace("Tpu", "Cuda")
    assert port_p.min_degree1 == ref_p.min_degree1 == 0
    got, want = port_p.predict(gp, max_edges=k), ref_p.predict(gr,
                                                              max_edges=k)
    _agree(got, want, "gnn")
    assert np.all(np.diff(got.score) <= 0)
    for min_score in (0.0, 0.5):
        _agree(port_p.predict(gp, max_edges=k, min_score=min_score),
               ref_p.predict(gr, max_edges=k, min_score=min_score),
               f"gnn min_score {min_score}")
    ref_h = ref_models.HybridPredictor(
        gnn=ref_p, heuristic=ref_models.HeuristicPredictor("cn", 0,
                                                           cap=4096))
    port_h = models.HybridPredictor(
        gnn=port_p, heuristic=models.HeuristicPredictor("cn", 0, cap=4096,
                                                        device="cpu"))
    assert port_h.name == ref_h.name.replace("Tpu", "Cuda")
    got, want = port_h.predict(gp, max_edges=k), ref_h.predict(gr,
                                                              max_edges=k)
    _agree(got, want, "hybrid", atol=1e-6)
    for u, v in zip(got.u, got.v):
        assert u < v and not gp.has_edge(int(u), int(v))


def test_models_export_the_gnn_family():
    assert models.__all__ == ref_models.__all__
    for name in ("sage_init", "sage_encode", "sage_encode_sampled",
                 "sample_neighbors", "sddmm_scores", "train_sage",
                 "GNNPredictor", "HybridPredictor"):
        assert getattr(models, name) is getattr(gnn, name)


def test_default_device_needs_the_card(monkeypatch):
    gr = _matching_graph()
    gp = _port_graph(gr)
    model = convert.sage_params_from_jax(
        _np_params(ref_gnn.sage_init(jax.random.PRNGKey(0), 8)), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: gnn.train_sage(gp, steps=1),
                 lambda: gnn.sage_init(torch.Generator(), 8),
                 lambda: convert.sage_params_from_jax({}),
                 lambda: models.GNNPredictor(copy.deepcopy(model),
                                             gnn._degree_features(gp))
                 .predict(gp, max_edges=5)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
