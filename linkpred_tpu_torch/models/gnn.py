"""GraphSAGE encoder + SDDMM decoder: the learned and hybrid predictors
(counterpart of ``linkpred_tpu/models/gnn.py``).

A 2-layer GraphSAGE mean aggregator (the SpMM over the CSR edge list is one
gather of neighbour features and one ``index_add`` into their sources),
an SDDMM dot decoder that scores only the candidate pairs, and a hybrid
that mixes the learned score with a heuristic metric's over the same
pairs.  Candidates come from the heuristic engine (``predict_links``: the
tile sort, K1, K2); the model itself has no hand-written kernel, and its
gradients come from autograd.

The weight layout is the reference's, ``w [din, dout]`` and ``b [dout]``
per layer, so ``convert.sage_params_from_jax`` carries its parameters
across by a copy.  Every random draw takes an explicit ``torch.Generator``
where the reference takes a key; its draws cannot equal ``jax.random``'s.
Functions run on their tensors' device; entry points take ``device=``
(the card unless the caller names the CPU).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..graph import CSRGraph, edge_list
from ..predict.api import PredictOptions, PredictResult, predict_links
from ..utils.device import resolve_device
from .heuristic import HeuristicPredictor

__all__ = ["SageLayer", "SageModel", "sage_init", "sage_encode",
           "sage_encode_sampled", "sample_neighbors", "sddmm_scores",
           "GNNPredictor", "HybridPredictor", "train_sage"]


class SageLayer(nn.Module):
    """``concat(self, mean-neighbours) @ w + b`` with the reference's
    layout: ``w [din, dout]``, ``b [dout]``."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class SageModel(nn.Module):
    """The two layers ``l1`` and ``l2`` (:func:`sage_encode` applies
    them)."""

    def __init__(self, l1: SageLayer, l2: SageLayer):
        super().__init__()
        self.l1 = l1
        self.l2 = l2


def _dense(generator: torch.Generator, din: int, dout: int) -> SageLayer:
    # He-normal, drawn on the generator's device (the CPU by default)
    w = torch.randn((din, dout), generator=generator,
                    device=generator.device) * math.sqrt(2.0 / din)
    return SageLayer(w, torch.zeros(dout, device=generator.device))


def sage_init(generator: torch.Generator, in_dim: int, hidden: int = 64,
              out_dim: int = 32, *, device="cuda") -> SageModel:
    """The 2-layer GraphSAGE model on ``device``, drawn from
    ``generator``; each layer is ``concat(self, mean-neighbours) @ w``."""
    device = resolve_device(device)
    return SageModel(_dense(generator, 2 * in_dim, hidden),
                     _dense(generator, 2 * hidden, out_dim)).to(device)


def _mean_aggregate(h, esrc, edst, degrees):
    """SpMM (mean aggregator): each vertex's mean of its neighbours'
    features, one gather and one ``index_add`` over the directed edge
    list."""
    agg = h.new_zeros(h.shape).index_add(0, esrc, h[edst])
    return agg / degrees.clamp(min=1).to(h.dtype)[:, None]


def _layer(p: SageLayer, h, esrc, edst, degrees, act=F.relu):
    nbr = _mean_aggregate(h, esrc, edst, degrees)
    return act(p(torch.cat([h, nbr], dim=1)))


def _normalize(h):
    return h / h.norm(dim=1, keepdim=True).clamp(min=1e-6)


def sage_encode(params: SageModel, feats, esrc, edst, degrees):
    """Node embeddings: 2 GraphSAGE layers, L2-normalized output.
    ``esrc``/``edst`` are the directed edge list (int64)."""
    h = _layer(params.l1, feats, esrc, edst, degrees)
    h = _layer(params.l2, h, esrc, edst, degrees, act=lambda x: x)
    return _normalize(h)


def sddmm_scores(emb, u, v):
    """SDDMM dot decoder: the score of each pair (u, v), computed only at
    those pairs."""
    return (emb[u] * emb[v]).sum(dim=1)


def sample_neighbors(generator: torch.Generator, offsets, indices, degrees,
                     nodes, fanout: int):
    """Uniform neighbour sampling with replacement: ``[*nodes.shape,
    fanout]`` neighbour ids, one draw and one gather per (node, slot).
    Isolated vertices sample themselves (a valid index);
    :func:`sage_encode_sampled` zero-masks their aggregate.  ``generator``
    lives on the nodes' device."""
    r = torch.randint(0, 1 << 30, (*nodes.shape, fanout),
                      generator=generator, device=nodes.device)
    deg = degrees[nodes].to(torch.int64)
    slot = r % deg.clamp(min=1)[..., None]
    adr = offsets[nodes].to(torch.int64)[..., None] + slot
    nbr = indices[adr.reshape(-1)].reshape(adr.shape).to(nodes.dtype)
    return torch.where((deg > 0)[..., None], nbr, nodes[..., None])


def sage_encode_sampled(params: SageModel, feats, offsets, indices, degrees,
                        seeds, generator: torch.Generator,
                        fanouts=(10, 10)):
    """Minibatch GraphSAGE: embeddings of ``seeds`` only, aggregating over
    fixed-fanout sampled neighbourhoods (the standard estimator of
    :func:`sage_encode`'s mean, with the same parameters).  Shapes: seeds
    [B] -> level-1 nodes [B, F2] -> level-2 samples [B, F2, F1].  Nodes of
    degree 0 get a zero neighbour aggregate, as in the full-graph
    encode."""
    f2, f1 = fanouts
    n1 = sample_neighbors(generator, offsets, indices, degrees, seeds, f2)
    n2 = sample_neighbors(generator, offsets, indices, degrees,
                          n1.reshape(-1), f1).reshape(*n1.shape, f1)
    ns = sample_neighbors(generator, offsets, indices, degrees, seeds, f1)

    def l1(x, nbrs, deg):
        agg = torch.where((deg > 0)[..., None], nbrs.mean(dim=-2),
                          torch.zeros((), dtype=x.dtype, device=x.device))
        return F.relu(params.l1(torch.cat([x, agg], dim=-1)))

    h1_seed = l1(feats[seeds], feats[ns], degrees[seeds])
    h1_nbr = l1(feats[n1], feats[n2], degrees[n1])            # [B, F2, H]
    agg2 = torch.where((degrees[seeds] > 0)[..., None], h1_nbr.mean(dim=1),
                       torch.zeros((), dtype=h1_nbr.dtype,
                                   device=h1_nbr.device))
    return _normalize(params.l2(torch.cat([h1_seed, agg2], dim=-1)))


def _degree_features(g: CSRGraph, dim: int = 8) -> np.ndarray:
    """Featureless-graph default input: log-degree + positional
    harmonics."""
    deg = np.asarray(g.host().degrees, dtype=np.float64)
    base = np.log1p(deg)[:, None]
    ks = np.arange(1, dim, dtype=np.float64)[None, :]
    harm = np.sin(base * ks / np.log(2.0 + deg.max()))
    return np.concatenate([base, harm], axis=1).astype(np.float32)


def _graph_tensors(g: CSRGraph, device):
    """(esrc, edst) int64, degrees, offsets, indices of ``g`` on
    ``device``."""
    g = g.host()
    esrc, edst = edge_list(g)
    return (torch.as_tensor(esrc, device=device),
            torch.as_tensor(edst, device=device),
            torch.as_tensor(g.degrees, device=device),
            torch.as_tensor(g.offsets, device=device),
            torch.as_tensor(g.indices, device=device))


def sage_loss(emb_pos_u, emb_pos_v, emb_neg_u, emb_neg_v):
    """Logistic loss on dot scores: positives pushed up, negatives down."""
    ps = (emb_pos_u * emb_pos_v).sum(dim=1)
    ns = (emb_neg_u * emb_neg_v).sum(dim=1)
    return F.softplus(-ps).mean() + F.softplus(ns).mean()


def _sage_trainer(
    g: CSRGraph,
    feats: Optional[np.ndarray] = None,
    hidden: int = 64,
    out_dim: int = 32,
    lr: float = 1e-2,
    neg_ratio: int = 1,
    seed: int = 0,
    fanouts: Optional[tuple] = None,
    *,
    device="cuda",
):
    """:func:`train_sage`'s set-up: ``(params, feats, step)``, where
    ``step()`` takes one training step and returns its loss as a 0-d
    tensor on ``device`` (no host sync)."""
    device = resolve_device(device)
    g = g.host()
    esrc, edst, degrees, offsets, indices = _graph_tensors(g, device)
    if feats is None:
        feats = _degree_features(g)
    feats_t = torch.as_tensor(feats, device=device)
    params = sage_init(torch.Generator().manual_seed(seed), feats.shape[1],
                       hidden, out_dim, device=device)
    opt = torch.optim.Adam(params.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    gen = torch.Generator(device=device).manual_seed(seed)
    m, n = int(esrc.shape[0]), g.n
    batch = min(4096, max(m, 1))

    def draw(high, size):
        return torch.randint(0, high, (size,), generator=gen, device=device)

    def step():
        pos = draw(max(m, 1), batch)
        pu, pv = esrc[pos], edst[pos]
        nu, nv = draw(n, batch * neg_ratio), draw(n, batch * neg_ratio)
        opt.zero_grad(set_to_none=True)
        if fanouts is not None:
            seeds = torch.cat([pu, pv, nu, nv])
            emb = sage_encode_sampled(params, feats_t, offsets, indices,
                                      degrees, seeds, gen, fanouts)
            parts = torch.split(emb, [batch, batch, batch * neg_ratio,
                                      batch * neg_ratio])
        else:
            emb = sage_encode(params, feats_t, esrc, edst, degrees)
            parts = (emb[pu], emb[pv], emb[nu], emb[nv])
        loss = sage_loss(*parts)
        loss.backward()
        opt.step()
        return loss.detach()

    return params, feats, step


def train_sage(
    g: CSRGraph,
    feats: Optional[np.ndarray] = None,
    hidden: int = 64,
    out_dim: int = 32,
    steps: int = 200,
    lr: float = 1e-2,
    neg_ratio: int = 1,
    seed: int = 0,
    fanouts: Optional[tuple] = None,
    *,
    device="cuda",
):
    """Self-supervised training on ``device``: observed edges positive,
    uniform pairs negative, logistic loss on the SDDMM dot score, Adam
    with optax's defaults.  Returns ``(params, feats, final_loss)``.

    ``fanouts=(F2, F1)`` trains on neighbour-sampled minibatches
    (:func:`sage_encode_sampled`, O(B F2 F1) per step whatever the graph
    size); ``None`` encodes the full graph each step.  The parameters are
    interchangeable, so inference uses the exact full-graph encode.  The
    weights are drawn from a CPU generator seeded with ``seed``, the
    batches from one on ``device``."""
    params, feats, step = _sage_trainer(g, feats, hidden, out_dim, lr,
                                        neg_ratio, seed, fanouts,
                                        device=device)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        loss = step()
    return params, feats, float(loss)


def _encode_graph(params: SageModel, feats, g: CSRGraph, device):
    """The full-graph embeddings of ``g`` on ``device``, encoded with a
    copy of ``params`` there: ``nn.Module.to`` moves in place, and the
    caller's model stays where it is."""
    params = copy.deepcopy(params).to(device)
    esrc, edst, degrees, _, _ = _graph_tensors(g, device)
    with torch.no_grad():
        return sage_encode(params,
                           torch.as_tensor(feats, device=device), esrc, edst,
                           degrees)


def _pair_scores(emb, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    device = emb.device
    return sddmm_scores(emb, torch.as_tensor(u, dtype=torch.int64,
                                             device=device),
                        torch.as_tensor(v, dtype=torch.int64,
                                        device=device)).cpu().numpy()


@dataclasses.dataclass
class GNNPredictor:
    """GraphSAGE + SDDMM: candidate pairs come from the heuristic engine
    (an exact top-k universe), scores from the learned decoder on
    ``device`` (with a copy of ``params``; the model itself is not
    moved)."""
    params: SageModel
    feats: np.ndarray
    candidate_metric: str = "common_neighbors"
    min_degree1: int = 0
    candidate_factor: int = 4   # score this multiple of max_edges candidates
    name: str = "predictLinksGraphSageSDDMMCuda"
    device: str = "cuda"

    def predict(self, g: CSRGraph, max_edges: Optional[int] = None,
                min_score: float = float("-inf")) -> PredictResult:
        device = resolve_device(self.device)
        g = g.host()
        k = max_edges or (1 << 15)
        cand = predict_links(
            g, metric=self.candidate_metric, min_degree1=self.min_degree1,
            options=PredictOptions(max_edges=k * self.candidate_factor),
            device=device)
        s = _pair_scores(_encode_graph(self.params, self.feats, g, device),
                         cand.u, cand.v)
        order = np.argsort(-s, kind="stable")[:k]
        order = order[s[order] > min_score]
        return PredictResult(
            u=cand.u[order], v=cand.v[order],
            score=s[order].astype(np.float32),
            time_ms=cand.time_ms, scoring_ms=cand.scoring_ms)


@dataclasses.dataclass
class HybridPredictor:
    """A heuristic metric's score mixed with the learned SDDMM score over
    the SAME candidate pairs: ``(1 - alpha) * heuristic / max|heuristic|
    + alpha * gnn``.  The heuristic scores on its own device, the GNN on
    ``gnn.device``."""
    gnn: GNNPredictor
    heuristic: HeuristicPredictor
    alpha: float = 0.5
    name: str = "predictLinksHybridCuda"

    def predict(self, g: CSRGraph,
                max_edges: Optional[int] = None) -> PredictResult:
        g = g.host()
        k = max_edges or (1 << 15)
        base = self.heuristic.predict(
            g, max_edges=k * self.gnn.candidate_factor)
        gs = _pair_scores(_encode_graph(self.gnn.params, self.gnn.feats, g,
                                        resolve_device(self.gnn.device)),
                          base.u, base.v)
        hs = base.score
        hmax = float(np.abs(hs).max()) if hs.size else 1.0
        mixed = (1 - self.alpha) * (hs / max(hmax, 1e-9)) + self.alpha * gs
        order = np.argsort(-mixed, kind="stable")[:k]
        return PredictResult(
            u=base.u[order], v=base.v[order],
            score=mixed[order].astype(np.float32),
            time_ms=base.time_ms, scoring_ms=base.scoring_ms)
