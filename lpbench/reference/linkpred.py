"""Plain reference of neighbourhood link prediction, in torch operations.

It works the answer out again from the graph and the request alone: every
second-hop triple (u, mid, w) is listed, the triples of one pair (u, w) are
counted and their weights summed after one sort, pairs that are edges or
``w == u`` are dropped, and the scores are computed in ``dtype`` (float64
for the reference; bfloat16 for the control).  One block's counts and
weight sums serve every metric asked for.  It imports nothing of the
program.

Semantics (the reference paper's, as the program states them): an
intermediate ``mid`` counts when ``deg(mid) > 0`` and, for LHub
(``min_degree1 > 0``), ``deg(mid) <= min_degree1``; the count CN is the
number of such common neighbours and the degrees are the whole graph's.
The nine metrics, with ``du``, ``dw`` the pair's degrees: common neighbours
CN; Jaccard ``CN / (du + dw - CN)``; Sørensen ``CN / (du + dw)``; Salton
``CN / sqrt(du dw)``; hub-promoted ``CN / min(du, dw)``; hub-depressed
``CN / max(du, dw)``; Leicht-Holme-Newman ``CN / (du dw)``; Adamic-Adar the
sum of ``1 / ln deg(mid)``; resource allocation the sum of ``1 / deg(mid)``.
Sørensen is the reference paper's code's (``predict.hxx:579-582``): half
the Sørensen-Dice ``2 CN / (du + dw)``, in the same order.
A candidate is a pair with ``CN > 0``, not an edge, and a score above 0:
``u < w`` over the whole graph, or ``u`` in the request's sources and
``w != u``.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

__all__ = ["METRICS", "WEIGHTED", "candidate_blocks", "whole_graph_topks",
           "source_candidates", "top_per_source", "served_topk"]

METRICS = ("common_neighbors", "jaccard_coefficient", "sorensen_index",
           "salton_cosine_similarity", "hub_promoted", "hub_depressed",
           "leicht_holme_nerman", "adamic_adar", "resource_allocation")
# The metrics that sum a weight of each common neighbour.
WEIGHTED = ("adamic_adar", "resource_allocation")


def _names(metrics) -> tuple:
    """The metrics' names as a tuple, each one the reference knows."""
    names = tuple(metrics)
    for m in names:
        if m not in METRICS:
            raise KeyError(f"the reference knows {METRICS}, not {m!r}")
    return names


def _score(metric, cnt, acc, du, dw, dtype):
    if metric in WEIGHTED:
        return acc
    c = cnt.to(dtype)
    if metric == "common_neighbors":
        return c
    a, b = du.to(dtype), dw.to(dtype)
    if metric == "jaccard_coefficient":
        return c / (a + b - c)
    if metric == "sorensen_index":
        return c / (a + b)
    if metric == "salton_cosine_similarity":
        return c / torch.sqrt(a * b)
    if metric == "hub_promoted":
        return c / torch.minimum(a, b)
    if metric == "hub_depressed":
        return c / torch.maximum(a, b)
    return c / (a * b)                          # leicht_holme_nerman


def _mid_weight(metric, dmid, dtype):
    d = dmid.to(torch.float64).clamp(min=1.0)
    if metric == "adamic_adar":
        # a mid of degree 1 joins no two vertices; the clamp keeps it finite
        return 1.0 / torch.log(d.clamp(min=2.0)).to(dtype)
    return 1.0 / d.to(dtype)                    # resource_allocation


def _block_pairs(g, ekeys, src_e, mid_e, skip_e, work_e, names, dtype,
                 upper: bool):
    """The candidates of the first-hop edges given: ``(keys, scores)`` with
    ``keys = u * n + w`` sorted and distinct and ``scores [M, len(keys)]``,
    a row a metric of ``names``."""
    n, deg = g.n, g.degrees
    dev = g.indices.device
    total = int(work_e.sum())
    if total == 0:
        return (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty((len(names), 0), dtype=dtype, device=dev))
    rows = torch.repeat_interleave(
        torch.arange(work_e.shape[0], device=dev), work_e)
    start = torch.cumsum(work_e, 0) - work_e
    pos = torch.arange(total, device=dev) - start[rows]
    w = g.indices[g.offsets[mid_e[rows]] + skip_e[rows] + pos]
    u = src_e[rows]
    del pos, start
    if not upper:
        keep = w != u
        w, u, rows = w[keep], u[keep], rows[keep]
    key = u * n + w
    del u, w
    key, perm = torch.sort(key)
    rows = rows[perm]
    del perm
    keys, inv, cnt = torch.unique_consecutive(key, return_inverse=True,
                                              return_counts=True)
    del key
    accs = {}
    for m in WEIGHTED:
        if m in names:
            wt = _mid_weight(m, deg[mid_e], dtype)
            accs[m] = torch.zeros(keys.shape[0], dtype=dtype, device=dev)
            accs[m].index_add_(0, inv, wt[rows])
            del wt
    del inv, rows
    p = torch.searchsorted(ekeys, keys).clamp(max=max(ekeys.shape[0] - 1, 0))
    edge = (ekeys[p] == keys) if ekeys.shape[0] else torch.zeros_like(
        keys, dtype=torch.bool)
    keep = ~edge
    keys, cnt = keys[keep], cnt[keep]
    accs = {m: a[keep] for m, a in accs.items()}
    du, dw = deg[keys // n], deg[keys % n]
    score = torch.stack([_score(m, cnt, accs.get(m), du, dw, dtype)
                         for m in names])
    del accs, du, dw
    keep = (score > 0).all(0)
    return keys[keep], score[:, keep]


def _first_hop(g, ekeys, min_degree1: int,
               sources: Optional[torch.Tensor]):
    """``(src_e, mid_e, skip_e, work_e)`` of the first-hop edges: the
    sources' edges (every vertex's without ``sources``), how many of mid's
    neighbours each skips (those ``<= u`` over the whole graph) and how
    many it expands."""
    deg = g.degrees
    dev = g.indices.device
    if sources is None:
        src_e = torch.repeat_interleave(torch.arange(g.n, device=dev), deg)
        mid_e = g.indices
    else:
        ds = deg[sources]
        src_e = torch.repeat_interleave(sources, ds)
        first = torch.cumsum(ds, 0) - ds
        e = torch.arange(int(ds.sum()), device=dev) \
            - torch.repeat_interleave(first, ds) \
            + torch.repeat_interleave(g.offsets[sources], ds)
        mid_e = g.indices[e]
    dmid = deg[mid_e]
    ok = dmid > 0
    if min_degree1:
        ok &= dmid <= min_degree1
    if sources is None:
        # mid's neighbours are sorted: those up to u are skipped
        skip_e = torch.searchsorted(ekeys, mid_e * g.n + src_e,
                                    right=True) - g.offsets[mid_e]
    else:
        skip_e = torch.zeros_like(mid_e)
    work_e = torch.where(ok, dmid - skip_e, 0).clamp(min=0)
    return src_e, mid_e, skip_e, work_e


def candidate_blocks(g, metrics, min_degree1: int, *,
                     dtype=torch.float64, block: int = 1 << 27
                     ) -> Iterator[tuple[int, int, torch.Tensor,
                                         torch.Tensor]]:
    """Every whole-graph candidate (``u < w``), in blocks of sources of at
    most ``block`` triples (a source with more is a block of its own).
    Yields ``(u_lo, u_hi, keys, scores)``: the sources ``[u_lo, u_hi)``,
    their candidates' sorted keys and their scores ``[M, len(keys)]``, a
    row a metric of ``metrics``."""
    names = _names(metrics)
    ekeys = g.keys()
    src_e, mid_e, skip_e, work_e = _first_hop(g, ekeys, min_degree1, None)
    per_src = torch.zeros(g.n, dtype=torch.int64, device=work_e.device)
    per_src.index_add_(0, src_e, work_e)
    cum = torch.cumsum(per_src, 0)
    lo = 0
    while lo < g.n:
        base = int(cum[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(cum, base + block, right=True))
        hi = min(max(hi, lo + 1), g.n)
        e0, e1 = int(g.offsets[lo]), int(g.offsets[hi])
        keys, score = _block_pairs(
            g, ekeys, src_e[e0:e1], mid_e[e0:e1], skip_e[e0:e1],
            work_e[e0:e1], names, dtype, upper=True)
        yield lo, hi, keys, score
        lo = hi


def _order_desc(keys, score, n):
    """Rows in the program's order: score descending, ties by key."""
    # two stable sorts: by key, then by score descending
    order = torch.sort(keys, stable=True).indices
    order = order[torch.sort(score[order], descending=True,
                             stable=True).indices]
    k = keys[order]
    return k // n, k % n, score[order]


def whole_graph_topks(g, metrics, min_degree1: int, k: int, *,
                      dtype=torch.float64, block: int = 1 << 27) -> dict:
    """Each metric's top ``k`` whole-graph candidates by score, computed in
    ``dtype``, from one pass over the candidates: ``{metric: (u, v,
    score)}``, score descending (ties broken by key)."""
    names = _names(metrics)
    dev = g.indices.device
    best = {m: (torch.empty(0, dtype=torch.int64, device=dev),
                torch.empty(0, dtype=dtype, device=dev)) for m in names}
    for _, _, keys, score in candidate_blocks(g, names, min_degree1,
                                              dtype=dtype, block=block):
        for m, row in zip(names, score):
            best_k = torch.cat([best[m][0], keys])
            best_s = torch.cat([best[m][1], row])
            if best_s.shape[0] > k:
                top = torch.topk(best_s.float() if dtype == torch.bfloat16
                                 else best_s, k, sorted=False).indices
                best_k, best_s = best_k[top], best_s[top]
            best[m] = (best_k, best_s)
    return {m: _order_desc(*best[m], g.n) for m in names}


def source_candidates(g, metric: str, min_degree1: int,
                      sources: torch.Tensor, *, dtype=torch.float64):
    """Every candidate of the sources (directed, ``w != u``): ``(keys,
    scores)``, keys sorted."""
    ekeys = g.keys()
    src_e, mid_e, skip_e, work_e = _first_hop(g, ekeys, min_degree1, sources)
    keys, score = _block_pairs(g, ekeys, src_e, mid_e, skip_e, work_e,
                               _names((metric,)), dtype, upper=False)
    return keys, score[0]


def top_per_source(u, v, score, per_source: int):
    """The best ``per_source`` rows of each source, of rows given score
    descending; the rows kept stay in that order."""
    if u.shape[0] == 0:
        return u, v, score
    order = torch.sort(u, stable=True).indices
    us = u[order]
    first = torch.ones_like(us, dtype=torch.bool)
    first[1:] = us[1:] != us[:-1]
    idx = torch.arange(us.shape[0], device=us.device)
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    keep = torch.zeros_like(first)
    keep[order] = (idx - start) < per_source
    return u[keep], v[keep], score[keep]


def served_topk(g, metric: str, min_degree1: int, sources: torch.Tensor,
                max_edges: int, per_source: int, *, dtype=torch.float64):
    """A request answered by the reference: the top ``max_edges`` candidates
    of the sources, then the best ``per_source`` of each source."""
    keys, score = source_candidates(g, metric, min_degree1, sources,
                                    dtype=dtype)
    u, v, s = _order_desc(keys, score, g.n)
    return top_per_source(u[:max_edges], v[:max_edges], s[:max_edges],
                          per_source)
