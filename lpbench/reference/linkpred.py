"""Plain reference of neighbourhood link prediction, in torch operations.

It works the answer out again from the graph and the request alone: every
second-hop triple (u, mid, w) is listed, the triples of one pair (u, w) are
counted and their weights summed after one sort, pairs that are edges or
``w == u`` are dropped, and the score is computed in ``dtype`` (float64 for
the reference; bfloat16 for the control).  It imports nothing of the
program.

Semantics (the reference paper's, as the program states them): an
intermediate ``mid`` counts when ``deg(mid) > 0`` and, for LHub
(``min_degree1 > 0``), ``deg(mid) <= min_degree1``; the count is the number
of such common neighbours and the degrees are the whole graph's; Jaccard is
``cnt / (deg u + deg w - cnt)``, Adamic-Adar the sum of ``1 / log deg(mid)``.
A candidate is a pair with ``cnt > 0``, not an edge, and a score above 0:
``u < w`` over the whole graph, or ``u`` in the request's sources and
``w != u``.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

__all__ = ["METRICS", "candidate_blocks", "whole_graph_topk",
           "source_candidates", "top_per_source", "served_topk"]

METRICS = ("jaccard_coefficient", "adamic_adar")


def _score(metric, cnt, acc, du, dw, dtype):
    if metric == "jaccard_coefficient":
        c = cnt.to(dtype)
        return c / (du.to(dtype) + dw.to(dtype) - c)
    if metric == "adamic_adar":
        return acc
    raise KeyError(f"the reference knows {METRICS}, not {metric!r}")


def _mid_weight(metric, dmid, dtype):
    if metric != "adamic_adar":
        return None
    return 1.0 / torch.log(dmid.to(torch.float64).clamp(min=2.0)).to(dtype)


def _block_pairs(g, ekeys, src_e, mid_e, skip_e, work_e, metric, dtype,
                 upper: bool):
    """The candidates of the first-hop edges given: ``(keys, scores)`` with
    ``keys = u * n + w`` sorted and distinct."""
    n, deg = g.n, g.degrees
    dev = g.indices.device
    total = int(work_e.sum())
    empty = (torch.empty(0, dtype=torch.int64, device=dev),
             torch.empty(0, dtype=dtype, device=dev))
    if total == 0:
        return empty
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
    wt = _mid_weight(metric, deg[mid_e], dtype)
    key, perm = torch.sort(key)
    rows = rows[perm]
    del perm
    keys, inv, cnt = torch.unique_consecutive(key, return_inverse=True,
                                              return_counts=True)
    del key
    acc = None
    if wt is not None:
        acc = torch.zeros(keys.shape[0], dtype=dtype, device=dev)
        acc.index_add_(0, inv, wt[rows])
    del inv, rows
    p = torch.searchsorted(ekeys, keys).clamp(max=max(ekeys.shape[0] - 1, 0))
    edge = (ekeys[p] == keys) if ekeys.shape[0] else torch.zeros_like(
        keys, dtype=torch.bool)
    keep = ~edge
    keys, cnt = keys[keep], cnt[keep]
    acc = acc[keep] if acc is not None else None
    u, w = keys // n, keys % n
    score = _score(metric, cnt, acc, deg[u], deg[w], dtype)
    keep = score > 0
    return keys[keep], score[keep]


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


def candidate_blocks(g, metric: str, min_degree1: int, *,
                     dtype=torch.float64, block: int = 1 << 27
                     ) -> Iterator[tuple[int, int, torch.Tensor,
                                         torch.Tensor]]:
    """Every whole-graph candidate (``u < w``), in blocks of sources of at
    most ``block`` triples (a source with more is a block of its own).
    Yields ``(u_lo, u_hi, keys, scores)``: the sources ``[u_lo, u_hi)``,
    their candidates' sorted keys and their scores."""
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
            work_e[e0:e1], metric, dtype, upper=True)
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


def whole_graph_topk(g, metric: str, min_degree1: int, k: int, *,
                     dtype=torch.float64, block: int = 1 << 27):
    """The top ``k`` whole-graph candidates by score, computed in ``dtype``:
    ``(u, v, score)`` tensors, score descending (ties broken by key)."""
    dev = g.indices.device
    best_k = torch.empty(0, dtype=torch.int64, device=dev)
    best_s = torch.empty(0, dtype=dtype, device=dev)
    for _, _, keys, score in candidate_blocks(g, metric, min_degree1,
                                              dtype=dtype, block=block):
        best_k = torch.cat([best_k, keys])
        best_s = torch.cat([best_s, score])
        if best_s.shape[0] > k:
            top = torch.topk(best_s.float() if dtype == torch.bfloat16
                             else best_s, k, sorted=False).indices
            best_k, best_s = best_k[top], best_s[top]
    return _order_desc(best_k, best_s, g.n)


def source_candidates(g, metric: str, min_degree1: int,
                      sources: torch.Tensor, *, dtype=torch.float64):
    """Every candidate of the sources (directed, ``w != u``): ``(keys,
    scores)``, keys sorted."""
    ekeys = g.keys()
    src_e, mid_e, skip_e, work_e = _first_hop(g, ekeys, min_degree1, sources)
    return _block_pairs(g, ekeys, src_e, mid_e, skip_e, work_e, metric,
                        dtype, upper=False)


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
