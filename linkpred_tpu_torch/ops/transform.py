"""Graph transforms (counterpart of ``linkpred_tpu/ops/transform.py``).

Each transform is a pure function of a :class:`CSRGraph` that builds a new
one with one vectorised NumPy pass (host work, done once per experiment
setup).
"""
from __future__ import annotations

import numpy as np

from ..graph import CSRGraph, edge_list, from_edges

__all__ = ["symmetrize", "remove_self_loops", "add_self_loops",
           "count_self_loops", "transpose", "transpose_with_degree",
           "duplicate", "duplicate_if", "subgraph"]


def _edge_weights(g: CSRGraph):
    return None if g.weights is None else np.asarray(g.host().weights[: g.m])


def symmetrize(g: CSRGraph) -> CSRGraph:
    """Union of the graph and its reverse."""
    src, dst = edge_list(g)
    w = _edge_weights(g)
    return from_edges(
        np.concatenate([src, dst]), np.concatenate([dst, src]), n=g.n,
        weights=None if w is None else np.concatenate([w, w]))


def remove_self_loops(g: CSRGraph) -> CSRGraph:
    """Drop u→u edges."""
    return duplicate_if(g, lambda u, v: u != v)


def add_self_loops(g: CSRGraph) -> CSRGraph:
    """Add u→u for every vertex (the result is unweighted)."""
    src, dst = edge_list(g)
    loops = np.arange(g.n, dtype=np.int64)
    return from_edges(np.concatenate([src, loops]),
                      np.concatenate([dst, loops]), n=g.n)


def count_self_loops(g: CSRGraph) -> int:
    src, dst = edge_list(g)
    return int(np.count_nonzero(src == dst))


def transpose(g: CSRGraph) -> CSRGraph:
    """Reverse every edge, weights kept."""
    src, dst = edge_list(g)
    return from_edges(dst, src, n=g.n, weights=_edge_weights(g))


def transpose_with_degree(g: CSRGraph):
    """Transpose, with each vertex's out-degree in ``g`` as its vertex
    value.  Returns ``(gT, out_degree)`` with ``gT.values`` that degree."""
    deg = np.asarray(g.host().degrees).copy()
    return transpose(g).with_vertex_values(deg), deg


def subgraph(g: CSRGraph, ks) -> CSRGraph:
    """Induced subgraph over the vertex subset ``ks``: vertices renumbered
    to [0, len(ks)) in ``ks`` order, edges kept when both ends are in the
    subset, with their weights and the subset's vertex values."""
    gh = g.host()
    ks = np.asarray(ks, dtype=np.int64)
    deg = np.asarray(gh.degrees, dtype=np.int64)
    offs = np.asarray(gh.offsets, dtype=np.int64)
    inds = np.asarray(gh.indices, dtype=np.int64)
    remap = np.full(g.n, -1, dtype=np.int64)
    remap[ks] = np.arange(ks.shape[0], dtype=np.int64)
    # the subset's adjacency rows, addressed by repeat + cumsum
    dk = deg[ks]
    step = np.arange(int(dk.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(dk) - dk, dk)
    adr = np.repeat(offs[ks], dk) + step
    dst = inds[adr]
    src = np.repeat(remap[ks], dk)
    keep = remap[dst] >= 0
    w = None if gh.weights is None else np.asarray(gh.weights)[adr][keep]
    out = from_edges(src[keep], remap[dst[keep]], n=ks.shape[0], weights=w)
    if gh.values is not None:
        out = out.with_vertex_values(np.asarray(gh.values)[ks])
    return out


def duplicate(g: CSRGraph) -> CSRGraph:
    """A copy: the graph is immutable, so its arrays are shared."""
    return CSRGraph(g.offsets, g.indices, g.degrees, g.weights, g.n, g.m,
                    values=g.values)


def duplicate_if(g: CSRGraph, pred) -> CSRGraph:
    """The edges for which ``pred(src, dst)`` (a vectorised predicate over
    int64 arrays) is true, weights kept."""
    src, dst = edge_list(g)
    keep = np.asarray(pred(src, dst), dtype=bool)
    w = _edge_weights(g)
    return from_edges(src[keep], dst[keep], n=g.n,
                      weights=None if w is None else w[keep])
