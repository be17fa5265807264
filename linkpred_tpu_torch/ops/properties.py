"""Graph properties: degrees, edge weight, modularity, communities
(counterpart of ``linkpred_tpu/ops/properties.py``).

Host NumPy in float64, the same arithmetic as the reference package, so
modularity agrees exactly.  Modularity reduces the edge list with one
``bincount`` keyed by community; ``communities_disconnected`` runs the
port's device BFS (:func:`~.traverse.bfs_levels`) once per community, from
its smallest member.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..graph import CSRGraph, edge_list, from_edges
from ..utils.device import resolve_device
from .traverse import bfs_levels

__all__ = ["vertex_keys", "degrees", "edge_weight", "modularity_communities",
           "modularity", "modularity_by", "community_size",
           "community_vertices", "communities", "communities_disconnected"]


def vertex_keys(g: CSRGraph) -> np.ndarray:
    """All vertex ids."""
    return np.arange(g.n, dtype=np.int64)


def degrees(g: CSRGraph) -> np.ndarray:
    """Out-degrees."""
    return np.asarray(g.host().degrees, dtype=np.int64)


def edge_weight(g: CSRGraph) -> float:
    """Total edge weight; an unweighted edge counts 1."""
    g = g.host()
    if g.weights is None:
        return float(g.m)
    return float(np.asarray(g.weights[: g.m], dtype=np.float64).sum())


def _edge_weights_arr(g: CSRGraph) -> np.ndarray:
    if g.weights is None:
        return np.ones(g.m, dtype=np.float64)
    return np.asarray(g.weights[: g.m], dtype=np.float64)


def modularity_communities(g: CSRGraph, x: np.ndarray,
                           M: Optional[float] = None, R: float = 1.0):
    """Per community, the weight of its internal edges and of all edges
    leaving its members (directed sums).  Returns float64 ``(cin, ctot)``
    indexed by community id; ``M`` and ``R`` are accepted for the
    reference's signature."""
    g = g.host()
    x = np.asarray(x, dtype=np.int64)
    src, dst = edge_list(g)
    w = _edge_weights_arr(g)
    ncomm = int(x.max()) + 1 if x.size else 0
    same = x[src] == x[dst]
    cin = np.bincount(x[src], weights=w * same, minlength=ncomm)
    ctot = np.bincount(x[src], weights=w, minlength=ncomm)
    return cin, ctot


def modularity_by(g: CSRGraph, x: np.ndarray, M: Optional[float] = None,
                  R: float = 1.0) -> float:
    """Modularity of the community assignment ``x``: the sum over
    communities of ``cin/(2M) - R (ctot/(2M))^2``, with ``M`` the
    undirected edge weight (default half the directed total)."""
    if M is None:
        M = edge_weight(g) / 2
    if M <= 0:
        return 0.0
    cin, ctot = modularity_communities(g, x)
    return float((cin / (2 * M) - R * (ctot / (2 * M)) ** 2).sum())


def modularity(g: CSRGraph, M: Optional[float] = None,
               R: float = 1.0) -> float:
    """Modularity with every vertex its own community."""
    return modularity_by(g, np.arange(g.n, dtype=np.int64), M=M, R=R)


def community_size(x: np.ndarray, c: int) -> int:
    """Members of community ``c``."""
    return int((np.asarray(x) == c).sum())


def community_vertices(x: np.ndarray, c: int) -> np.ndarray:
    """Vertex ids of community ``c``."""
    return np.nonzero(np.asarray(x) == c)[0]


def communities(x: np.ndarray) -> np.ndarray:
    """Distinct community ids, sorted."""
    return np.unique(np.asarray(x))


def communities_disconnected(g: CSRGraph, x: np.ndarray,
                             device="cuda") -> np.ndarray:
    """Ids of the communities whose members are not all reachable from the
    smallest one over the community's internal edges (BFS on
    ``device``)."""
    device = resolve_device(device)
    g = g.host()
    x = np.asarray(x, dtype=np.int64)
    src, dst = edge_list(g)
    disconnected = []
    for c in np.unique(x):
        members = np.nonzero(x == c)[0]
        if members.size <= 1:
            continue
        keep = (x[src] == c) & (x[dst] == c)
        if not keep.any():
            disconnected.append(int(c))
            continue
        sub = from_edges(src[keep], dst[keep], n=g.n)
        start = np.zeros(g.n, bool)
        start[members[0]] = True
        levels = bfs_levels(sub, start, device=device)
        if (levels[members] < 0).any():
            disconnected.append(int(c))
    return np.asarray(disconnected, dtype=np.int64)
