"""Graph transforms (counterpart of ``linkpred_tpu/ops/transform.py``):
only the two the main path needs."""
from __future__ import annotations

import numpy as np

from ..graph import CSRGraph, edge_list, from_edges

__all__ = ["symmetrize", "remove_self_loops"]


def symmetrize(g: CSRGraph) -> CSRGraph:
    """Union of the graph and its reverse."""
    src, dst = edge_list(g)
    return from_edges(
        np.concatenate([src, dst]), np.concatenate([dst, src]), n=g.n,
        weights=None if g.weights is None else np.concatenate(
            [np.asarray(g.host().weights[: g.m])] * 2),
    )


def remove_self_loops(g: CSRGraph) -> CSRGraph:
    """Drop u→u edges."""
    src, dst = edge_list(g)
    keep = src != dst
    w = None if g.weights is None else np.asarray(g.host().weights[: g.m])[keep]
    return from_edges(src[keep], dst[keep], n=g.n, weights=w)
