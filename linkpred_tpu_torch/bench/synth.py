"""Synthetic graphs (counterpart of ``linkpred_tpu/bench/synth.py``).

The host RNG is a seeded ``np.random.Generator``, as in the reference, so one
seed gives the reference's graph bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..graph import CSRGraph, from_edges
from ..ops.transform import remove_self_loops, symmetrize

__all__ = ["rmat_graph", "planted_partition_graph"]


def rmat_graph(
    scale: int,
    edge_factor: int = 16,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 42,
    symmetric: bool = True,
) -> CSRGraph:
    """R-MAT graph with 2**scale vertices and ~edge_factor * 2**scale
    undirected edges (before dedup), symmetrized and self-loop-free."""
    n = 1 << scale
    m = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = rng.random(m)
        src_bit = r >= ab                             # quadrants c, d
        dst_bit = (r >= a) & (r < ab) | (r >= abc)    # quadrants b, d
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    g = from_edges(src, dst, n=n)
    if symmetric:
        g = symmetrize(g)
    return remove_self_loops(g)


def planted_partition_graph(
    n_communities: int,
    size: int,
    p_in: float = 0.3,
    p_out: float = 0.005,
    seed: int = 42,
) -> CSRGraph:
    """Planted-partition graph: dense communities with sparse cross-links, so
    removed edges are recoverable (a recall check)."""
    rng = np.random.default_rng(seed)
    n = n_communities * size
    blocks = []
    for c in range(n_communities):
        base = c * size
        u, v = np.nonzero(rng.random((size, size)) < p_in)
        blocks.append(np.stack([base + u, base + v], axis=1))
    m_out = int(p_out * n * n)
    if m_out:
        u = rng.integers(0, n, m_out)
        v = rng.integers(0, n, m_out)
        blocks.append(np.stack([u, v], axis=1))
    e = np.concatenate(blocks)
    g = from_edges(e[:, 0], e[:, 1], n=n)
    return remove_self_loops(symmetrize(g))
