"""Batch updates (counterpart of ``linkpred_tpu/ops/batch.py``): deletion
and insertion sampling, tidying and applying on the host, and a deletion
sampler on the device."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..graph import CSRGraph, edge_list, from_edges
from ..utils.device import resolve_device

__all__ = ["generate_edge_deletions", "generate_edge_insertions",
           "tidy_batch", "apply_batch", "generate_edge_deletions_device"]

RETRIES = 5


def generate_edge_deletions(
    rng: np.random.Generator, g: CSRGraph, batch_size: int,
    undirected: bool = True,
) -> np.ndarray:
    """Sample ``batch_size`` candidate deletions: a uniform random vertex,
    then a uniform random incident edge; zero-degree picks are retried up to
    5 times.  Returns int64[*, 2] directed pairs (both directions per pick
    when ``undirected``); may hold duplicates."""
    g = g.host()
    deg = np.asarray(g.degrees, dtype=np.int64)
    offsets = np.asarray(g.offsets, dtype=np.int64)
    indices = np.asarray(g.indices, dtype=np.int64)

    picked_u = np.empty(0, dtype=np.int64)
    need = int(batch_size)
    for _ in range(RETRIES):
        if need <= 0:
            break
        u = rng.integers(0, g.n, size=need)
        ok = deg[u] > 0
        picked_u = np.concatenate([picked_u, u[ok]])
        need -= int(ok.sum())
    if picked_u.size == 0:
        return np.empty((0, 2), dtype=np.int64)
    vi = np.floor(rng.random(picked_u.shape[0]) * deg[picked_u]).astype(np.int64)
    vi = np.minimum(vi, deg[picked_u] - 1)
    v = indices[offsets[picked_u] + vi]
    pairs = np.stack([picked_u, v], axis=1)
    if undirected:
        pairs = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
    return pairs


def generate_edge_insertions(
    rng: np.random.Generator, g: CSRGraph, batch_size: int,
    undirected: bool = True,
) -> np.ndarray:
    """Sample ``batch_size`` uniform random vertex pairs as candidate
    insertions: int64[*, 2], both directions per pick when ``undirected``.
    Draws nothing from ``rng`` when ``batch_size <= 0`` or the graph is
    empty, so a sweep without insertions leaves the generator as it was."""
    if batch_size <= 0 or g.n == 0:
        return np.empty((0, 2), dtype=np.int64)
    u = rng.integers(0, g.n, size=batch_size)
    v = rng.integers(0, g.n, size=batch_size)
    pairs = np.stack([u, v], axis=1)
    if undirected:
        pairs = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
    return pairs


def _edge_exists(g: CSRGraph, pairs: np.ndarray) -> np.ndarray:
    """Vectorized membership test of directed pairs against sorted rows."""
    if pairs.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    g = g.host()
    offsets = np.asarray(g.offsets, dtype=np.int64)
    indices = np.asarray(g.indices, dtype=np.int64)
    u, v = pairs[:, 0], pairs[:, 1]
    lo, hi = offsets[u], offsets[u + 1]
    length = hi - lo
    while True:
        mx = int(length.max(initial=0))
        if mx <= 0:
            break
        half = length // 2
        midpos = lo + half
        go = indices[np.minimum(midpos, indices.shape[0] - 1)] < v
        go &= length > 0
        lo = np.where(go, midpos + 1, lo)
        length = np.where(go, length - half - 1, half)
        if mx == 1:
            break
    return (lo < hi) & (indices[np.minimum(lo, indices.shape[0] - 1)] == v)


def tidy_batch(
    deletions: np.ndarray, insertions: np.ndarray, g: CSRGraph,
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep deletions of existing edges and insertions of absent ones, sorted
    by (u, v) and deduplicated."""

    def _tidy(pairs: np.ndarray, keep_existing: bool) -> np.ndarray:
        if pairs.shape[0] == 0:
            return pairs.reshape(0, 2)
        mask = _edge_exists(g, pairs)
        pairs = pairs[mask if keep_existing else ~mask]
        if pairs.shape[0] == 0:
            return pairs
        order = np.lexsort((pairs[:, 1], pairs[:, 0]))
        pairs = pairs[order]
        keep = np.empty(pairs.shape[0], dtype=bool)
        keep[0] = True
        keep[1:] = (pairs[1:] != pairs[:-1]).any(axis=1)
        return pairs[keep]

    return _tidy(deletions, True), _tidy(insertions, False)


def apply_batch(
    g: CSRGraph, deletions: np.ndarray, insertions: np.ndarray,
    insertion_weights: Optional[np.ndarray] = None,
) -> CSRGraph:
    """Remove the deletions, then add the insertions; returns a new graph.
    Surviving edges keep their weights; insertions take
    ``insertion_weights`` (default 1.0)."""
    src, dst, w = edge_list(g, with_weights=True)
    if deletions.shape[0]:
        keys = src * g.n + dst
        dkeys = deletions[:, 0] * g.n + deletions[:, 1]
        keep = ~np.isin(keys, dkeys)
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
    if insertions.shape[0]:
        # an unweighted base stays unweighted when every insertion weight is
        # the default 1.0
        if insertion_weights is not None and w is None \
                and not np.any(np.asarray(insertion_weights) != 1.0):
            insertion_weights = None
        if w is not None or insertion_weights is not None:
            base_w = w if w is not None \
                else np.ones(src.shape[0], dtype=np.float32)
            ins_w = (np.asarray(insertion_weights, dtype=np.float32)
                     if insertion_weights is not None
                     else np.ones(insertions.shape[0], dtype=np.float32))
            w = np.concatenate([base_w, ins_w])
        src = np.concatenate([src, insertions[:, 0]])
        dst = np.concatenate([dst, insertions[:, 1]])
    return from_edges(src, dst, n=g.n, weights=w)


def generate_edge_deletions_device(
    generator: torch.Generator, g: CSRGraph, batch_size: int, device="cuda",
):
    """Deletion sampling on ``device`` in one pass without retries: a
    uniform vertex ``u``, then a uniform edge of ``u``; picks of degree 0
    are flagged invalid.  ``generator`` is a ``torch.Generator`` on that
    device.  Returns ``(pairs int32[batch, 2], valid bool[batch])``; a
    valid pair is an edge of ``g``."""
    device = resolve_device(device)
    gd = g.to(device)
    u = torch.randint(0, max(g.n, 1), (batch_size,), generator=generator,
                      device=device)
    d = gd.degrees[u]
    r = torch.rand(batch_size, generator=generator, device=device)
    # r * d in float32 can round up to d: clamp to the last edge
    vi = torch.minimum((r * d).to(torch.int32), (d - 1).clamp(min=0))
    v = gd.indices[(gd.offsets[u] + vi).to(torch.int64)]
    return torch.stack([u.to(torch.int32), v], dim=1), d > 0
