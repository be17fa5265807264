"""Graph traversal (counterpart of ``linkpred_tpu/ops/traverse.py``).

``bfs_levels`` runs on the device as a level-synchronous loop over the
edge list: each level marks the targets of the frontier's edges and keeps
those not reached before; the host reads one flag a level (whether the next
frontier is empty), so the loop runs as many times as the graph is deep.
``bfs_visited`` (with the reference's filter and visit callbacks) and DFS
are sequential and stay host code.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..graph import CSRGraph, edge_list
from ..utils.device import resolve_device

__all__ = ["bfs_levels", "bfs_visited", "dfs_order", "dfs_visited"]


def _bfs_device(esrc: torch.Tensor, edst: torch.Tensor,
                start_mask: torch.Tensor) -> torch.Tensor:
    """Level-synchronous BFS over int64 edge lists on their device.
    Returns int32 levels (-1 = unreached)."""
    levels = torch.where(start_mask, 0, -1).to(torch.int32)
    frontier, depth = start_mask, 0
    while bool(frontier.any()):
        on = frontier[esrc]
        reached = torch.zeros_like(start_mask)
        reached[edst[on]] = True
        frontier = reached & (levels < 0)
        depth += 1
        levels = torch.where(frontier, depth, levels)
    return levels


def bfs_levels(g: CSRGraph, start, n: Optional[int] = None,
               device="cuda") -> np.ndarray:
    """BFS levels from ``start`` (a vertex id or a boolean mask over the
    vertices), computed on ``device``; -1 = unreached.  ``n`` is accepted
    for the reference's signature; the graph's own order is used."""
    device = resolve_device(device)
    g = g.host()
    esrc, edst = edge_list(g)
    if np.isscalar(start) or getattr(start, "ndim", 1) == 0:
        mask = np.zeros(g.n, bool)
        mask[int(start)] = True
    else:
        mask = np.asarray(start, bool)
    levels = _bfs_device(torch.as_tensor(esrc, device=device),
                         torch.as_tensor(edst, device=device),
                         torch.as_tensor(mask, device=device))
    return levels.cpu().numpy()


def bfs_visited(g: CSRGraph, start, visited: Optional[np.ndarray] = None,
                ft: Optional[Callable] = None,
                fp: Optional[Callable] = None) -> np.ndarray:
    """Mark the vertices reachable from ``start``: a vertex ``v`` at depth
    ``d`` is visited only if ``ft(v, d)`` (when given) is true, and
    ``fp(v, d)`` is called on each visit.  Host code (the callbacks are
    Python); :func:`bfs_levels` is the device path."""
    g = g.host()
    offsets = np.asarray(g.offsets)
    indices = np.asarray(g.indices)
    vis = np.zeros(g.n, bool) if visited is None else visited
    frontier = [int(start)]
    vis[int(start)] = True
    if fp is not None:
        fp(int(start), 0)
    depth = 1
    while frontier:
        nxt = []
        for u in frontier:
            for v in indices[offsets[u]: offsets[u + 1]]:
                v = int(v)
                if vis[v] or (ft is not None and not ft(v, depth)):
                    continue
                vis[v] = True
                if fp is not None:
                    fp(v, depth)
                nxt.append(v)
        frontier = nxt
        depth += 1
    return vis


def dfs_order(g: CSRGraph, start: int) -> np.ndarray:
    """Preorder DFS from ``start``, smallest neighbour first (host, with an
    explicit stack)."""
    g = g.host()
    offsets = np.asarray(g.offsets)
    indices = np.asarray(g.indices)
    visited = np.zeros(g.n, bool)
    order = []
    stack = [int(start)]
    while stack:
        u = stack.pop()
        if visited[u]:
            continue
        visited[u] = True
        order.append(u)
        # pushed in reverse, so the smallest neighbour is visited first
        stack.extend(int(v) for v in indices[offsets[u]: offsets[u + 1]][::-1])
    return np.asarray(order, dtype=np.int64)


def dfs_visited(g: CSRGraph, start: int,
                visited: Optional[np.ndarray] = None) -> np.ndarray:
    """Mark the vertices reachable from ``start`` in DFS order."""
    g = g.host()
    vis = np.zeros(g.n, bool) if visited is None else visited
    for u in dfs_order(g, start):
        vis[u] = True
    return vis
