"""CSR graph container (counterpart of ``linkpred_tpu/graph.py``).

A plain frozen dataclass with NumPy leaves:

* ``offsets`` — ``int32[n + 1]`` row starts into ``indices``
* ``indices`` — ``int32[m_pad]`` neighbour ids, sorted ascending within each
  row, padded with the sentinel ``n``
* ``degrees`` — ``int32[n]`` row lengths
* ``weights`` — optional ``float32[m_pad]`` edge values
* ``values``  — optional ``[n]`` per-vertex values

Graph construction is host work and stays NumPy (``from_edges``,
``from_dense``, the deferred-mutation ``GraphBuilder``); ``to(device)`` gives
a copy whose leaves are torch tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["CSRGraph", "GraphBuilder", "from_edges", "from_dense", "to_dense",
           "edge_list", "PAD_ALIGN"]

# Edge arrays are padded to a multiple of this length.
PAD_ALIGN = 128


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Immutable CSR graph.  Leaves are NumPy arrays (host) or torch tensors
    (after :meth:`to`)."""

    offsets: Any           # int32[n + 1]
    indices: Any           # int32[m_pad], row-sorted, padded with ``n``
    degrees: Any           # int32[n]
    weights: Optional[Any]  # float32[m_pad] or None
    n: int
    m: int
    values: Optional[Any] = None  # per-vertex values [n] or None

    @property
    def span(self) -> int:
        return self.n

    @property
    def order(self) -> int:
        return self.n

    @property
    def size(self) -> int:
        """Number of directed edges."""
        return self.m

    @property
    def m_pad(self) -> int:
        return int(self.indices.shape[0])

    def degree(self, u: int) -> int:
        return int(self.degrees[u])

    def neighbors(self, u: int) -> np.ndarray:
        """Sorted neighbour ids of ``u``."""
        h = self.host()
        return h.indices[h.offsets[u]: h.offsets[u + 1]]

    def has_edge(self, u: int, v: int) -> bool:
        nbrs = self.neighbors(u)
        j = np.searchsorted(nbrs, v)
        return bool(j < nbrs.shape[0] and nbrs[j] == v)

    def vertex_value(self, u: int):
        return None if self.values is None else self.values[u]

    def with_vertex_values(self, values) -> "CSRGraph":
        if values is not None:
            values = np.asarray(values)
            if values.shape[0] != self.n:
                raise ValueError(
                    f"values length {values.shape[0]} != n={self.n}")
        return dataclasses.replace(self, values=values)

    def to(self, device) -> "CSRGraph":
        """Copy whose array leaves are torch tensors on ``device``."""
        def t(a):
            return None if a is None else torch.as_tensor(
                _np(a), device=device)

        return CSRGraph(offsets=t(self.offsets), indices=t(self.indices),
                        degrees=t(self.degrees), weights=t(self.weights),
                        n=self.n, m=self.m, values=t(self.values))

    def host(self) -> "CSRGraph":
        """Copy whose array leaves are NumPy arrays."""
        def h(a):
            return None if a is None else _np(a)

        return CSRGraph(offsets=h(self.offsets), indices=h(self.indices),
                        degrees=h(self.degrees), weights=h(self.weights),
                        n=self.n, m=self.m, values=h(self.values))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"CSRGraph(n={self.n}, m={self.m}, m_pad={self.m_pad})"


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pad_len(m: int) -> int:
    return max(PAD_ALIGN, ((m + PAD_ALIGN - 1) // PAD_ALIGN) * PAD_ALIGN)


def from_edges(
    src: np.ndarray,
    dst: np.ndarray,
    n: Optional[int] = None,
    weights: Optional[np.ndarray] = None,
    dedup: bool = True,
    vertex_values: Optional[np.ndarray] = None,
) -> CSRGraph:
    """Build a CSR graph from directed edge arrays (one lexsort).  Duplicate
    edges keep the LAST-seen weight, as the reference does."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError("src/dst length mismatch")
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
    n = int(n)
    if src.size and (src.min(initial=0) < 0
                     or int(max(src.max(initial=0), dst.max(initial=0))) >= n):
        raise ValueError("vertex id out of range")

    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    w = None if weights is None else np.asarray(weights, dtype=np.float32)[order]
    if dedup and src.size:
        # keep the last duplicate (lexsort is stable)
        keep = np.empty(src.shape[0], dtype=bool)
        keep[-1] = True
        np.logical_or(src[1:] != src[:-1], dst[1:] != dst[:-1], out=keep[:-1])
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]

    m = int(src.shape[0])
    degrees = np.bincount(src, minlength=n).astype(np.int32)
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(degrees, out=offsets[1:])

    mp = _pad_len(m)
    indices = np.full(mp, n, dtype=np.int32)
    indices[:m] = dst
    wpad = None
    if w is not None:
        wpad = np.zeros(mp, dtype=np.float32)
        wpad[:m] = w
    vv = None
    if vertex_values is not None:
        vv = np.asarray(vertex_values)
        if vv.shape[0] != n:
            raise ValueError(f"vertex_values length {vv.shape[0]} != n={n}")
    return CSRGraph(offsets=offsets, indices=indices, degrees=degrees,
                    weights=wpad, n=n, m=m, values=vv)


def edge_list(g: CSRGraph, with_weights: bool = False):
    """Directed (src, dst) int64 arrays; with ``with_weights`` a third element
    carries the float32 edge values (None if unweighted)."""
    g = g.host()
    src = np.repeat(np.arange(g.n, dtype=np.int64),
                    np.asarray(g.degrees, dtype=np.int64))
    dst = np.asarray(g.indices[: g.m], dtype=np.int64)
    if with_weights:
        w = (None if g.weights is None
             else np.asarray(g.weights[: g.m], dtype=np.float32))
        return src, dst, w
    return src, dst


def from_dense(a: np.ndarray) -> CSRGraph:
    """Build from a dense boolean adjacency matrix (small graphs)."""
    src, dst = np.nonzero(np.asarray(a))
    return from_edges(src, dst, n=a.shape[0])


def to_dense(g: CSRGraph) -> np.ndarray:
    """Dense boolean adjacency (small graphs)."""
    g = g.host()
    a = np.zeros((g.n, g.n), dtype=bool)
    src, dst = edge_list(g)
    a[src, dst] = True
    return a


class GraphBuilder:
    """Deferred mutations, the reference's ``addEdge``/``removeEdge`` then
    ``update()`` workflow: ``update`` is one rebuild into a new
    :class:`CSRGraph`, last operation wins per directed pair."""

    def __init__(self, base: Optional[CSRGraph] = None,
                 n: Optional[int] = None):
        self._base = base
        self._n = n if n is not None else (base.n if base is not None else 0)
        self._add: list[tuple[int, int, float]] = []
        self._rem: list[tuple[int, int]] = []

    def add_edge(self, u: int, v: int, w: float = 1.0) -> "GraphBuilder":
        self._n = max(self._n, int(u) + 1, int(v) + 1)
        self._add.append((int(u), int(v), float(w)))
        return self

    def remove_edge(self, u: int, v: int) -> "GraphBuilder":
        self._rem.append((int(u), int(v)))
        return self

    def respan(self, n: int) -> "GraphBuilder":
        """Grow the vertex range to at least ``n``."""
        self._n = max(self._n, int(n))
        return self

    def update(self) -> CSRGraph:
        """Commit the pending operations: removals first, then additions,
        the last addition of a pair giving its weight.  The result is
        weighted iff the base was or an addition carries a weight other
        than 1; vertex values are kept, a respan extends them with 0."""
        if self._base is not None:
            src, dst, w = edge_list(self._base, with_weights=True)
        else:
            src = np.empty(0, dtype=np.int64)
            dst = np.empty(0, dtype=np.int64)
            w = None
        if self._rem:
            rem = np.asarray(self._rem, dtype=np.int64).reshape(-1, 2)
            hi = max(self._n, 1)
            keep = ~np.isin(src * hi + dst, rem[:, 0] * hi + rem[:, 1])
            src, dst = src[keep], dst[keep]
            if w is not None:
                w = w[keep]
        if self._add:
            add = np.asarray([(u, v) for u, v, _ in self._add],
                             dtype=np.int64)
            addw = np.asarray([x for _, _, x in self._add], dtype=np.float32)
            if w is not None or bool(np.any(addw != 1.0)):
                base_w = w if w is not None \
                    else np.ones(src.shape[0], dtype=np.float32)
                w = np.concatenate([base_w, addw])
            src = np.concatenate([src, add[:, 0]])
            dst = np.concatenate([dst, add[:, 1]])
        vv = None
        if self._base is not None and self._base.values is not None:
            old = _np(self._base.values)
            if old.shape[0] < self._n:
                vv = np.zeros(self._n, dtype=old.dtype)
                vv[: old.shape[0]] = old
            else:
                vv = old
        g = from_edges(src, dst, n=self._n, weights=w, vertex_values=vv)
        self._base, self._add, self._rem = g, [], []
        return g
