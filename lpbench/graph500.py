"""The Graph500 Kronecker (R-MAT) graph and the edge-removal protocol, in
plain torch on the device, from one seed.

The generator is the arithmetic of ``linkpred_tpu_torch/bench/synth.py``'s
``rmat_graph`` (one uniform draw a level picks the quadrant) with the
Graph500 label permutation added; the removal is the arithmetic of
``linkpred_tpu_torch/ops/batch.py`` (a uniform vertex, retried up to five
times while it has no edge, then a uniform incident edge, both directions,
duplicates dropped).  Both are copied here so that a change to the program
cannot move the yardstick.  One ``torch.Generator`` on the device draws
everything, so one seed gives one graph on one kind of device.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["Graph", "make_graph", "rmat_edges", "remove_edges"]

# Edge arrays of the program's CSR graph are padded to a multiple of this.
_PAD_ALIGN = 128
_RETRIES = 5


@dataclasses.dataclass
class Graph:
    """A symmetric graph as CSR tensors on one device, rows sorted."""
    offsets: torch.Tensor   # int64[n + 1]
    indices: torch.Tensor   # int64[m]
    n: int

    @property
    def m(self) -> int:
        return int(self.indices.shape[0])

    @property
    def degrees(self) -> torch.Tensor:
        return self.offsets[1:] - self.offsets[:-1]

    def keys(self) -> torch.Tensor:
        """The sorted directed edge keys ``u * n + v``."""
        src = torch.repeat_interleave(
            torch.arange(self.n, device=self.indices.device), self.degrees)
        return src * self.n + self.indices

    def host_csr(self):
        """``(offsets int32[n+1], indices int32[m_pad], degrees int32[n])``
        as NumPy arrays, in the program's layout (indices padded with n)."""
        m_pad = max(_PAD_ALIGN, -(-self.m // _PAD_ALIGN) * _PAD_ALIGN)
        ind = torch.full((m_pad,), self.n, dtype=torch.int32,
                         device=self.indices.device)
        ind[: self.m] = self.indices.to(torch.int32)
        return (self.offsets.to(torch.int32).cpu().numpy(),
                ind.cpu().numpy(),
                self.degrees.to(torch.int32).cpu().numpy())


def _from_keys(keys: torch.Tensor, n: int) -> Graph:
    """CSR of the sorted, distinct directed edge keys ``u * n + v``."""
    src = keys // n
    deg = torch.bincount(src, minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    offsets[1:] = torch.cumsum(deg, 0)
    return Graph(offsets=offsets, indices=keys - src * n, n=n)


def rmat_edges(scale: int, edge_factor: int, a: float, b: float, c: float,
               gen: torch.Generator, permute: bool = True) -> Graph:
    """R-MAT with ``2**scale`` vertices and ``edge_factor * 2**scale`` drawn
    edges; labels permuted at random (Graph500), made symmetric, with
    self-loops and duplicates removed."""
    device = gen.device
    n = 1 << scale
    m = n * edge_factor
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    ab, abc = a + b, a + b + c
    for _ in range(scale):
        r = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        # quadrants c, d set the source's bit; b, d the target's
        src = (src << 1) | (r >= ab).to(torch.int64)
        dst = (dst << 1) | (((r >= a) & (r < ab))
                            | (r >= abc)).to(torch.int64)
        del r
    if permute:
        perm = torch.randperm(n, generator=gen, device=device)
        src, dst = perm[src], perm[dst]
        del perm
    keep = src != dst
    src, dst = src[keep], dst[keep]
    keys = torch.cat([src * n + dst, dst * n + src])
    del src, dst, keep
    return _from_keys(torch.unique(keys), n)


def remove_edges(g: Graph, fraction: float, gen: torch.Generator):
    """Remove ``int(fraction * m / 2)`` picks of undirected edges: a uniform
    vertex (retried up to five times while it has no edge), then a uniform
    edge of it, both directions, duplicates dropped.  Returns (the graph
    after removal, the removed directed keys, sorted)."""
    device = g.indices.device
    deg = g.degrees
    need = int(fraction * g.m / 2)
    picked = []
    for _ in range(_RETRIES):
        if need <= 0:
            break
        u = torch.randint(0, g.n, (need,), generator=gen, device=device)
        u = u[deg[u] > 0]
        picked.append(u)
        need -= int(u.shape[0])
    u = torch.cat(picked) if picked else torch.empty(0, dtype=torch.int64,
                                                     device=device)
    du = deg[u]
    r = torch.rand(u.shape[0], generator=gen, device=device,
                   dtype=torch.float64)
    vi = torch.minimum((r * du).floor().to(torch.int64), du - 1)
    v = g.indices[g.offsets[u] + vi]
    removed = torch.unique(torch.cat([u * g.n + v, v * g.n + u]))
    keys = g.keys()
    kept = keys[~torch.isin(keys, removed)]
    return _from_keys(kept, g.n), removed


def make_graph(cfg: dict, seed: int, device) -> tuple[Graph, int]:
    """The configuration's graph after removal, and k: the number of
    undirected edges removed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    g = rmat_edges(cfg["scale"], cfg["edge_factor"], cfg["a"], cfg["b"],
                   cfg["c"], gen, permute=cfg.get("permute", True))
    y, removed = remove_edges(g, cfg["removed_fraction"], gen)
    return y, max(int(removed.shape[0]) // 2, 1)
