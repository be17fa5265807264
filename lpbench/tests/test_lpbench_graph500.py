"""The Graph500 generator and the removal protocol, on the CPU."""
import pytest
import torch

from lpbench import graph500


def _gen(seed):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("scale", [6, 9])
def test_rmat_is_symmetric_simple_and_sized(scale):
    g = graph500.rmat_edges(scale, 16, 0.57, 0.19, 0.19, _gen(3))
    assert g.n == 1 << scale
    assert g.offsets.shape == (g.n + 1,) and int(g.offsets[-1]) == g.m
    keys = g.keys()
    assert torch.all(keys[1:] > keys[:-1])               # sorted, distinct
    u, v = keys // g.n, keys % g.n
    assert not torch.any(u == v)                          # no self-loops
    assert torch.equal(torch.sort(v * g.n + u).values, keys)   # symmetric
    # the drawn edges, less duplicates and loops, both directions
    assert 0.3 * 2 * g.n * 16 < g.m <= 2 * g.n * 16


def test_permutation_spreads_the_hub():
    plain = graph500.rmat_edges(10, 16, 0.57, 0.19, 0.19, _gen(5),
                                permute=False)
    perm = graph500.rmat_edges(10, 16, 0.57, 0.19, 0.19, _gen(5))
    # R-MAT without a permutation puts its hub at vertex 0
    assert int(torch.argmax(plain.degrees)) == 0
    assert torch.equal(torch.sort(plain.degrees).values,
                       torch.sort(perm.degrees).values)


def test_removed_fraction_and_k():
    g = graph500.rmat_edges(10, 16, 0.57, 0.19, 0.19, _gen(7))
    y, removed = graph500.remove_edges(g, 0.1, _gen(8))
    assert y.m + removed.shape[0] == g.m
    # picks of one undirected edge twice are dropped: a bit under 10%
    assert 0.08 * g.m < removed.shape[0] <= 0.1 * g.m + 2
    assert not torch.any(torch.isin(y.keys(), removed))
    assert torch.all(torch.isin(removed, g.keys()))
    u, v = removed // g.n, removed % g.n
    assert torch.equal(torch.sort(v * g.n + u).values, removed)


def test_same_seed_same_graph_other_seed_other_graph():
    cfg = dict(scale=9, edge_factor=16, a=0.57, b=0.19, c=0.19,
               removed_fraction=0.1)
    a, ka = graph500.make_graph(cfg, 2 ** 31 + 17, "cpu")
    b, kb = graph500.make_graph(cfg, 2 ** 31 + 17, "cpu")
    c, _ = graph500.make_graph(cfg, 2 ** 31 + 18, "cpu")
    assert ka == kb and torch.equal(a.indices, b.indices)
    assert not torch.equal(a.offsets, c.offsets)


def test_host_csr_is_the_programs_layout():
    cfg = dict(scale=7, edge_factor=16, a=0.57, b=0.19, c=0.19,
               removed_fraction=0.1)
    g, _ = graph500.make_graph(cfg, 1, "cpu")
    offsets, indices, degrees = g.host_csr()
    assert indices.shape[0] % 128 == 0 and (indices[g.m:] == g.n).all()
    assert (offsets[1:] - offsets[:-1] == degrees).all()
    assert offsets.dtype == indices.dtype == degrees.dtype
