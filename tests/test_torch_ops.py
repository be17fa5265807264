"""The port's host layer and small device helpers against ``linkpred_tpu``'s
on the same seeded NumPy inputs (JAX on the CPU; the port's device
functions with ``device="cpu"`` or CPU tensors): BFS and DFS, graph
properties and modularity, set operations, scans, norms and vector helpers,
the top-k merge helpers, xorshift32, the prime helpers, the build modes,
and the device deletion sampler's contract.  Mirrors the cases of
``tests/test_ops.py``.

Tolerances: host NumPy code is compared exactly (modularity is the same
float64 arithmetic); float32 scans and norms within rtol 1e-6; integer
results, xorshift and top-k scores exactly; top-k (u, v) exactly where the
tie rule is the reference's (``lax.top_k``: the lower lane first) and as
sets among the k-th score's ties where it is not (``topk_merge``'s unstable
sort)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_graph

import linkpred_tpu as lp
from linkpred_tpu.ops import properties as ref_props
from linkpred_tpu.ops import scan as ref_scan
from linkpred_tpu.ops import setops as ref_setops
from linkpred_tpu.ops import topk as ref_topk
from linkpred_tpu.ops import traverse as ref_traverse
from linkpred_tpu.ops import vector as ref_vector
from linkpred_tpu.utils import debug as ref_debug
from linkpred_tpu.utils import numeric as ref_numeric
from linkpred_tpu.utils import random as ref_random

import linkpred_tpu_torch as lt
from linkpred_tpu_torch.ops import batch, properties, scan, setops, topk
from linkpred_tpu_torch.ops import traverse, vector
from linkpred_tpu_torch.utils import debug, numeric
from linkpred_tpu_torch.utils import random as lt_random


def _port(g):
    """The reference's host graph as the port's (the same arrays)."""
    g = g.host()
    return lt.from_edges(*lp.edge_list(g), n=g.n,
                         weights=None if g.weights is None
                         else np.asarray(g.weights[: g.m]))


def _path(k):
    src = np.arange(k - 1)
    return lp.from_edges(np.concatenate([src, src + 1]),
                         np.concatenate([src + 1, src]), n=k)


def _graphs(rng):
    """A path, a graph with unreached vertices, a directed chain and two
    random graphs (one sparse enough to have several components)."""
    return {
        "path": _path(9),
        "disconnected": lp.from_edges([0, 1, 5], [1, 0, 6], n=8),
        "directed": lp.from_edges([0, 1, 2, 4], [1, 2, 3, 0], n=6),
        "random": random_graph(rng, 120, 3),
        "sparse": random_graph(rng, 150, 0.7),
    }


GRAPHS = ["path", "disconnected", "directed", "random", "sparse"]


# ---------------------------------------------------------------- traversal

@pytest.mark.parametrize("name", GRAPHS)
def test_bfs_levels_vs_reference(rng, name):
    gr = _graphs(rng)[name]
    gp = _port(gr)
    for start in (0, gr.n - 1, gr.n // 2):
        got = traverse.bfs_levels(gp, start, device="cpu")
        np.testing.assert_array_equal(got, ref_traverse.bfs_levels(gr, start))
        assert got.dtype == np.int32
    mask = rng.random(gr.n) < 0.1
    np.testing.assert_array_equal(
        traverse.bfs_levels(gp, mask, device="cpu"),
        ref_traverse.bfs_levels(gr, mask))


def test_bfs_levels_by_hand():
    np.testing.assert_array_equal(
        traverse.bfs_levels(_port(_path(6)), 0, device="cpu"), range(6))
    lv = traverse.bfs_levels(lt.from_edges([0, 1], [1, 0], n=4), 0,
                             device="cpu")
    np.testing.assert_array_equal(lv, [0, 1, -1, -1])


@pytest.mark.parametrize("name", GRAPHS)
def test_bfs_visited_and_dfs_vs_reference(rng, name):
    gr = _graphs(rng)[name]
    gp = _port(gr)
    for start in (0, gr.n // 2):
        seen = ([], [])
        ft = lambda v, d: (v + d) % 4 != 0  # noqa: E731
        for mod, g, out in ((traverse, gp, seen[0]),
                            (ref_traverse, gr, seen[1])):
            vis = mod.bfs_visited(g, start, ft=ft,
                                  fp=lambda v, d, o=out: o.append((v, d)))
            out.append(vis.tolist())
        assert seen[0] == seen[1]
        np.testing.assert_array_equal(traverse.bfs_visited(gp, start),
                                      ref_traverse.bfs_visited(gr, start))
        np.testing.assert_array_equal(traverse.dfs_order(gp, start),
                                      ref_traverse.dfs_order(gr, start))
        np.testing.assert_array_equal(traverse.dfs_visited(gp, start),
                                      ref_traverse.dfs_visited(gr, start))


# --------------------------------------------------------------- properties

@pytest.mark.parametrize("weighted", [False, True])
def test_properties_vs_reference(rng, weighted):
    gr = random_graph(rng, 80, 4)
    if weighted:
        src, dst = lp.edge_list(gr)
        w = rng.random(src.shape[0]).astype(np.float32) + 0.25
        gr = lp.from_edges(src, dst, n=gr.n, weights=w)
    gp = _port(gr)
    np.testing.assert_array_equal(properties.vertex_keys(gp),
                                  ref_props.vertex_keys(gr))
    np.testing.assert_array_equal(properties.degrees(gp),
                                  ref_props.degrees(gr))
    assert properties.edge_weight(gp) == ref_props.edge_weight(gr)
    for ncomm in (1, 4, 80):
        x = rng.integers(0, ncomm, gr.n)
        for a, b in zip(properties.modularity_communities(gp, x),
                        ref_props.modularity_communities(gr, x)):
            np.testing.assert_array_equal(a, b)
        for kw in ({}, dict(R=0.5), dict(M=100.0), dict(M=0.0)):
            assert properties.modularity_by(gp, x, **kw) \
                == ref_props.modularity_by(gr, x, **kw)
    assert properties.modularity(gp) == ref_props.modularity(gr)


def test_modularity_two_cliques():
    e = np.array([[0, 1], [1, 2], [0, 2], [3, 4], [4, 5], [3, 5]])
    g = lt.from_edges(np.concatenate([e[:, 0], e[:, 1]]),
                      np.concatenate([e[:, 1], e[:, 0]]), n=6)
    q = properties.modularity_by(g, np.array([0, 0, 0, 1, 1, 1]))
    assert q == pytest.approx(0.5, abs=1e-9)
    assert properties.modularity(g) < q


def test_community_helpers_vs_reference(rng):
    x = rng.integers(0, 7, 50)
    np.testing.assert_array_equal(properties.communities(x),
                                  ref_props.communities(x))
    for c in range(8):
        assert properties.community_size(x, c) \
            == ref_props.community_size(x, c)
        np.testing.assert_array_equal(properties.community_vertices(x, c),
                                      ref_props.community_vertices(x, c))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_communities_disconnected_vs_reference(seed):
    """Planted communities whose internal edges are sparse enough that
    some split, singletons and a community without internal edges."""
    rng = np.random.default_rng(seed)
    n = 90
    x = np.sort(rng.integers(0, 12, n))
    x[-1] = 12                                  # a singleton
    src, dst = rng.integers(0, n, 150), rng.integers(0, n, 150)
    keep = x[src] == x[dst]
    src, dst = np.concatenate([src[keep], [0, n - 3]]), \
        np.concatenate([dst[keep], [n - 3, 0]])
    gr = lp.from_edges(np.concatenate([src, dst]),
                       np.concatenate([dst, src]), n=n)
    got = properties.communities_disconnected(_port(gr), x, device="cpu")
    want = ref_props.communities_disconnected(gr, x)
    np.testing.assert_array_equal(got, want)
    assert got.size > 0


# ----------------------------------------------------------------- set ops

def _sorted_keys(rng, size, hi, unique):
    k = np.sort(rng.integers(0, hi, size))
    return np.unique(k) if unique else k


@pytest.mark.parametrize("size_a,size_b", [(0, 0), (0, 7), (9, 0), (40, 25),
                                           (200, 300)])
def test_setops_vs_reference(rng, size_a, size_b):
    a = _sorted_keys(rng, size_a, 60, True)
    b = _sorted_keys(rng, size_b, 60, True)
    av = rng.integers(0, 1000, a.shape[0])
    bv = rng.integers(0, 1000, b.shape[0])
    for got, want in (
            (setops.set_union_last(a, b), ref_setops.set_union_last(a, b)),
            (setops.set_union_last(a, b, av, bv),
             ref_setops.set_union_last(a, b, av, bv)),
            (setops.set_difference(a, b), ref_setops.set_difference(a, b)),
            (setops.set_difference(a, b, av),
             ref_setops.set_difference(a, b, av)),
            (setops.set_intersection(a, b),
             ref_setops.set_intersection(a, b))):
        for g, w in zip(*(x if isinstance(x, tuple) else (x,)
                          for x in (got, want))):
            np.testing.assert_array_equal(g, w)
    dup = _sorted_keys(rng, size_a, 20, False)
    dv = rng.integers(0, 1000, dup.shape[0])
    np.testing.assert_array_equal(setops.unique_last(dup),
                                  ref_setops.unique_last(dup))
    for g, w in zip(setops.unique_last(dup, dv),
                    ref_setops.unique_last(dup, dv)):
        np.testing.assert_array_equal(g, w)
    assert setops.non_adjacent_find(dup) == ref_setops.non_adjacent_find(dup)
    near = lambda p, q: abs(int(p) - int(q)) <= 1  # noqa: E731
    assert setops.non_adjacent_find(dup, near) \
        == ref_setops.non_adjacent_find(dup, near)


def test_setops_by_hand():
    k, v = setops.set_union_last([1, 3, 5], [3, 4], [10, 30, 50], [33, 44])
    assert k.tolist() == [1, 3, 4, 5] and v.tolist() == [10, 33, 44, 50]
    k, v = setops.unique_last([1, 1, 2, 3, 3], [9, 8, 7, 6, 5])
    assert k.tolist() == [1, 2, 3] and v.tolist() == [8, 7, 5]
    assert [setops.non_adjacent_find(x) for x in ([5, 5, 5], [5, 5, 7], [1])] \
        == [3, 1, 1]


# ------------------------------------------------------ scans and vectors

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("shape,axis", [((1,), -1), ((1000,), -1),
                                        ((7, 33), 0), ((7, 33), -1)])
def test_scans_and_norms_vs_reference(rng, dtype, shape, axis):
    x = (rng.integers(-50, 50, shape) if dtype == np.int32
         else rng.standard_normal(shape)).astype(dtype)
    y = (x[::-1] * 2).copy()
    tx, ty, jx, jy = torch.as_tensor(x), torch.as_tensor(y), \
        jnp.asarray(x), jnp.asarray(y)

    def same(got, want):
        got, want = got.numpy(), np.asarray(want)
        if dtype == np.int32:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    for name in ("inclusive_scan", "exclusive_scan"):
        got = getattr(scan, name)(tx, axis)
        assert got.dtype == tx.dtype
        same(got, getattr(ref_scan, name)(jx, axis))
    for name in ("sum_values", "l1_norm", "li_norm"):
        same(getattr(scan, name)(tx), getattr(ref_scan, name)(jx))
    v = x.reshape(-1)[0]
    same(scan.count_value(tx, v), ref_scan.count_value(jx, v))
    for name in ("l1_norm_delta", "li_norm_delta"):
        same(getattr(scan, name)(tx, ty), getattr(ref_scan, name)(jx, jy))
    if dtype == np.float32:
        same(scan.l2_norm(tx), ref_scan.l2_norm(jx))
        same(scan.l2_norm_delta(tx, ty), ref_scan.l2_norm_delta(jx, jy))


@pytest.mark.parametrize("dtype", [np.int32, np.bool_, np.uint8])
@pytest.mark.parametrize("n,m", [(1, 1), (10, 0), (2000, 3000)])
def test_scatter_or_duplicates_vs_reference(rng, dtype, n, m):
    """Duplicate ids OR every writer's bits in, values past 2^31
    included."""
    def values(size):
        if dtype == np.bool_:
            return rng.random(size) < 0.3
        if dtype == np.uint8:
            return rng.integers(0, 256, size).astype(np.uint8)
        return rng.integers(-2 ** 31, 2 ** 31, size).astype(np.int32)

    a, x = values(n), values(m)
    ids = rng.integers(0, n, m).astype(np.int32)
    got = vector.scatter_or(torch.as_tensor(a), torch.as_tensor(ids),
                            torch.as_tensor(x))
    want = ref_vector.scatter_or(jnp.asarray(a), jnp.asarray(ids),
                                 jnp.asarray(x))
    assert got.dtype == torch.as_tensor(a).dtype
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [5, 200])
def test_vector_ops_vs_reference(rng, n):
    """Every helper of ``ops/vector.py``; those that keep an arbitrary
    writer of a duplicate id get unique ids, the accumulating ones get
    duplicates."""
    x = rng.integers(-100, 100, n).astype(np.int32)
    y = rng.integers(-3, 4, n).astype(np.int32)
    uniq = rng.permutation(n)[: n // 2 + 1].astype(np.int32)
    dup = rng.integers(0, n, 2 * n).astype(np.int32)
    vals = rng.integers(-9, 9, uniq.shape[0]).astype(np.int32)
    perm = rng.permutation(n).astype(np.int32)
    t, j = torch.as_tensor, jnp.asarray
    cases = [
        ("gather_values", (x, dup)), ("scatter_values", (x, uniq, vals)),
        ("value_indices", (perm, n)), ("fill_value", (x, 5)),
        ("fill_value", (x, 5, dup)), ("add_value", (x, 3)),
        ("add_value", (x, 3, dup)), ("copy_values", (x,)),
        ("copy_values", (x, uniq)), ("multiply_value", (x, 2)),
        ("multiply_value", (x, -2, dup)), ("multiply_values", (x, y))]
    for name, args in cases:
        got = getattr(vector, name)(*(t(a) if isinstance(a, np.ndarray)
                                      else a for a in args))
        want = getattr(ref_vector, name)(*(j(a) if isinstance(a, np.ndarray)
                                           else a for a in args))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    f = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(
        vector.multiply_value(t(f), 1.5, t(dup)).numpy(),
        np.asarray(ref_vector.multiply_value(j(f), 1.5, j(dup))), rtol=1e-6)


# ------------------------------------------------------------------- top k

def _candidates(rng, size, ties):
    """Scores with -inf lanes and, with ``ties``, few distinct values."""
    s = (rng.integers(0, 6, size) / 4 if ties
         else rng.standard_normal(size)).astype(np.float32)
    s[rng.random(size) < 0.2] = -np.inf
    u = rng.integers(0, 1000, size).astype(np.int32)
    v = rng.integers(0, 1000, size).astype(np.int32)
    return s, u, v


@pytest.mark.parametrize("size,k", [(1, 1), (50, 10), (50, 50), (30, 64),
                                    (4096, 500)])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_from_candidates_vs_reference(rng, size, k, ties):
    s, u, v = _candidates(rng, size, ties)
    got = topk.topk_from_candidates(*map(torch.as_tensor, (s, u, v)), k)
    want = ref_topk.topk_from_candidates(*map(jnp.asarray, (s, u, v)), k)
    for a, b in zip(got, want):
        assert a.shape == (k,) and a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _assert_same_up_to_kth_ties(got, want):
    gs, ws = got.scores.numpy(), np.asarray(want.scores)
    np.testing.assert_array_equal(gs, ws)
    kth = ws[-1]
    above = ws > kth
    pairs = lambda t, m: sorted(zip(np.asarray(t.u)[m].tolist(),  # noqa
                                    np.asarray(t.v)[m].tolist()))
    assert pairs(got, above) == pairs(want, above)
    at = ws == kth
    assert at.sum() == (gs == kth).sum()


@pytest.mark.parametrize("k", [1, 16, 300])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_merge_vs_reference(rng, k, ties):
    bufs = []
    for _ in range(2):
        s, u, v = _candidates(rng, 3 * k, ties)
        bufs.append((topk.topk_from_candidates(
            *map(torch.as_tensor, (s, u, v)), k),
            ref_topk.topk_from_candidates(*map(jnp.asarray, (s, u, v)), k)))
    got = topk.topk_merge(bufs[0][0], bufs[1][0])
    want = ref_topk.topk_merge(bufs[0][1], bufs[1][1])
    _assert_same_up_to_kth_ties(got, want)
    empty = topk.topk_merge(topk.topk_init(k, device="cpu"), bufs[0][0])
    for a, b in zip(empty, bufs[0][0]):
        np.testing.assert_array_equal(a.numpy()[np.isfinite(
            empty.scores.numpy())], b.numpy()[np.isfinite(
                bufs[0][0].scores.numpy())])


def test_topk_init_vs_reference():
    for a, b in zip(topk.topk_init(7, device="cpu"), ref_topk.topk_init(7)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------- xorshift

def _states():
    """2^16 states across the whole uint32 range (the top bit set in half
    of them), with 1, 2^31 and 2^32 - 1 among them."""
    rng = np.random.default_rng(5)
    s = rng.integers(1, 2 ** 32, 2 ** 16, dtype=np.uint64).astype(np.uint32)
    s[:3] = [1, 2 ** 31, 2 ** 32 - 1]
    return s


def test_xorshift32_host_vs_reference():
    for seed in [0, 1, 2, 2 ** 31, 2 ** 32 - 1, 123456789]:
        a, b = lt_random.Xorshift32(seed), ref_random.Xorshift32(seed)
        assert [a() for _ in range(200)] == [b() for _ in range(200)]
    r = lt_random.Xorshift32(1)
    assert (r(), r()) == (270369, 67634689)
    big = [lt_random.Xorshift32(int(s))() for s in _states()[:2048]]
    assert big == [ref_random.Xorshift32(int(s))()
                   for s in _states()[:2048]]


@pytest.mark.parametrize("as_tensor", [np.int64, np.int32, None])
def test_xorshift32_device_step_vs_reference(as_tensor):
    """Three steps of 2^16 lanes bit for bit, from int64 tensors, from
    int32 tensors holding the same bits (the top bit as the sign), and
    from an array put on the device."""
    s = _states()
    x = (s if as_tensor is None
         else torch.as_tensor(s.astype(np.int64).astype(as_tensor)))
    want = jnp.asarray(s)
    for _ in range(3):
        x = lt_random.xorshift32_step(x, device="cpu")
        want = ref_random.xorshift32_step(want)
        assert x.dtype == torch.int64 and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(),
                                      np.asarray(want).astype(np.int64))
    assert (x.numpy() >= 2 ** 31).any()
    host = [lt_random.Xorshift32(int(v))() for v in s[:64]]
    np.testing.assert_array_equal(
        lt_random.xorshift32_step(s[:64].astype(np.int64), "cpu").numpy(),
        host)


# ---------------------------------------------- primes, build modes, debug

def test_prime_helpers_vs_reference():
    for x in range(-3, 3000):
        assert numeric.is_prime(x) == ref_numeric.is_prime(x), x
        assert numeric.next_prime(x) == ref_numeric.next_prime(x), x
    assert numeric.is_prime(7919) and not numeric.is_prime(7917)
    for begin, end in ((100, 200), (24, 28), (1, 1), (10 ** 6, 10 ** 6 + 200)):
        a, b = np.random.default_rng(3), np.random.default_rng(3)
        got = [numeric.random_prime(begin, end, a) for _ in range(20)]
        assert got == [ref_numeric.random_prime(begin, end, b)
                       for _ in range(20)]
    # 128 draws in a range without a prime give end + 1
    assert numeric.random_prime(24, 28, np.random.default_rng(0)) == 29


@pytest.mark.parametrize("mode", range(6))
def test_build_modes_vs_reference(capsys, mode):
    names = ["BUILD_RELEASE", "BUILD_ERROR", "BUILD_WARNING", "BUILD_INFO",
             "BUILD_DEBUG", "BUILD_TRACE"]
    assert [getattr(debug, n) for n in names] \
        == [getattr(ref_debug, n) for n in names]
    old, ref_old = debug.build_mode(), ref_debug.build_mode()
    try:
        raised = []
        for mod in (debug, ref_debug):
            mod.set_build_mode(mode)
            assert mod.build_mode() == mode
            for call in (lambda: mod.ASSERT(False, "x"),
                         lambda: mod.ASSERT_THAT(lambda: False, "x"),
                         lambda: mod.ASSERT(True),
                         lambda: mod.ASSERT_THAT(lambda: True)):
                try:
                    call()
                    raised.append(False)
                except AssertionError:
                    raised.append(True)
            for level in ("error", "warning", "info", "debug", "trace"):
                getattr(mod, f"log_{level}")(f"msg {level}")
        assert raised[:4] == raised[4:] == [mode >= 1, mode >= 1, False,
                                            False]
        lines = [ln.split(" ", 2)[2] for ln in
                 capsys.readouterr().out.splitlines()]
        half = len(lines) // 2
        assert lines[:half] == lines[half:] and half == mode
    finally:
        debug.set_build_mode(old)
        ref_debug.set_build_mode(ref_old)


# ------------------------------------------------ device deletion sampler

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("batch_size", [0, 1, 500])
def test_edge_deletions_device_contract(rng, seed, batch_size):
    """Draws cannot equal ``jax.random``'s, so the contract is held: each
    valid pair is an edge, ``valid`` is ``deg(u) > 0``, ids in range,
    and one generator seed gives one output."""
    gr = random_graph(rng, 200, 0.8)        # many vertices of degree 0
    g = _port(gr)
    deg = np.asarray(g.degrees)
    assert (deg == 0).any() and (deg > 0).any()
    out = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(seed)
        out.append(batch.generate_edge_deletions_device(gen, g, batch_size,
                                                        device="cpu"))
    (pairs, valid), (pairs2, valid2) = out
    assert torch.equal(pairs, pairs2) and torch.equal(valid, valid2)
    assert pairs.shape == (batch_size, 2) and pairs.dtype == torch.int32
    assert valid.dtype == torch.bool and valid.shape == (batch_size,)
    p, ok = pairs.numpy(), valid.numpy()
    assert ((p[:, 0] >= 0) & (p[:, 0] < g.n)).all()
    assert ((p[:, 1] >= 0) & (p[:, 1] <= g.n)).all()
    np.testing.assert_array_equal(ok, deg[p[:, 0]] > 0)
    assert all(g.has_edge(u, v) for u, v in p[ok])
    if batch_size >= 500:
        assert 0 < ok.sum() < batch_size


def test_edge_deletions_device_clamps_the_last_edge(monkeypatch):
    """A draw that rounds ``r * d`` up to ``d`` takes the last edge."""
    g = lt.from_edges([0, 0, 0, 1], [1, 2, 3, 0], n=4)
    monkeypatch.setattr(torch, "rand",
                        lambda n, **kw: torch.full((n,), 1.0))
    monkeypatch.setattr(torch, "randint",
                        lambda lo, hi, shape, **kw: torch.zeros(
                            shape, dtype=torch.int64))
    pairs, valid = batch.generate_edge_deletions_device(
        torch.Generator(), g, 3, device="cpu")
    assert pairs.tolist() == [[0, 3]] * 3 and valid.all()


# ------------------------------------------------ no card: the calls raise

def test_device_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = lt.from_edges([0, 1], [1, 0], n=3)
    calls = [
        lambda: traverse.bfs_levels(g, 0),
        lambda: properties.communities_disconnected(g, np.zeros(3, int)),
        lambda: topk.topk_init(4),
        lambda: lt_random.xorshift32_step(np.array([1, 2])),
        lambda: batch.generate_edge_deletions_device(torch.Generator(), g, 4),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            call()
