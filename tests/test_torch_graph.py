"""The port's graph builders and transforms against ``linkpred_tpu``'s on the
same seeded NumPy inputs: ``from_dense``/``to_dense``, ``GraphBuilder``
(removals, re-adds with weights, ``respan`` with vertex values) and every
transform of ``ops/transform.py``.  Both sides are host NumPy, so every
comparison is exact: the same CSR arrays, weights and vertex values.
Mirrors the cases of ``tests/test_graph.py``."""
import numpy as np
import pytest

import linkpred_tpu as lp
from linkpred_tpu.ops import transform as ref_transform

import linkpred_tpu_torch as lt
from linkpred_tpu_torch.io import mtx
from linkpred_tpu_torch.ops import transform
from linkpred_tpu_torch.predict import api


def _assert_same_graph(got, want):
    want = want.host()
    assert (got.n, got.m) == (want.n, want.m)
    for name in ("offsets", "indices", "degrees", "weights", "values"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def _edges(rng, n, m, weighted, values):
    """Directed edges with self loops and duplicates, optional weights and
    vertex values: the same arrays for both packages."""
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    w = rng.random(m).astype(np.float32) * 9 + 0.5 if weighted else None
    vv = (rng.integers(0, 100, n).astype(np.int32) if values else None)
    return src, dst, n, w, vv


def _both(src, dst, n, w, vv):
    return (lt.from_edges(src, dst, n=n, weights=w, vertex_values=vv),
            lp.from_edges(src, dst, n=n, weights=w, vertex_values=vv))


@pytest.mark.parametrize("n,p", [(1, 1.0), (40, 0.1), (70, 0.4)])
def test_dense_roundtrip_vs_reference(rng, n, p):
    a = rng.random((n, n)) < p
    got, want = lt.from_dense(a), lp.from_dense(a)
    _assert_same_graph(got, want)
    np.testing.assert_array_equal(lt.to_dense(got), lp.to_dense(want))
    np.testing.assert_array_equal(lt.to_dense(got), a)


def test_graph_builder_lazy_update_vs_reference():
    steps = []
    for mod in (lt, lp):
        g = (mod.GraphBuilder().add_edge(0, 1).add_edge(1, 2).add_edge(0, 1)
             .update())
        g2 = mod.GraphBuilder(base=g).remove_edge(0, 1).add_edge(2, 0) \
            .update()
        g3 = mod.GraphBuilder(base=g2).respan(10).update()
        steps.append((g, g2, g3))
    for got, want in zip(*steps):
        _assert_same_graph(got, want)
    assert steps[0][2].n == 10 and steps[0][2].m == 2


def test_graph_builder_weighted_vs_reference():
    """Removals, a re-add that replaces a weight, and a second update
    cycle on the rebuilt graph."""
    src, dst = [0, 1, 1, 2], [1, 0, 2, 1]
    w = np.array([3.0, 3.0, 5.0, 5.0], np.float32)
    out = []
    for mod in (lt, lp):
        b = mod.GraphBuilder(mod.from_edges(src, dst, n=4, weights=w))
        b.remove_edge(1, 2).remove_edge(2, 1)
        b.add_edge(2, 3, 9.0).add_edge(3, 2, 9.0).add_edge(0, 1, 4.5)
        g = b.update()
        out.append((g, mod.GraphBuilder(g).add_edge(1, 2, 6.0).update()))
    for got, want in zip(*out):
        _assert_same_graph(got, want)
    assert out[0][0].weights is not None


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("values", [False, True])
def test_graph_builder_random_ops_vs_reference(rng, weighted, values):
    """A random run of additions (default and other weights), removals of
    present and absent pairs and re-adds, a respan past the last vertex,
    and two update cycles; vertex values are carried and extended."""
    got, want = _both(*_edges(rng, 50, 300, weighted, values))
    bt, bp = lt.GraphBuilder(got), lp.GraphBuilder(want)
    for cycle in range(2):
        for _ in range(120):
            u, v = (int(x) for x in rng.integers(0, 55 + 5 * cycle, 2))
            if rng.random() < 0.4:
                bt.remove_edge(u, v)
                bp.remove_edge(u, v)
            else:
                x = 1.0 if rng.random() < 0.5 else float(rng.random() * 4)
                bt.add_edge(u, v, x)
                bp.add_edge(u, v, x)
        bt.respan(70 + cycle)
        bp.respan(70 + cycle)
        _assert_same_graph(bt.update(), bp.update())


@pytest.mark.parametrize("name", [
    "symmetrize", "remove_self_loops", "add_self_loops", "transpose",
    "duplicate"])
@pytest.mark.parametrize("weighted", [False, True])
def test_transform_vs_reference(rng, name, weighted):
    got, want = _both(*_edges(rng, 60, 400, weighted, True))
    _assert_same_graph(getattr(transform, name)(got),
                       getattr(ref_transform, name)(want))


@pytest.mark.parametrize("weighted", [False, True])
def test_count_self_loops_and_degree_transpose_vs_reference(rng, weighted):
    got, want = _both(*_edges(rng, 60, 400, weighted, False))
    assert transform.count_self_loops(got) \
        == ref_transform.count_self_loops(want) > 0
    assert transform.count_self_loops(transform.add_self_loops(got)) \
        == ref_transform.count_self_loops(ref_transform.add_self_loops(want))
    gt, deg = transform.transpose_with_degree(got)
    rt, rdeg = ref_transform.transpose_with_degree(want)
    _assert_same_graph(gt, rt)
    np.testing.assert_array_equal(deg, rdeg)
    np.testing.assert_array_equal(gt.values, got.degrees)


@pytest.mark.parametrize("weighted", [False, True])
def test_duplicate_if_vs_reference(rng, weighted):
    got, want = _both(*_edges(rng, 60, 400, weighted, False))

    def pred(u, v):
        return (u + v) % 3 != 0

    _assert_same_graph(transform.duplicate_if(got, pred),
                       ref_transform.duplicate_if(want, pred))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size", [0, 1, 25, 60])
def test_subgraph_vs_reference(rng, weighted, size):
    """The induced subgraph keeps weights and the subset's vertex values,
    in ``ks`` order (shuffled here)."""
    got, want = _both(*_edges(rng, 60, 500, weighted, True))
    ks = rng.permutation(60)[:size]
    _assert_same_graph(transform.subgraph(got, ks),
                       ref_transform.subgraph(want, ks))


def test_subgraph_weights_by_hand():
    g = lt.from_edges([0, 1, 2, 3, 0], [1, 2, 3, 0, 2], n=4,
                      weights=np.array([10., 20., 30., 40., 50.], np.float32))
    s = transform.subgraph(g, [0, 2, 3])
    es, ed, w = lt.edge_list(s, with_weights=True)
    assert dict(zip(zip(es.tolist(), ed.tolist()), w.tolist())) == {
        (1, 2): 30.0, (2, 0): 40.0, (0, 1): 50.0}


def test_package_exports_match_reference():
    """The names ``linkpred_tpu`` exports at its top level, and those of
    its ``ops`` package, are exported by the port."""
    import linkpred_tpu.ops as ref_ops
    import linkpred_tpu_torch.ops as ops

    assert set(lp.__all__) - {"__version__"} <= set(lt.__all__)
    assert set(ref_ops.__all__) <= set(ops.__all__)
    for name in ops.__all__:
        assert callable(getattr(ops, name)), name
    assert lt.top_per_source is api.top_per_source
    assert lt.read_mtx_header is mtx.read_mtx_header
