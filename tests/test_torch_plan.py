"""The port's NumPy copies of the host layer against the reference: graphs,
transforms, R-MAT synthesis, the deletion pipeline and ``build_plan``, every
array field ``np.array_equal`` (dtype included) and every scalar equal.

The port cannot import the reference's host modules (they import jax, and
the machine with the card has none), so these tests pin the copies.
"""
import dataclasses

import numpy as np
import pytest

from conftest import powerlaw_graph

import linkpred_tpu as lp
from linkpred_tpu.bench import synth as ref_synth
from linkpred_tpu.ops import batch as ref_batch
from linkpred_tpu.ops import transform as ref_transform
from linkpred_tpu.predict import plan as ref_plan

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import convert
from linkpred_tpu_torch.bench import synth
from linkpred_tpu_torch.io import native
from linkpred_tpu_torch.ops import batch, transform
from linkpred_tpu_torch.predict import plan


def _both_graphs(src, dst, n):
    gr = ref_transform.remove_self_loops(
        ref_transform.symmetrize(lp.from_edges(src, dst, n=n)))
    gp = transform.remove_self_loops(
        transform.symmetrize(lt.from_edges(src, dst, n=n)))
    return gr, gp


def _assert_graph_equal(gp, gr):
    assert (gp.n, gp.m) == (gr.n, gr.m)
    for f in ("offsets", "indices", "degrees"):
        a, b = np.asarray(getattr(gp, f)), np.asarray(getattr(gr, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (gp.weights is None) == (gr.weights is None)


def _assert_plan_equal(pp, rp, path="plan"):
    assert (pp is None) == (rp is None), path
    if rp is None:
        return
    for f in dataclasses.fields(rp):
        if f.name == "_device":
            continue
        a, b = getattr(pp, f.name), getattr(rp, f.name)
        where = f"{path}.{f.name}"
        if f.name in ("huge_plan", "side_plan"):
            _assert_plan_equal(a, b, where)
        elif isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray), where
            assert a.dtype == b.dtype and np.array_equal(a, b), where
        else:
            assert a == b and type(a) is type(b), where


def _random_edges(rng, n, avg_deg):
    m = int(n * avg_deg)
    return rng.integers(0, n, m), rng.integers(0, n, m)


@pytest.mark.parametrize("d1,cap", [(0, None), (4, None), (64, 1024),
                                    (0, 512)])
def test_build_plan_random_graph(rng, d1, cap):
    src, dst = _random_edges(rng, 300, 6)
    gr, gp = _both_graphs(src, dst, 300)
    _assert_graph_equal(gp, gr)
    _assert_plan_equal(plan.build_plan(gp, d1, cap, device="cpu"),
                       ref_plan.build_plan(gr, d1, cap))


def test_build_plan_numpy_fallback(rng, monkeypatch):
    """Without the native library the port's NumPy pipeline gives the same
    plan as the reference's native one."""
    monkeypatch.setattr(native, "native_lib", lambda: None)
    src, dst = _random_edges(rng, 300, 6)
    gr, gp = _both_graphs(src, dst, 300)
    _assert_plan_equal(plan.build_plan(gp, 0, 1024, device="cpu"),
                       ref_plan.build_plan(gr, 0, 1024))


def test_build_plan_hub_subplan(rng):
    """conftest's power-law graph + small cap: the hub sub-plan is forced."""
    gr = powerlaw_graph(rng, n=300, m=2000)
    gp = convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                   gr.n, gr.m)
    rp = ref_plan.build_plan(gr, 0, 512)
    assert rp.huge_plan is not None, "test premise: hub sub-plan"
    _assert_plan_equal(plan.build_plan(gp, 0, 512, device="cpu"), rp)


def test_build_plan_side_plan_wide_degrees():
    """One hub of degree 65,600 (tests/test_degsplit.py's graph): the
    oversized-degree pairs ride a wide side plan."""
    n_ring, n_pairs = 10, 32800
    k = 2 * n_pairs
    ring = np.arange(n_ring)
    sat = n_ring + np.arange(k)
    con = n_ring + k + np.arange(k)
    hub = n_ring + 2 * k
    e = np.concatenate([np.stack([ring, (ring + 1) % n_ring], 1),
                        np.stack([sat, con], 1),
                        np.stack([con, np.full(k, hub)], 1)])
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    gr = lp.from_edges(src, dst, n=hub + 1)
    gp = lt.from_edges(src, dst, n=hub + 1)
    rp = ref_plan.build_plan(gr, 2, cap=1 << 16)
    assert rp.side_plan is not None and not rp.side_plan.deg16
    _assert_plan_equal(plan.build_plan(gp, 2, cap=1 << 16, device="cpu"), rp)


def test_build_plan_sources_and_edge_stream(rng):
    src, dst = _random_edges(rng, 200, 5)
    gr, gp = _both_graphs(src, dst, 200)
    sources = np.array([3, 17, 42, 199])
    _assert_plan_equal(
        plan.build_plan(gp, 0, 1024, sources=sources, device="cpu"),
        ref_plan.build_plan(gr, 0, 1024, sources=sources))
    # slot_budget=0 forces the edge stream: the plan still matches
    _assert_plan_equal(plan.build_plan(gp, 8, 1024, slot_budget=0,
                                       device="cpu"),
                       ref_plan.build_plan(gr, 8, 1024, slot_budget=0))


def test_plan_from_fields_roundtrip(rng):
    n, m = 300, 2000
    src = rng.integers(0, n, m) ** 2 % n
    dst = rng.integers(0, n, m)
    gr, _ = _both_graphs(src, dst, n)
    rp = ref_plan.build_plan(gr, 0, 512)
    _assert_plan_equal(convert.plan_from_fields(**dataclasses.asdict(rp)), rp)
    gp = convert.graph_from_arrays(gr.offsets, gr.indices, gr.degrees,
                                   gr.n, gr.m)
    _assert_graph_equal(gp, gr)


def test_rmat_and_deletion_pipeline():
    gr = ref_synth.rmat_graph(9, edge_factor=8, seed=42)
    gp = synth.rmat_graph(9, edge_factor=8, seed=42)
    _assert_graph_equal(gp, gr)
    dr = ref_batch.generate_edge_deletions(np.random.default_rng(0), gr,
                                           int(0.1 * gr.size / 2))
    dp = batch.generate_edge_deletions(np.random.default_rng(0), gp,
                                       int(0.1 * gp.size / 2))
    np.testing.assert_array_equal(dp, dr)
    none = np.empty((0, 2), np.int64)
    dr, ir = ref_batch.tidy_batch(dr, none, gr)
    dp, ip = batch.tidy_batch(dp, none, gp)
    np.testing.assert_array_equal(dp, dr)
    np.testing.assert_array_equal(ip, ir)
    yr = ref_batch.apply_batch(gr, dr, ir)
    yp = batch.apply_batch(gp, dp, ip)
    _assert_graph_equal(yp, yr)
    assert yp.m == gp.m - dp.shape[0]
    _assert_plan_equal(plan.build_plan(yp, 64, device="cpu"),
                       ref_plan.build_plan(yr, 64))


def test_planted_partition_graph():
    _assert_graph_equal(synth.planted_partition_graph(8, 32, seed=1),
                        ref_synth.planted_partition_graph(8, 32, seed=1))
