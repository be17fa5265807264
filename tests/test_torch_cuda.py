"""The port on a CUDA card: each kernel against its plain twin on the same
card tensors, and ``predict_links_multi`` and the experiment harness on the
card against the CPU.

This file imports neither jax nor the reference, because the machine with
the card has no jax; tests/conftest.py does, so on the card run it with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Without a card every test skips.  Tolerances: unweighted keys, ku and kw
bit-equal; AA/RA scores rtol 1e-5 (the kernel adds a run's weights in
another order than the twin's log-step scan).
"""
import numpy as np
import pytest
import torch

import linkpred_tpu_torch as lt
from linkpred_tpu_torch.experiments import (pallas_bitonic, pallas_bitonic2,
                                            pallas_smoke, pallas_tail,
                                            radix_probe)
from linkpred_tpu_torch.kernels import _build
from linkpred_tpu_torch.ops import compact
from linkpred_tpu_torch.ops import fused_tail as ft
from linkpred_tpu_torch.ops.topk import TopK, desc_key_score
from linkpred_tpu_torch.predict import api, scoring
from linkpred_tpu_torch.utils.profiling import counter
from linkpred_tpu_torch.predict.plan import build_plan

pytestmark = pytest.mark.cuda

UNWEIGHTED = [n for n, m in lt.METRICS.items() if not m.needs_weight]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_kernels_build_and_load(cuda):
    lib = _build.load()
    assert lib.lp_fused_tail_tile_lanes() > 0
    assert lib.lp_fused_tail_scratch_bytes(1 << 20) > 0
    assert lib.lp_pack_scratch_bytes(1 << 24) > 0


def _tail_inputs(rng, cap, w_bits, run_len, wide, n_wt, device, kill=0.0):
    """A sorted tile: (w, u) pairs repeated ~run_len times, degrees constant
    per pair, pads after ~95% real lanes.  With ``kill``, lo is the edge
    stream's ``u << 1 | real``: each run's first lane is a killer, or all
    its lanes are, with probability ``kill`` each; killer lanes weigh 0."""
    n_real = int(cap * 0.95)
    npair = max(n_real // run_len, 1)
    pid = rng.integers(0, npair, n_real)
    dmax = (1 << 20) if wide else (1 << 16)
    cols = [rng.integers(0, 1 << w_bits, npair)[pid],
            rng.integers(0, 1 << w_bits, npair)[pid],
            rng.integers(1, dmax, npair)[pid],
            rng.integers(1, dmax, npair)[pid]]
    order = np.lexsort((cols[1], cols[0]))
    w, u, du, dw = (np.concatenate([c[order], fill]) for c, fill in zip(
        cols, ((1 << w_bits) | (np.arange(n_real, cap) & 1023),
               np.zeros(cap - n_real, np.int64),
               np.ones(cap - n_real, np.int64),
               np.ones(cap - n_real, np.int64))))
    degs = ([du, dw] if wide else
            [((du << 16) | dw).astype(np.uint32).view(np.int32)])
    wts = [(rng.random(cap) + 0.01).astype(np.float32) for _ in range(n_wt)]
    if kill:
        new = np.r_[True, (np.diff(w[:n_real]) != 0)
                    | (np.diff(u[:n_real]) != 0)][:n_real]
        rid = np.cumsum(new) - 1
        kind = rng.choice(3, int(new.sum()), p=[1 - 2 * kill, kill, kill])
        real = np.ones(cap, bool)
        real[np.flatnonzero(new)[kind == 1]] = False
        real[:n_real][kind[rid] == 2] = False
        real[n_real:] = rng.random(cap - n_real) < 0.5
        for x in wts:
            x[:n_real][~real[:n_real]] = 0.0
        u = (u << 1) | real
    t = lambda a: torch.as_tensor(np.asarray(a).astype(  # noqa: E731
        np.float32 if np.asarray(a).dtype.kind == "f" else np.int32),
        device=device)
    return t(w), t(u), [t(d) for d in degs], [t(x) for x in wts]


def _kernel_vs_twin(hi, lo, degs, wts, min_score, mets, **kw):
    before = counter("k1.launches")
    kk, ku, kv = ft.fused_tail(hi, lo, degs, wts, min_score, metrics=mets,
                               **kw)
    assert counter("k1.launches") == before + 1
    rk, ru, rv = ft.fused_tail_reference(hi, lo, degs, wts, min_score,
                                         metrics=mets, **kw)
    assert torch.equal(ku, ru) and torch.equal(kv, rv)
    for i, m in enumerate(mets):
        if not m.needs_weight:
            assert torch.equal(kk[i], rk[i]), m.name
            continue
        a = desc_key_score(kk[i]).cpu().numpy()
        b = desc_key_score(rk[i]).cpu().numpy()
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-5)
    return kk


@pytest.mark.parametrize("cap,names,wide,min_score,maxf2,run_len", [
    (1 << 16, UNWEIGHTED, False, 0.0, 0, 4),
    (1 << 16, UNWEIGHTED, True, 0.0, 0, 4),
    (100_003, ["jaccard_coefficient", "adamic_adar", "resource_allocation"],
     False, 0.0, 0, 6),
    (1 << 16, ["common_neighbors", "adamic_adar"], False, 0.0, 0, 5000),
    (1 << 16, ["jaccard_coefficient"], False, 0.01, 0, 4),
    (1 << 15, ["hub_promoted", "resource_allocation"], False, 0.0, 2, 4),
    # the hub sub-plan's cap: 8,192 tiles of look-back words
    (1 << 23, ["jaccard_coefficient", "adamic_adar"], False, 0.0, 0, 3000),
])
def test_fused_tail_kernel_vs_twin(rng, cuda, cap, names, wide, min_score,
                                   maxf2, run_len):
    mets = [lt.METRICS[m] for m in names]
    n_wt = sum(m.needs_weight for m in mets)
    hi, lo, degs, wts = _tail_inputs(rng, cap, 20, run_len, wide, n_wt, cuda)
    _kernel_vs_twin(hi, lo, degs, wts, min_score, mets, w_bits=20,
                    n=1 << 20, maxf2=maxf2)


@pytest.mark.parametrize("cap,names,wide,min_score,maxf2,run_len", [
    (1 << 16, UNWEIGHTED, False, 0.0, 0, 4),
    (1 << 16, UNWEIGHTED, True, 0.001, 0, 4),
    (100_003, ["jaccard_coefficient", "adamic_adar", "resource_allocation"],
     False, 0.0, 2, 6),
    (1 << 16, ["adamic_adar", "resource_allocation"], True, 0.0, 0, 8),
    (1 << 16, ["common_neighbors", "adamic_adar"], False, 0.0, 0, 5000),
    (1 << 23, ["jaccard_coefficient", "adamic_adar"], False, 0.0, 0, 3000),
])
def test_fused_tail_killers_kernel_vs_twin(rng, cuda, cap, names, wide,
                                           min_score, maxf2, run_len):
    """K1's killer branch (edge stream): runs are (w, lo >> 1), a run is
    alive iff its first lane is real; long runs cross the kernel's tiles
    with their killer in the earlier tile."""
    mets = [lt.METRICS[m] for m in names]
    n_wt = sum(m.needs_weight for m in mets)
    hi, lo, degs, wts = _tail_inputs(rng, cap, 20, run_len, wide, n_wt, cuda,
                                     kill=0.2)
    kk = _kernel_vs_twin(hi, lo, degs, wts, min_score, mets, w_bits=20,
                         n=1 << 20, maxf2=maxf2, killers=True)
    h, l_ = hi.cpu().numpy(), lo.cpu().numpy()
    start = np.flatnonzero(np.r_[True, (np.diff(h) != 0)
                                 | (np.diff(l_ >> 1) != 0)])
    end = np.r_[start[1:], cap] - 1
    dead = (l_[start] & 1) == 0
    assert dead.any() and not dead.all(), "test premise"
    assert np.all(desc_key_score(kk[0]).cpu().numpy()[end[dead]]
                  == -np.inf), "a killed run scored"
    tile = _build.load().lp_fused_tail_tile_lanes()
    if run_len > tile:
        crosses = dead & (start // tile != end // tile)
        assert crosses.any(), "test premise: killed runs cross tiles"


def _runs(rng, lengths, names, killers=False, dead=()):
    """Sorted lanes made of runs of the given lengths (distinct ascending
    (w, u) pairs), random deg16 pairs and weights; with ``killers`` the
    runs numbered in ``dead`` start with a killer lane (weight 0)."""
    mets = [lt.METRICS[m] for m in names]
    pid = np.repeat(np.arange(len(lengths)), lengths)
    w, u = pid // 7, pid % 7 + 1
    cap = pid.shape[0]
    dpack = ((rng.integers(1, 1 << 16, cap) << 16)
             | rng.integers(1, 1 << 16, cap)).astype(np.uint32).view(np.int32)
    wts = [(rng.random(cap) + 0.01).astype(np.float32)
           for m in mets if m.needs_weight]
    if killers:
        real = np.ones(cap, np.int64)
        starts = np.r_[0, np.cumsum(lengths)[:-1]]
        real[starts[list(dead)]] = 0
        for x in wts:
            x[real == 0] = 0.0
        u = (u << 1) | real
    return (w.astype(np.int32), u.astype(np.int32), [dpack], wts), mets


def _on(device, arrays):
    hi, lo, degs, wts = arrays
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return t(hi), t(lo), [t(d) for d in degs], [t(x) for x in wts]


@pytest.mark.parametrize("offset", [-1, 0, 1])
@pytest.mark.parametrize("killers", [False, True])
def test_fused_tail_kernel_tile_edges(rng, cuda, offset, killers):
    """cap = the tile size - 1, the tile size, + 1; and cap 1."""
    tile = _build.load().lp_fused_tail_tile_lanes()
    names = ["jaccard_coefficient", "adamic_adar", "resource_allocation"]
    for cap in (tile + offset, 1):
        mets = [lt.METRICS[m] for m in names]
        hi, lo, degs, wts = _tail_inputs(rng, cap, 12, 3, False, 2, cuda,
                                         kill=0.2 if killers else 0.0)
        _kernel_vs_twin(hi, lo, degs, wts, 0.0, mets, w_bits=12, n=1 << 12,
                        killers=killers)


@pytest.mark.parametrize("cap", [1, 3, 4097, 100_003])
@pytest.mark.parametrize("shift", ["all", "hi_only"])
def test_fused_tail_kernel_misaligned_views(rng, cuda, cap, shift):
    """Inputs that are views one lane into their buffers (not 16-byte
    aligned), all of them or hi alone (the other arrays then line up
    otherwise and take scalar accesses); caps no multiple of 4 but one."""
    names = ["jaccard_coefficient", "common_neighbors", "adamic_adar"]
    mets = [lt.METRICS[m] for m in names]
    for killers in (False, True):
        args = _tail_inputs(rng, cap, 12, 5, True, 1, cuda,
                            kill=0.2 if killers else 0.0)

        def view(x, move):
            if not move:
                return x
            buf = torch.empty(cap + 1, dtype=x.dtype, device=cuda)
            buf[1:] = x
            return buf[1:]

        hi, lo, degs, wts = args
        hi = view(hi, True)
        assert hi.data_ptr() % 16 != 0 and hi.is_contiguous()
        rest = shift == "all"
        lo, degs, wts = (view(lo, rest), [view(d, rest) for d in degs],
                         [view(x, rest) for x in wts])
        _kernel_vs_twin(hi, lo, degs, wts, 0.0, mets, w_bits=12, n=1 << 12,
                        killers=killers)


@pytest.mark.parametrize("killers,dead", [
    (False, ()), (True, ()), (True, (1,)), (True, (1, 3))])
def test_fused_tail_kernel_deep_look_back(rng, cuda, killers, dead):
    """Runs spanning 3 to 40 tiles, so a tile's look-back walks past
    several predecessors (and past a window of 32), with and without a
    killer lane at the start of a long run: run 1 begins in the first tile
    and ends in the fourth."""
    tile = _build.load().lp_fused_tail_tile_lanes()
    lengths = [tile // 3, int(3.5 * tile), 5, 40 * tile + 17, 2 * tile, 9]
    arrays, mets = _runs(rng, lengths, ["common_neighbors", "adamic_adar"],
                         killers, dead)
    hi, lo, degs, wts = _on(cuda, arrays)
    kk = _kernel_vs_twin(hi, lo, degs, wts, 0.0, mets, w_bits=12, n=1 << 12,
                         killers=killers)
    ends = np.cumsum(lengths) - 1
    got = desc_key_score(kk[0]).cpu().numpy()[ends]
    alive = np.ones(len(lengths), bool)
    alive[list(dead)] = False
    np.testing.assert_array_equal(got[alive], np.array(lengths)[alive])
    assert np.all(got[~alive] == -np.inf)


@pytest.mark.parametrize("killers", [False, True])
def test_fused_tail_kernel_one_run(rng, cuda, killers):
    """A single run over the whole cap (every tile's look-back walks to
    tile 0), and every lane a run of its own."""
    tile = _build.load().lp_fused_tail_tile_lanes()
    cap = 70 * tile + 3
    for lengths in ([cap], [1] * cap):
        arrays, mets = _runs(rng, lengths, ["jaccard_coefficient",
                                            "adamic_adar",
                                            "resource_allocation"], killers)
        _kernel_vs_twin(*_on(cuda, arrays), 0.0, mets, w_bits=16, n=1 << 16,
                        killers=killers)


def test_fused_tail_kernel_back_to_back_bit_equal(rng, cuda):
    """Two calls on one stream with no sync between, AA/RA with long runs:
    each starts from fresh look-back words, and the weight sums come out
    in the same bits."""
    names = ["adamic_adar", "resource_allocation", "jaccard_coefficient"]
    mets = [lt.METRICS[m] for m in names]
    hi, lo, degs, wts = _tail_inputs(rng, (1 << 20) + 3, 20, 700, False, 2,
                                     cuda, kill=0.2)
    kw = dict(metrics=mets, w_bits=20, n=1 << 20, killers=True)
    first = ft.fused_tail(hi, lo, degs, wts, 0.0, **kw)
    second = ft.fused_tail(hi, lo, degs, wts, 0.0, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    _kernel_vs_twin(hi, lo, degs, wts, 0.0, mets, **{
        k: v for k, v in kw.items() if k != "metrics"})


@pytest.mark.parametrize("dist", ["random", "clustered", "none", "all"])
def test_pack_kernel_vs_twin(rng, cuda, dist):
    total = (1 << 20) + 77
    key = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, total)
                          .astype(np.int32), device=cuda)
    thr = {"random": -(1 << 28), "clustered": 5, "none": -(1 << 31),
           "all": (1 << 31) - 1}[dist]
    if dist == "clustered":
        key[:] = 1 << 30
        key[300_000: 300_000 + 50_000] = 3
    thr = torch.tensor(thr, dtype=torch.int32, device=cuda)
    before = counter("k2.launches")
    out = compact.pack_survivors(key, thr)
    assert counter("k2.launches") == before + 1
    ref = compact.pack_survivors_reference(key, thr)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d1", [0, 4])
def test_predict_cuda_matches_cpu(rng, cuda, monkeypatch, d1):
    n, m = 300, 1800
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g = lt.from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]),
                      n=n)
    # reach the survivor pack at this size
    monkeypatch.setattr(scoring, "SEL_PACK_MIN", 1 << 12)
    kw = dict(min_degree1=d1, cap=1024,
              options=lt.PredictOptions(max_edges=200))
    got = lt.predict_links_multi(g, list(lt.METRICS), device=cuda, **kw)
    want = lt.predict_links_multi(g, list(lt.METRICS), device="cpu", **kw)
    for name, spec in lt.METRICS.items():
        a, b = got[name], want[name]
        assert len(a) == len(b) > 0
        if spec.needs_weight:
            np.testing.assert_allclose(np.sort(a.score), np.sort(b.score),
                                       rtol=1e-5)
        else:
            np.testing.assert_array_equal(np.sort(a.score), np.sort(b.score))
        cut = b.score.min() * (1 + 1e-5)
        assert ({(u, v) for u, v, s in zip(a.u, a.v, a.score) if s > cut}
                == {(u, v) for u, v, s in zip(b.u, b.v, b.score) if s > cut})


def _same_results(got, want):
    for name, spec in lt.METRICS.items():
        if name not in got:
            continue
        a, b = got[name], want[name]
        assert len(a) == len(b) > 0, name
        if spec.needs_weight:
            np.testing.assert_allclose(np.sort(a.score), np.sort(b.score),
                                       rtol=1e-5)
        else:
            np.testing.assert_array_equal(np.sort(a.score), np.sort(b.score))
        cut = b.score.min() * (1 + 1e-5)
        assert ({(u, v) for u, v, s in zip(a.u, a.v, a.score) if s > cut}
                == {(u, v) for u, v, s in zip(b.u, b.v, b.score) if s > cut})


@pytest.mark.parametrize("d1,keyed,sources", [
    (0, True, None), (4, True, None), (0, False, None),
    (0, True, np.array([3, 17, 42, 99])),
])
def test_edge_stream_cuda_matches_cpu(rng, cuda, d1, keyed, sources):
    """A forced edge stream (slot_budget=0): keyed (K1's killer branch) and
    sentinel, full graph and serving mode, on the card against the CPU."""
    import dataclasses

    n, m = 300, 1800
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g = lt.from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]),
                      n=n)
    names = list(lt.METRICS)
    out = {}
    for dev in (cuda, "cpu"):
        p = build_plan(g, d1, 1024, slot_budget=0, sources=sources,
                       device=dev)
        assert not p.packed
        before = counter("k1.launches")
        out[str(dev)] = lt.predict_links_multi(
            g, names, min_degree1=d1, sources=sources, device=dev,
            plan=p if keyed else dataclasses.replace(p, keyed=False),
            options=lt.PredictOptions(max_edges=500))
        if dev != "cpu":
            assert (counter("k1.launches") > before) == keyed
    _same_results(out[str(cuda)], out["cpu"])


def test_p1_kernel_vs_xla_tail(rng, cuda):
    """P1: K1 at the prototype's configuration, bit-equal to the plain
    copy of its XLA tail."""
    hi, lo, dpack = (torch.as_tensor(a, device=cuda)
                     for a in pallas_tail.make_stream(rng, 1 << 18))
    before = counter("k1.launches")
    got = pallas_tail.pallas_tail(hi, lo, dpack, 0.0)
    assert counter("k1.launches") == before + 1
    for a, b in zip(got, pallas_tail.xla_tail(hi, lo, dpack, 0.0)):
        assert torch.equal(a, b)


def test_p5_kernel(cuda):
    x = torch.arange(-512, 512, dtype=torch.int32, device=cuda).reshape(8, 128)
    x[0, 0] = (1 << 31) - 1
    before = pallas_smoke.LAUNCHES
    got = pallas_smoke.affine_smoke(x)
    assert pallas_smoke.LAUNCHES == before + 1
    assert torch.equal(got, pallas_smoke.affine_smoke_reference(x))


@pytest.mark.parametrize("n,shift", [
    ((1 << 20) + 1, 0),     # n % 4 == 1: the scalar tail
    ((1 << 20) + 3, 0),     # n % 4 == 3
    (1 << 20, 1),           # a view one element in: not 16-byte aligned
    (7, 1),                 # shorter than one int4 word
])
def test_p5_kernel_ragged_and_misaligned(rng, cuda, n, shift):
    host = rng.integers(-(1 << 31), 1 << 31, n + shift).astype(np.int32)
    buf = torch.as_tensor(host, device=cuda)
    x = buf[shift:]
    assert (x.data_ptr() % 16 != 0) == bool(shift)
    before = pallas_smoke.LAUNCHES
    got = pallas_smoke.affine_smoke(x)
    assert pallas_smoke.LAUNCHES == before + 1
    assert torch.equal(got, pallas_smoke.affine_smoke_reference(x))
    want = (host[shift:].astype(np.int64) * 2 + 1).astype(np.int32)
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_launch_floor(cuda):
    us = pallas_smoke.launch_floor_us(cuda, 200)
    assert 0 < us < 100


@pytest.mark.parametrize("log2n,dist", [
    (7, "full"),        # one CTA of four threads, below one tile
    (12, "full"),       # one CTA, below one tile
    (13, "full"),       # exactly one tile
    (14, "full"),       # tile * 2: the first global launch
    (15, "full"),
    (20, "full"),
    (23, "full"),       # the hub sub-plan's cap, past the L2 with payload;
    #                     its two largest merges take two global launches
    (13, "tied"),       # keys from 16 values: ties everywhere
    (14, "tied"),
    (15, "tied"),
    (20, "tied"),
])
def test_bitonic_kernel_vs_plain(rng, cuda, log2n, dist):
    """P2 keys-only, P2 kv and P3 kv at the planner's boundary sizes: keys
    and payload bit-equal to the plain network (on ties each lane keeps its
    payload), keys equal to torch.sort, and the inputs left as they
    were."""
    n = 1 << log2n
    shape = (n // 128, 128)
    if dist == "tied":
        x = rng.integers(-8, 8, n)
    else:
        x = rng.integers(-(1 << 31), 1 << 31, n)
    x = torch.as_tensor(x.astype(np.int32), device=cuda).reshape(shape)
    pay = torch.as_tensor(rng.permutation(n).astype(np.int32),
                          device=cuda).reshape(shape)
    x0, pay0 = x.clone(), pay.clone()
    want_k, want_p = pallas_bitonic.bitonic_stages(x, n, payload=pay)
    before = (pallas_bitonic.LAUNCHES, pallas_bitonic2.LAUNCHES)
    keys = pallas_bitonic.make_pallas_sort(n)(x)
    kv = pallas_bitonic.make_pallas_sort_kv(n)(x, pay)
    table = pallas_bitonic2.make_sort(n)(x, pay)
    bare = pallas_bitonic2.make_sort(n, with_payload=False)(x, pay)
    assert (pallas_bitonic.LAUNCHES, pallas_bitonic2.LAUNCHES) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(x, x0) and torch.equal(pay, pay0)
    assert torch.equal(keys, want_k)
    assert torch.equal(keys.reshape(-1), torch.sort(x.reshape(-1)).values)
    for k, p in (kv, table):
        assert torch.equal(k, want_k) and torch.equal(p, want_p)
    assert torch.equal(bare[0], want_k) and torch.equal(bare[1], pay)


@pytest.mark.parametrize("log2n,tile", [(12, 64), (14, 256), (16, 1 << 10),
                                        (18, 1 << 12)])
def test_bitonic_kernel_small_tiles(rng, cuda, log2n, tile):
    """Small tiles put global launches of one to seven stages, and merges
    split over several, at small n: the kernel in the planner's grouping
    equals the plain network."""
    n = 1 << log2n
    ks, js = pallas_bitonic2.stage_table(n)
    plan = pallas_bitonic.plan_launches(ks, js, n, tile=tile)
    sizes = set(plan[plan[:, 0] == pallas_bitonic.GLOBAL_LAUNCH, 2].tolist())
    assert sizes, "test premise: global launches"
    x = torch.as_tensor(rng.integers(-8, 8, n).astype(np.int32), device=cuda)
    pay = torch.as_tensor(rng.permutation(n).astype(np.int32), device=cuda)
    want = pallas_bitonic.bitonic_stages(x, n, payload=pay)
    for with_payload in (True, False):
        k, p = x.clone(), pay.clone()
        before = pallas_bitonic.GRID_LAUNCHES
        launched = pallas_bitonic.sort_network(
            k, p if with_payload else None, ks, js, plan, "small tiles",
            tile=tile)
        assert launched == len(plan)
        assert pallas_bitonic.GRID_LAUNCHES == before + len(plan)
        assert torch.equal(k, want[0])
        assert torch.equal(p, want[1] if with_payload else pay)


def test_bitonic_kernel_refuses_a_bad_plan(cuda):
    n = 1 << 15
    ks, js = pallas_bitonic2.stage_table(n)
    plan = pallas_bitonic.plan_launches(ks, js, n)
    x = torch.zeros(n, dtype=torch.int32, device=cuda)
    bad = plan.copy()
    bad[0, 2] -= 1                       # the launches skip a stage
    with pytest.raises(RuntimeError, match="CUDA error"):
        pallas_bitonic.sort_network(x, None, ks, js, bad, "bad plan")
    bad = plan.copy()
    bad[1, 0] = pallas_bitonic.TILE_LAUNCH   # a global stage in a tile run
    with pytest.raises(RuntimeError, match="CUDA error"):
        pallas_bitonic.sort_network(x, None, ks, js, bad, "bad plan")


def test_bitonic_kernel_refuses_bad_operands(cuda):
    f = pallas_bitonic.make_pallas_sort(1 << 10)
    with pytest.raises(ValueError, match="expected int32"):
        f(torch.zeros((4, 128), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="expected int32"):
        f(torch.zeros((8, 128), dtype=torch.int64, device=cuda))


_P4_STRESS = {
    "all at 0": [0] * 256,
    "all at 504": [504] * 256,
    "clamped": [-5, 10 ** 6, 17, -5, 10 ** 6, 250] * 42 + [-5] * 4,
    "band edges": [31, 32, 33, 63, 64, 65, 24, 25, 39, 40, 95, 96, 97, 479,
                   480, 481, 503, 504, 0, 1] * 12 + [31] * 16,
}


@pytest.mark.parametrize("iters", [1, 2, 32])
@pytest.mark.parametrize("name", list(_P4_STRESS))
def test_dynstore_kernel_stress_offsets(cuda, name, iters):
    """Offsets that pile every store on one band, move under the clamp,
    or straddle the kernel's band edges."""
    offs = torch.tensor(_P4_STRESS[name], dtype=torch.int32, device=cuda)
    assert offs.numel() == radix_probe.NSTORES
    _, x = radix_probe.dynstore_inputs(np.random.default_rng(5))
    x = torch.as_tensor(x, device=cuda)
    before = radix_probe.LAUNCHES
    got = radix_probe.dynstore_run(iters, offs, x)
    assert radix_probe.LAUNCHES == before + 1
    assert torch.equal(got, radix_probe.dynstore_reference(iters, offs, x))


def test_dynstore_kernel_misaligned_x(cuda):
    offs, x = (torch.as_tensor(a, device=cuda) for a in
               radix_probe.dynstore_inputs(np.random.default_rng(5)))
    buf = torch.empty(x.numel() + 1, dtype=torch.int32, device=cuda)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    assert view.data_ptr() % 16 != 0
    assert torch.equal(radix_probe.dynstore_run(2, offs, view),
                       radix_probe.dynstore_reference(2, offs, x))


@pytest.mark.parametrize("iters", [1, 2, 5, 32])
def test_dynstore_kernel_vs_plain(cuda, iters):
    offs, x = (torch.as_tensor(a, device=cuda) for a in
               radix_probe.dynstore_inputs(np.random.default_rng(5)))
    before = radix_probe.LAUNCHES
    got = radix_probe.dynstore_run(iters, offs, x)
    assert radix_probe.LAUNCHES == before + 1
    want = radix_probe.dynstore_reference(iters, offs, x)
    assert torch.equal(got, want)
    assert (got == radix_probe.INT32_MIN).all(dim=1).any(), "test premise"


def _pack_vs_twin(key, thr, ratio=None):
    before = counter("k2.launches")
    out = compact.pack_survivors(key, thr, ratio)
    assert counter("k2.launches") == before + 1
    ref = compact.pack_survivors_reference(key, thr, ratio)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b)
    return out


@pytest.mark.parametrize("total", [1, 3, 4097, (1 << 20) + 77])
def test_pack_kernel_misaligned_view(rng, cuda, total):
    """A view one lane into its buffer is not 16-byte aligned, and the
    total is no multiple of 4: scalar head and tail."""
    buf = torch.as_tensor(rng.integers(-100, 100, total + 1).astype(np.int32),
                          device=cuda)
    key = buf[1:]
    assert key.data_ptr() % 16 != 0 and key.is_contiguous()
    for thr in (0, 99, -101):
        _pack_vs_twin(key, torch.tensor(thr, dtype=torch.int32, device=cuda),
                      ratio=1)
        _pack_vs_twin(key, torch.tensor(thr, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("survivors", ["zero", "capacity", "capacity+1"])
def test_pack_kernel_count_at_the_edges(rng, cuda, survivors):
    total = (1 << 18) + 13
    capacity = total // compact.PACK_RATIO
    count = {"zero": 0, "capacity": capacity,
             "capacity+1": capacity + 1}[survivors]
    key = np.full(total, 1000, np.int32)
    lanes = rng.choice(total, count, replace=False)
    key[lanes] = rng.integers(-50, 50, count)
    out = _pack_vs_twin(torch.as_tensor(key, device=cuda),
                        torch.tensor(50, dtype=torch.int32, device=cuda))
    assert int(out[2]) == count
    live = min(count, capacity)
    assert torch.equal(out[1][:live].cpu(),
                       torch.as_tensor(np.sort(lanes)[:live], dtype=torch.int32))


def test_pack_kernel_back_to_back(rng, cuda):
    """Two calls on one stream with no sync between: each starts from a
    fresh look-back state."""
    total = (1 << 22) + 5
    keys = [torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, total)
                            .astype(np.int32), device=cuda) for _ in range(2)]
    thrs = [torch.tensor(t, dtype=torch.int32, device=cuda)
            for t in (-(1 << 30), 1 << 29)]
    outs = [compact.pack_survivors(k, t) for k, t in zip(keys, thrs)]
    outs.append(compact.pack_survivors(keys[0], thrs[0]))
    for (k, t), out in zip(list(zip(keys, thrs)) + [(keys[0], thrs[0])],
                           outs):
        for a, b in zip(out, compact.pack_survivors_reference(k, t)):
            assert torch.equal(a, b)


def test_pack_kernel_ratio_1_everything_survives(rng, cuda):
    total = (1 << 20) + 77
    key = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, total)
                          .astype(np.int32), device=cuda)
    thr = torch.tensor((1 << 31) - 1, dtype=torch.int32, device=cuda)
    out = compact.pack_survivors(key, thr, ratio=1)
    ref = compact.pack_survivors_reference(key, thr, ratio=1)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert int(out[2]) == total and torch.equal(out[0], key)
    assert torch.equal(out[1].long(), torch.arange(total, device=cuda))


@pytest.mark.parametrize("fused", [True, False])
def test_harness_cuda_matches_cpu(cuda, monkeypatch, fused):
    """The experiment harness on the card against the same sweep on the
    CPU: rows equal except the times; precision and recall through the
    counts they are made of, equal up to the pairs tied at the k-th score.
    Device memory after each batch's cache clear does not grow."""
    from linkpred_tpu_torch.bench import harness
    from linkpred_tpu_torch.bench.synth import planted_partition_graph

    g = planted_partition_graph(6, 22, p_in=0.5, p_out=0.01, seed=1)
    record = {"ties": [], "counts": [], "mem": []}
    multi, single, common = (harness.predict_links_multi,
                             harness.predict_links, harness.common_pair_count)

    def ties(res, k):
        if not len(res) or len(res) < k:
            return 0
        return int(np.count_nonzero(res.score <= res.score[-1] * (1 + 1e-5)))

    def rec_multi(y, metrics, **kw):
        out = multi(y, metrics, **kw)
        record["ties"] += [ties(out[m], kw["options"].max_edges)
                           for m in metrics]
        return out

    def rec_single(y, metric, **kw):
        out = single(y, metric=metric, **kw)
        record["ties"].append(ties(out, kw["options"].max_edges))
        return out

    def rec_common(a, b):
        c = common(a, b)
        record["counts"].append((c, a.shape[0], b.shape[0]))
        return c

    class Cache(harness.PlanCache):
        def clear(self):
            super().clear()
            record["mem"].append(torch.cuda.memory_allocated(cuda))

    monkeypatch.setattr(harness, "predict_links_multi", rec_multi)
    monkeypatch.setattr(harness, "predict_links", rec_single)
    monkeypatch.setattr(harness, "common_pair_count", rec_common)
    monkeypatch.setattr(harness, "PlanCache", Cache)
    cfg = dict(repeat_batch=1, repeat_method=1, deletions_begin=0.05,
               deletions_end=0.1, deletions_step=2.0, metrics=tuple(lt.METRICS),
               degrees=(0, 64), seed=3, cap=1 << 14, fused_metrics=fused)
    runs = {}
    for dev in ("cuda", "cpu"):
        start = len(record["counts"])
        rows = harness.run_experiment(
            g, harness.ExperimentConfig(device=dev, **cfg), lambda _: None)
        runs[dev] = (rows, record["counts"][start:], record["ties"][start:])
    (got, c_got, t_got), (want, c_want, t_want) = runs["cuda"], runs["cpu"]
    assert len(got) == len(want) == 2 * 2 * len(lt.METRICS)
    for g_, w, cg, cw, tg, tw in zip(got, want, c_got, c_want, t_got, t_want):
        for f in ("batch_deletions_fraction", "batch_insertions_fraction",
                  "technique"):
            assert g_[f] == w[f]
        assert g_["num_threads"] == torch.cuda.device_count()
        assert cg[1:] == cw[1:]
        assert abs(cg[0] - cw[0]) <= 2 * max(tg, tw), (g_["technique"], cg,
                                                      cw, tg, tw)
    assert max(r["recall"] for r in got) > 0.1
    mem = record["mem"][:2]            # the cuda run's two batches
    assert len(mem) == 2 and mem[1] <= mem[0], mem


def test_bench_row_on_the_card(cuda, monkeypatch, capsys, tmp_path):
    """``bench.run.main()`` on the card at RMAT-12: bench.py's keys, the
    model bytes of the plan, K1 launched, the median inside its spread,
    the card's peak and a fraction of it in (0, 1.05]."""
    import json

    from linkpred_tpu_torch.bench import run
    from linkpred_tpu_torch.utils import roofline

    for k, v in dict(BENCH_SCALE="12", BENCH_SAMPLES="3", BENCH_REPEAT="2",
                     BENCH_CACHE_DIR=str(tmp_path)).items():
        monkeypatch.setenv(k, v)
    for k in ("BENCH_DEVICE", "BENCH_KEY64", "BENCH_CAP", "BENCH_DEG",
              "BENCH_METRIC"):
        monkeypatch.delenv(k, raising=False)
    before = counter("k1.launches")
    assert run.main() == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert counter("k1.launches") > before
    peak = roofline.device_peak_gbps(cuda)
    keys = {"metric", "value", "unit", "vs_baseline", "engine", "samples",
            "rate_min", "rate_max", "hbm_model_bytes",
            "achieved_gbps_min_model"}
    assert set(row) == keys | ({"hbm_peak_gbps", "frac_of_peak"} if peak
                               else set())
    assert row["metric"] == "lhub_jaccard_coefficient_deg64_rmat12_rate"
    assert row["engine"] == "key64" and row["samples"] == 3
    assert 0 < row["rate_min"] <= row["value"] <= row["rate_max"]
    y, _ = run.bench_graph(12, str(tmp_path))
    plan = build_plan(y, 64, device=cuda)
    assert row["hbm_model_bytes"] == roofline.packed_pass_min_bytes(
        int(plan.tile_slot_start[-1]), deg16=plan.deg16)
    if peak:
        assert row["hbm_peak_gbps"] == peak
        assert 0 < row["frac_of_peak"] <= 1.05


def test_all_models_cuda_matches_cpu(cuda):
    """The model zoo on the card against the same zoo on the CPU, on a
    132-vertex planted graph (degrees 12-24, so threshold 16 keeps some
    intermediates): results equal up to ties at the k-th score, names
    tagged ``Cuda``."""
    from linkpred_tpu_torch.bench.synth import planted_partition_graph
    from linkpred_tpu_torch.models import all_models

    g = planted_partition_graph(6, 22, p_in=0.5, p_out=0.01, seed=1)
    got = all_models(degrees=(0, 16, 64), device="cuda")
    want = all_models(degrees=(0, 16, 64), device="cpu")
    before = counter("k1.launches")
    for p, q in zip(got, want):
        assert p.name == q.name and p.name.endswith(f"Cuda{p.min_degree1}")
        p.cap = q.cap = 1 << 12
        _same_results({p.metric: p.predict(g, max_edges=80)},
                      {q.metric: q.predict(g, max_edges=80)})
    assert counter("k1.launches") > before


def test_edge_slot_map_on_the_card(rng, cuda):
    """The edge tile's slot map on the card equals the CPU's on every lane
    of every tile of an IHub edge plan (zero-work rows, killers)."""
    from linkpred_tpu_torch.ops.transform import remove_self_loops, symmetrize

    src, dst = rng.integers(0, 300, 1500), rng.integers(0, 300, 1500)
    g = remove_self_loops(symmetrize(lt.from_edges(src, dst, n=300)))
    p = build_plan(g, 0, 1024, slot_budget=0, device="cpu")
    assert not p.packed
    ts = p.tile_start
    card, cpu = p.device_stream(cuda), p.device_stream("cpu")
    iota = torch.arange(p.cap, dtype=torch.int32)
    for t in range(len(ts) - 1):
        s, e = int(ts[t]), int(ts[t + 1])
        if s == e:
            continue
        got = scoring._slot_map(card[0], s, e, iota.to(cuda))
        want = scoring._slot_map(cpu[0], s, e, iota)
        assert torch.equal(got[3].cpu(), want[3])
        assert torch.equal(got[2].cpu(), want[2])


def test_host_helpers_on_the_card(rng, cuda):
    """BFS, the top-k helpers, xorshift32, scatter_or and the device
    deletions on the card against the port's CPU path (the deletions by
    their contract: the two devices draw differently)."""
    from linkpred_tpu_torch.ops import batch, topk, traverse, vector
    from linkpred_tpu_torch.ops.transform import remove_self_loops, symmetrize
    from linkpred_tpu_torch.utils import random as xr

    src, dst = rng.integers(0, 500, 900), rng.integers(0, 500, 900)
    g = remove_self_loops(symmetrize(lt.from_edges(src, dst, n=500)))
    for start in (0, 250, rng.random(500) < 0.02):
        assert np.array_equal(traverse.bfs_levels(g, start, device=cuda),
                              traverse.bfs_levels(g, start, device="cpu"))
    s = (rng.integers(0, 50, 5000) / 8).astype(np.float32)
    s[rng.random(5000) < 0.1] = -np.inf
    u, v = (rng.integers(0, 999, 5000).astype(np.int32) for _ in range(2))
    args = [torch.as_tensor(a) for a in (s, u, v)]
    got = topk.topk_from_candidates(*(a.to(cuda) for a in args), 700)
    want = topk.topk_from_candidates(*args, 700)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    merged = topk.topk_merge(got, topk.topk_init(700, device=cuda))
    assert torch.equal(merged.scores.cpu(), want.scores)
    states = rng.integers(0, 1 << 32, 1 << 16, dtype=np.int64)
    assert torch.equal(xr.xorshift32_step(states, device=cuda).cpu(),
                       xr.xorshift32_step(states, device="cpu"))
    ids = rng.integers(0, 100, 20000).astype(np.int32)
    x = rng.integers(-2 ** 31, 2 ** 31, 20000).astype(np.int32)
    a = np.zeros(100, np.int32)
    cpu_args = [torch.as_tensor(t) for t in (a, ids, x)]
    assert torch.equal(
        vector.scatter_or(*(t.to(cuda) for t in cpu_args)).cpu(),
        vector.scatter_or(*cpu_args))
    gen = torch.Generator(device=cuda).manual_seed(3)
    pairs, valid = batch.generate_edge_deletions_device(gen, g, 4000,
                                                        device=cuda)
    p, ok = pairs.cpu().numpy(), valid.cpu().numpy()
    deg = np.asarray(g.degrees)
    assert np.array_equal(ok, deg[p[:, 0]] > 0)
    assert all(g.has_edge(a, b) for a, b in p[ok])


def test_gnn_on_the_card_matches_cpu(cuda):
    """The GraphSAGE encoder on the card against the same parameters on
    the CPU (rtol 1e-5, atol 1e-6: the card's index_add adds in another
    order), a few training steps on the card, full-graph and sampled, and
    the GNN predictor's candidate pass through K1."""
    import copy

    from linkpred_tpu_torch.bench.synth import planted_partition_graph
    from linkpred_tpu_torch.models import gnn

    g = planted_partition_graph(6, 22, p_in=0.5, p_out=0.01, seed=1)
    for fanouts in (None, (4, 4)):
        params, feats, loss = gnn.train_sage(g, steps=5, hidden=16,
                                             out_dim=8, fanouts=fanouts,
                                             device=cuda)
        assert np.isfinite(loss) and params.l1.w.device.type == "cuda"
    cpu_params = copy.deepcopy(params).to("cpu")
    embs = []
    for dev, p in ((cuda, params), (torch.device("cpu"), cpu_params)):
        esrc, edst, deg, _, _ = gnn._graph_tensors(g, dev)
        with torch.no_grad():
            embs.append(gnn.sage_encode(p, torch.as_tensor(feats, device=dev),
                                        esrc, edst, deg).cpu())
    torch.testing.assert_close(embs[0], embs[1], rtol=1e-5, atol=1e-6)
    before = counter("k1.launches")
    res = gnn.GNNPredictor(params, feats, device="cuda").predict(
        g, max_edges=50)
    assert len(res) == 50 and counter("k1.launches") > before
    # a CPU predictor encodes with a copy: the card's model stays put
    on_cpu = gnn.GNNPredictor(params, feats, device="cpu").predict(
        g, max_edges=50)
    assert params.l1.w.device.type == "cuda"
    np.testing.assert_allclose(on_cpu.score, res.score, rtol=1e-5,
                               atol=1e-6)


def test_world_size_1_nccl_pass(rng, cuda, tmp_path):
    """A one-rank NCCL process group: ``predict_links(mesh=)`` on the card
    equals the plain pass (the same scores, the same pairs above the
    k-th score)."""
    import torch.distributed as dist

    from linkpred_tpu_torch.ops.transform import remove_self_loops, symmetrize
    from linkpred_tpu_torch.parallel import distributed, mesh as pmesh, sim

    src, dst = rng.integers(0, 300, 1500), rng.integers(0, 300, 1500)
    g = remove_self_loops(symmetrize(lt.from_edges(src, dst, n=300)))
    distributed.init_distributed(f"file://{tmp_path}/store", 1, 0,
                                 backend="nccl")
    try:
        m = pmesh.make_mesh(1)
        assert m.backend == "nccl" and m.device.type == "cuda"
        for kw in (dict(min_degree1=8), dict(min_degree1=0, cap=1024)):
            opts = lt.PredictOptions(max_edges=300)
            got = lt.predict_links_multi(g, ["jaccard", "aa"], mesh=m,
                                         options=opts, **kw)
            want = lt.predict_links_multi(g, ["jaccard", "aa"],
                                          options=opts, device=cuda, **kw)
            for name in got:
                sim.same_result(got[name], want[name], name)
    finally:
        dist.destroy_process_group()


# ------------------------------------- the merge of the winners on the card

def _winners(rng, device, passes, metrics):
    """Each pass's winners ``TopK [metrics, k]``: scores from a pool with
    ties, +-inf, NaN and both zeros; random pairs."""
    pool = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 0.5, 1.0, 2.0,
                     -1.0], dtype=np.float32)
    out = []
    for k in passes:
        s = rng.choice(pool, (metrics, k))
        u, v = rng.integers(0, 1 << 30, (2, metrics, k)).astype(np.int32)
        out.append(TopK(*(torch.as_tensor(a, device=device)
                          for a in (s, u, v))))
    return out


@pytest.mark.parametrize("passes,max_edges", [((3000, 1700, 40), 2500),
                                              ((1 << 21, 1 << 20), 1 << 21)])
def test_merge_on_the_card_matches_the_cpu(rng, cuda, passes, max_edges):
    """The card's merge gives the CPU merge's rows bit for bit (the CPU
    merge is held against the host NumPy merge in test_torch_merge.py),
    the host scorer's rows included."""
    names = ("common_neighbors", "jaccard_coefficient", "adamic_adar")
    tops = _winners(rng, cuda, passes, len(names))
    host = {names[1]: (rng.choice([1.0, np.inf], 99).astype(np.float32),
                       *rng.integers(0, 99, (2, 99)).astype(np.int32))}
    cpu = [TopK(*(x.cpu() for x in t)) for t in tops]
    want, want_n = api._merge_winners(cpu, host, names, max_edges,
                                      torch.device("cpu"))
    got, got_n = api._merge_winners(tops, host, names, max_edges, cuda)
    assert got.is_cuda and got_n == want_n
    assert torch.equal(got.cpu(), want)


def test_merge_bytes_within_the_price(rng, cuda):
    """What the merge allocates stays within ``device_bytes``' item: rows
    x ``MERGE_BYTES_PER_ROW`` and every metric's merged rows twice."""
    passes, metrics, max_edges = (1 << 22, 1 << 22, 1 << 16), 2, 1 << 22
    tops = _winners(rng, cuda, passes, metrics)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    api._merge_winners(tops, {}, ("cn", "aa"), max_edges, cuda)
    torch.cuda.synchronize()
    rows = sum(passes)
    priced = (rows * api.MERGE_BYTES_PER_ROW
              + 2 * metrics * min(max_edges, rows) * 12)
    assert torch.cuda.max_memory_allocated() - before <= priced


def test_results_on_the_card_do_not_share_memory_across_calls(rng, cuda):
    """The merged rows come back into page-locked blocks that PyTorch's
    host allocator hands out again only once their arrays are gone: a
    later call neither reuses nor writes an earlier call's arrays."""
    n, m = 300, 1800
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    g = lt.from_edges(np.concatenate([src, dst]), np.concatenate([dst, src]),
                      n=n)
    call = lambda: lt.predict_links_multi(  # noqa: E731
        g, ("cn", "aa"), min_degree1=0, cap=1024, device=cuda,
        options=lt.PredictOptions(max_edges=500))
    first = call()
    kept = {name: (r.u.copy(), r.v.copy(), r.score.copy())
            for name, r in first.items()}
    for _ in range(3):
        later = call()
        for name, r in first.items():
            for a, b in zip((r.u, r.v, r.score), kept[name]):
                np.testing.assert_array_equal(a, b)
            for a in (r.u, r.v, r.score):
                for b in (later[name].u, later[name].v, later[name].score):
                    assert not np.shares_memory(a, b)
        del later


@pytest.mark.parametrize("metrics", [("jaccard_coefficient",),
                                     tuple(lt.METRICS)], ids=["one", "nine"])
def test_a_second_call_on_the_same_plan_skips_the_warm_up(cuda, metrics):
    """On the card a second call on the same plan skips the untimed
    warm-up pass (one count of ``api.warmup_skips``, half the first call's
    K1 launches) and gives the first call's rows bit for bit."""
    from linkpred_tpu_torch.bench.synth import rmat_graph

    g = rmat_graph(12, seed=5)
    p = build_plan(g, 0, 1 << 12, device=cuda)
    call = lambda: lt.predict_links_multi(  # noqa: E731
        g, metrics, min_degree1=0, plan=p, device=cuda,
        options=lt.PredictOptions(max_edges=5000))
    skips, launches = counter("api.warmup_skips"), counter("k1.launches")
    first = call()
    assert counter("api.warmup_skips") == skips
    once = (counter("k1.launches") - launches) // 2
    skips, launches = counter("api.warmup_skips"), counter("k1.launches")
    again = call()
    assert counter("api.warmup_skips") == skips + 1
    assert counter("k1.launches") - launches == once > 0
    for name in first:
        assert len(first[name]) > 0
        for f in ("u", "v", "score"):
            np.testing.assert_array_equal(getattr(again[name], f),
                                          getattr(first[name], f))
