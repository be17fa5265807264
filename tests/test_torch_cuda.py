"""The port on a CUDA card: each kernel against its plain twin on the same
card tensors, and ``predict_links_multi`` on the card against the CPU.

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
from linkpred_tpu_torch.kernels import _build
from linkpred_tpu_torch.ops import compact
from linkpred_tpu_torch.ops import fused_tail as ft
from linkpred_tpu_torch.ops.topk import desc_key_score
from linkpred_tpu_torch.predict import scoring

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
    assert lib.lp_fused_tail_scratch_bytes(1 << 20) > 0
    assert lib.lp_pack_scratch_bytes(1 << 24) > 0


def _tail_inputs(rng, cap, w_bits, run_len, wide, n_wt, device):
    """A sorted tile: (w, u) pairs repeated ~run_len times, degrees constant
    per pair, pads after ~95% real lanes."""
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
    t = lambda a: torch.as_tensor(np.asarray(a).astype(  # noqa: E731
        np.float32 if np.asarray(a).dtype.kind == "f" else np.int32),
        device=device)
    return t(w), t(u), [t(d) for d in degs], [t(x) for x in wts]


@pytest.mark.parametrize("cap,names,wide,min_score,maxf2,run_len", [
    (1 << 16, UNWEIGHTED, False, 0.0, 0, 4),
    (1 << 16, UNWEIGHTED, True, 0.0, 0, 4),
    (100_003, ["jaccard_coefficient", "adamic_adar", "resource_allocation"],
     False, 0.0, 0, 6),
    (1 << 16, ["common_neighbors", "adamic_adar"], False, 0.0, 0, 5000),
    (1 << 16, ["jaccard_coefficient"], False, 0.01, 0, 4),
    (1 << 15, ["hub_promoted", "resource_allocation"], False, 0.0, 2, 4),
])
def test_fused_tail_kernel_vs_twin(rng, cuda, cap, names, wide, min_score,
                                   maxf2, run_len):
    mets = [lt.METRICS[m] for m in names]
    n_wt = sum(m.needs_weight for m in mets)
    hi, lo, degs, wts = _tail_inputs(rng, cap, 20, run_len, wide, n_wt, cuda)
    kw = dict(metrics=mets, w_bits=20, n=1 << 20, maxf2=maxf2)
    before = ft.LAUNCHES
    kk, ku, kv = ft.fused_tail(hi, lo, degs, wts, min_score, **kw)
    assert ft.LAUNCHES == before + 1
    rk, ru, rv = ft.fused_tail_reference(hi, lo, degs, wts, min_score, **kw)
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
    before = compact.LAUNCHES
    out = compact.pack_survivors(key, thr)
    assert compact.LAUNCHES == before + 1
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
