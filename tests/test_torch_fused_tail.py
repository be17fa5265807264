"""K1, the fused post-sort tail: the port's plain twin against the JAX
package's Pallas ``fused_tail`` (interpret mode on the CPU) and against the
reference's XLA tail (``_keyed_sort_reduce`` with ``fused=False``).  The
CUDA kernel against the twin is in test_torch_cuda.py.

Tolerances: keys, ku and kw bit-equal for the unweighted metrics, except
Salton's scores, within 2 ulp of the reference (its XLA rewrites
a / sqrt(b) into a * rsqrt(b); the port divides by the correctly rounded
root).  AA/RA sums are added in another order by XLA, Pallas and torch, and
the AA weights come from another float32 log: rtol 1e-5, and identical
invalid lanes.  Keys of invalid lanes are bit-equal everywhere.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from linkpred_tpu.ops import fused_tail as ref_ft
from linkpred_tpu.predict import metrics as ref_metrics
from linkpred_tpu.predict import scoring as ref_scoring
from linkpred_tpu_torch.ops import fused_tail as ft
from linkpred_tpu_torch.predict import metrics as port_metrics
from linkpred_tpu_torch.predict import scoring as port_scoring

UNWEIGHTED = [n for n, m in port_metrics.METRICS.items()
              if not m.needs_weight]
SALTON = "salton_cosine_similarity"


def _pairs(rng, cap, w_bits, fill, run_len, wide):
    """Unsorted lanes: ~cap*fill real slots drawn from cap*fill/run_len
    distinct (w, u) pairs, pads after them."""
    n_real = int(cap * fill)
    nv = 1 << w_bits
    npair = max(n_real // run_len, 1)
    pid = rng.integers(0, npair, n_real)
    w = rng.integers(0, nv, npair)[pid]
    u = rng.integers(0, nv, npair)[pid]
    dmax = (1 << 20) if wide else (1 << 16)
    du = rng.integers(1, dmax, npair)[pid]
    dw = rng.integers(1, dmax, npair)[pid]
    pad = cap - n_real
    iota = np.arange(cap)
    w = np.concatenate([w, (nv | (iota[n_real:] & 1023))])
    u = np.concatenate([u, np.zeros(pad, np.int64)])
    du = np.concatenate([du, rng.integers(1, dmax, pad)])
    dw = np.concatenate([dw, rng.integers(1, dmax, pad)])
    wts = [rng.random(cap).astype(np.float32) + np.float32(0.01)
           for _ in range(2)]
    for x in wts:
        x[n_real:] = 0.0
    return w, u, du, dw, wts


def _sorted_stream(rng, cap, w_bits, fill=0.9, run_len=6, wide=False):
    w, u, du, dw, wts = _pairs(rng, cap, w_bits, fill, run_len, wide)
    order = np.lexsort((u, w))
    w, u, du, dw = w[order], u[order], du[order], dw[order]
    wts = [x[order] for x in wts]
    if wide:
        degs = [du.astype(np.int32), dw.astype(np.int32)]
    else:
        degs = [((du << 16) | dw).astype(np.uint32).view(np.int32)]
    return w.astype(np.int32), u.astype(np.int32), degs, wts


def _decode(keys_u32):
    s = np.asarray(ref_scoring._desc_key_score(jnp.asarray(keys_u32)))
    return np.where(np.isnan(s), -np.inf, s)


def _to_u32(port_keys):
    return port_keys.view(np.uint32) ^ np.uint32(0x80000000)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _assert_scores(got, want, name):
    """``got``/``want``: float32 scores of one metric on the same lanes."""
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    if port_metrics.METRICS[name].needs_weight:
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)
    elif name == SALTON:
        assert _ulps(got[fin], want[fin]).max(initial=0) <= 2
    else:
        np.testing.assert_array_equal(got, want)


def _assert_keys(port_keys, ref_keys_u32, names):
    got = _to_u32(port_keys)
    for i, name in enumerate(names):
        want = np.asarray(ref_keys_u32[i])
        if port_metrics.METRICS[name].needs_weight or name == SALTON:
            _assert_scores(_decode(got[i]), _decode(want), name)
            inv = np.isneginf(_decode(want))
            np.testing.assert_array_equal(got[i][inv], want[inv])
        else:
            np.testing.assert_array_equal(got[i], want)


CASES = {
    # name: (cap, w_bits, metrics, wide, min_score, maxf2, fill, run_len)
    "deg16_jaccard_256": (256, 10, ("jaccard_coefficient",), False, 0.0, 0,
                          0.9, 6),
    "deg16_jaccard_4096": (4096, 12, ("jaccard_coefficient",), False, 0.0, 0,
                           0.9, 6),
    "deg16_all7_min_score": (2048, 11, tuple(UNWEIGHTED), False, 0.001, 0,
                             1.0, 3),
    "wide_all7": (2048, 12, tuple(UNWEIGHTED), True, 0.0, 0, 0.8, 4),
    "aa_ra_mixed": (4096, 12, ("jaccard_coefficient", "adamic_adar",
                               "common_neighbors", "resource_allocation"),
                    False, 0.0, 0, 0.9, 8),
    "maxf2": (1024, 10, ("hub_promoted", "adamic_adar"), False, 0.0, 2, 0.9,
              5),
    "long_runs_cross_rows": (4096, 12, ("common_neighbors", "adamic_adar"),
                             False, 0.0, 0, 1.0, 700),
    "wide_aa_ra": (1024, 11, ("adamic_adar", "resource_allocation"), True,
                   0.0, 0, 0.95, 10),
}


def _inputs(rng, case):
    cap, w_bits, names, wide, min_score, maxf2, fill, run_len = CASES[case]
    hi, lo, degs, wts = _sorted_stream(rng, cap, w_bits, fill, run_len, wide)
    names = list(names)
    n_wt = sum(port_metrics.METRICS[n].needs_weight for n in names)
    return dict(hi=hi, lo=lo, degs=degs, wts=wts[:n_wt], names=names,
                w_bits=w_bits, n=1 << w_bits, min_score=min_score,
                maxf2=maxf2)


def _port(x, device="cpu", fn=ft.fused_tail):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    out = fn(t(x["hi"]), t(x["lo"]), [t(d) for d in x["degs"]],
             [t(w) for w in x["wts"]], x["min_score"],
             metrics=[port_metrics.METRICS[m] for m in x["names"]],
             w_bits=x["w_bits"], n=x["n"], maxf2=x["maxf2"])
    return [o.cpu().numpy() for o in out]


def _ref(x):
    hi, lo = jnp.asarray(x["hi"]), jnp.asarray(x["lo"])
    neq = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    out = ref_ft.fused_tail(
        hi, lo, tuple(jnp.asarray(d) for d in x["degs"]),
        [jnp.asarray(w) for w in x["wts"]], neq, jnp.float32(x["min_score"]),
        metrics=tuple(ref_metrics.METRICS[m] for m in x["names"]),
        w_bits=x["w_bits"], n=x["n"], maxf2=x["maxf2"])
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("case", list(CASES))
def test_twin_vs_pallas_fused_tail(rng, case):
    x = _inputs(rng, case)
    pk, pu, pv = _port(x)
    rk, ru, rv = _ref(x)
    assert pk.dtype == np.int32 and pk.shape == rk.shape
    _assert_keys(pk, rk, x["names"])
    np.testing.assert_array_equal(pu, ru)
    np.testing.assert_array_equal(pv, rv)
    if case == "long_runs_cross_rows":
        runs = np.diff(np.flatnonzero(np.diff(x["hi"]) | np.diff(x["lo"])))
        assert runs.max() > 256, "test premise: runs span several rows"


@pytest.mark.parametrize("lanes", ["one_run", "all_distinct"])
def test_twin_degenerate_runs(rng, lanes):
    cap, w_bits = 1024, 10
    hi = (np.full(cap, 7, np.int32) if lanes == "one_run"
          else np.arange(cap, dtype=np.int32))
    x = dict(hi=hi, lo=np.zeros(cap, np.int32),
             degs=[(rng.integers(1, 1 << 16, cap) << 16
                    | rng.integers(1, 1 << 16, cap)).astype(np.uint32)
                   .view(np.int32)],
             wts=[rng.random(cap).astype(np.float32)],
             names=["jaccard_coefficient", "resource_allocation"],
             w_bits=w_bits, n=1 << w_bits, min_score=0.0, maxf2=0)
    pk, pu, pv = _port(x)
    rk, ru, rv = _ref(x)
    _assert_keys(pk, rk, x["names"])
    np.testing.assert_array_equal(pu, ru)
    np.testing.assert_array_equal(pv, rv)


@pytest.mark.parametrize("case", ["deg16_all7_min_score", "aa_ra_mixed",
                                  "wide_all7", "maxf2"])
def test_twin_vs_reference_xla_tail(rng, case):
    """The whole keyed reduce (sort + tail) against the reference's key64
    XLA tail on the same unsorted lanes."""
    cap, w_bits, names, wide, min_score, maxf2, fill, run_len = CASES[case]
    w, u, du, dw, wts = _pairs(rng, cap, w_bits, fill, run_len, wide)
    perm = rng.permutation(cap)
    w, u, du, dw = w[perm], u[perm], du[perm], dw[perm]
    n_wt = sum(port_metrics.METRICS[n].needs_weight for n in names)
    wts = [x[perm] for x in wts[:n_wt]]
    if wide:
        udeg, wdeg = du.astype(np.int32), dw.astype(np.int32)
    else:
        udeg = ((du << 16) | dw).astype(np.uint32).view(np.int32)
        wdeg = udeg
    w, u = w.astype(np.int32), u.astype(np.int32)
    rmets = tuple(ref_metrics.METRICS[m] for m in names)

    @jax.jit
    def ref_reduce(w, u, udeg, wdeg, wts):
        return ref_scoring._keyed_sort_reduce(
            w, u, udeg, wdeg, wts, [m for m in rmets if m.needs_weight],
            rmets, w_bits=w_bits, n=1 << w_bits, maxf2=maxf2,
            min_score=jnp.float32(min_score), deg16=not wide, killers=False,
            predpacked=not wide, key64=True, fused=False)

    scores, rku, rkw = ref_reduce(
        jnp.asarray(w), jnp.asarray(u), jnp.asarray(udeg), jnp.asarray(wdeg),
        [jnp.asarray(x) for x in wts])
    t = torch.from_numpy
    pk, pku, pkw = port_scoring._keyed_sort_reduce(
        t(w), t(u), t(udeg), t(wdeg), [t(x) for x in wts],
        [port_metrics.METRICS[m] for m in names], w_bits=w_bits,
        n=1 << w_bits, maxf2=maxf2, min_score=min_score, deg16=not wide)
    np.testing.assert_array_equal(pku.numpy(), np.asarray(rku))
    np.testing.assert_array_equal(pkw.numpy(), np.asarray(rkw))
    got = _to_u32(pk.numpy())
    for i, name in enumerate(names):
        _assert_scores(_decode(got[i]), np.asarray(scores[i]), name)


def test_wrapper_refuses_other_devices():
    """No silent fallback: only CPU tensors take the twin."""
    x = torch.zeros(256, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ft.fused_tail(x, x, [x], [], 0.0,
                      metrics=[port_metrics.METRICS["common_neighbors"]],
                      w_bits=8, n=256)

