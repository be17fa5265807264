"""K1, the fused post-sort tail: the port's plain twin against the JAX
package's Pallas ``fused_tail`` (interpret mode on the CPU) and against the
reference's XLA tail (``_keyed_sort_reduce`` with ``fused=False``), in both
branches: the packed stream's clean lanes and the edge stream's killer
lanes (``lo = u << 1 | real``).  The CUDA kernel against the twin is in
test_torch_cuda.py; here a numpy model of the kernel's decomposition (tiles,
aggregates, the look-back) is held against the twin.

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


def _killer_lo(rng, w, u, wts, fill, kill):
    """Edge-stream payloads ``u << 1 | real``: each (w, u) pair of the real
    lanes has, with probability ``kill`` each, one killer lane or only
    killer lanes; killer lanes carry weight 0.  Pads get random flags."""
    cap = w.shape[0]
    n_real = int(cap * fill)
    key = w[:n_real] * (1 << 31) + u[:n_real]
    _, first, pid = np.unique(key, return_index=True, return_inverse=True)
    kind = rng.choice(3, first.shape[0], p=[1 - 2 * kill, kill, kill])
    real = np.ones(cap, bool)
    real[first[kind == 1]] = False                # one killer lane
    real[:n_real][kind[pid] == 2] = False         # killer-only runs
    real[n_real:] = rng.random(cap - n_real) < 0.5
    for x in wts:
        x[:n_real][~real[:n_real]] = 0.0
    return (u << 1) | real


def _sorted_stream(rng, cap, w_bits, fill=0.9, run_len=6, wide=False,
                   kill=0.0):
    w, u, du, dw, wts = _pairs(rng, cap, w_bits, fill, run_len, wide)
    if kill:
        u = _killer_lo(rng, w, u, wts, fill, kill)
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
    # name: (cap, w_bits, metrics, wide, min_score, maxf2, fill, run_len
    #        [, killer fraction])
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
    # the edge stream's killer branch
    "killers_deg16_jaccard": (4096, 12, ("jaccard_coefficient",), False,
                              0.0, 0, 0.9, 6, 0.2),
    "killers_wide_all7_min_score": (2048, 12, tuple(UNWEIGHTED), True,
                                    0.001, 0, 0.8, 4, 0.2),
    "killers_aa_ra_maxf2": (4096, 12, ("adamic_adar", "jaccard_coefficient",
                                       "resource_allocation"), False, 0.0,
                            2, 0.9, 8, 0.2),
    "killers_wide_aa_ra": (1024, 11, ("adamic_adar", "resource_allocation"),
                           True, 0.0, 0, 0.95, 10, 0.3),
    "killers_only_runs": (1024, 10, ("common_neighbors", "adamic_adar"),
                          False, 0.0, 0, 1.0, 5, 0.45),
    "killers_long_runs": (4096, 12, ("common_neighbors", "adamic_adar"),
                          False, 0.0, 0, 1.0, 700, 0.3),
}


def _inputs(rng, case):
    cap, w_bits, names, wide, min_score, maxf2, fill, run_len, *kill = \
        CASES[case]
    kill = kill[0] if kill else 0.0
    hi, lo, degs, wts = _sorted_stream(rng, cap, w_bits, fill, run_len, wide,
                                       kill)
    names = list(names)
    n_wt = sum(port_metrics.METRICS[n].needs_weight for n in names)
    return dict(hi=hi, lo=lo, degs=degs, wts=wts[:n_wt], names=names,
                w_bits=w_bits, n=1 << w_bits, min_score=min_score,
                maxf2=maxf2, killers=bool(kill))


def _port(x, device="cpu", fn=ft.fused_tail):
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    out = fn(t(x["hi"]), t(x["lo"]), [t(d) for d in x["degs"]],
             [t(w) for w in x["wts"]], x["min_score"],
             metrics=[port_metrics.METRICS[m] for m in x["names"]],
             w_bits=x["w_bits"], n=x["n"], maxf2=x["maxf2"],
             killers=x.get("killers", False))
    return [o.cpu().numpy() for o in out]


def _ref(x):
    killers = x.get("killers", False)
    hi, lo = jnp.asarray(x["hi"]), jnp.asarray(x["lo"])
    src = lo >> 1 if killers else lo
    neq = (hi[1:] != hi[:-1]) | (src[1:] != src[:-1])
    out = ref_ft.fused_tail(
        hi, lo, tuple(jnp.asarray(d) for d in x["degs"]),
        [jnp.asarray(w) for w in x["wts"]], neq, jnp.float32(x["min_score"]),
        metrics=tuple(ref_metrics.METRICS[m] for m in x["names"]),
        w_bits=x["w_bits"], n=x["n"], maxf2=x["maxf2"], killers=killers)
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
    if case.endswith("long_runs_cross_rows") or case == "killers_long_runs":
        runs = np.diff(np.flatnonzero(np.diff(x["hi"]) | np.diff(x["lo"])))
        assert runs.max() > 256, "test premise: runs span several rows"
    if x["killers"]:
        real = x["lo"] & 1
        ends = np.flatnonzero(np.diff(x["hi"]) | np.diff(x["lo"] >> 1))
        starts = np.concatenate([[0], ends + 1])
        rid = np.repeat(np.arange(len(starts)), np.diff(np.append(
            starts, len(real))))
        n_real = np.bincount(rid, weights=real)
        dead = real[starts] == 0
        # test premise: some runs are killed with real lanes in them, some
        # hold only killers; and the twin scores no dead run
        assert (dead & (n_real > 0)).any() and (n_real == 0).any()
        assert np.all(_decode(_to_u32(pk[0]))[dead[rid]] == -np.inf)


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
                                  "wide_all7", "maxf2",
                                  "killers_deg16_jaccard",
                                  "killers_wide_all7_min_score",
                                  "killers_aa_ra_maxf2", "killers_only_runs"])
def test_twin_vs_reference_xla_tail(rng, case):
    """The whole keyed reduce (sort + tail) against the reference's key64
    XLA tail on the same unsorted lanes.  Killer cases pack the deg16 pair
    before the sort, as the edge stream does (``predpacked=False``)."""
    cap, w_bits, names, wide, min_score, maxf2, fill, run_len, *kill = \
        CASES[case]
    killers = bool(kill)
    w, u, du, dw, wts = _pairs(rng, cap, w_bits, fill, run_len, wide)
    if killers:
        u = _killer_lo(rng, w, u, wts, fill, kill[0])
    perm = rng.permutation(cap)
    w, u, du, dw = w[perm], u[perm], du[perm], dw[perm]
    n_wt = sum(port_metrics.METRICS[n].needs_weight for n in names)
    wts = [x[perm] for x in wts[:n_wt]]
    predpacked = not wide and not killers
    if predpacked:
        udeg = ((du << 16) | dw).astype(np.uint32).view(np.int32)
        wdeg = udeg
    else:
        udeg, wdeg = du.astype(np.int32), dw.astype(np.int32)
    w, u = w.astype(np.int32), u.astype(np.int32)
    rmets = tuple(ref_metrics.METRICS[m] for m in names)

    @jax.jit
    def ref_reduce(w, u, udeg, wdeg, wts):
        return ref_scoring._keyed_sort_reduce(
            w, u, udeg, wdeg, wts, [m for m in rmets if m.needs_weight],
            rmets, w_bits=w_bits, n=1 << w_bits, maxf2=maxf2,
            min_score=jnp.float32(min_score), deg16=not wide,
            killers=killers, predpacked=predpacked, key64=True, fused=False)

    scores, rku, rkw = ref_reduce(
        jnp.asarray(w), jnp.asarray(u), jnp.asarray(udeg), jnp.asarray(wdeg),
        [jnp.asarray(x) for x in wts])
    t = torch.from_numpy
    pk, pku, pkw = port_scoring._keyed_sort_reduce(
        t(w), t(u), t(udeg), t(wdeg), [t(x) for x in wts],
        [port_metrics.METRICS[m] for m in names], w_bits=w_bits,
        n=1 << w_bits, maxf2=maxf2, min_score=min_score, deg16=not wide,
        killers=killers, predpacked=predpacked)
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


def test_pack_pair_sign_bit():
    """The edge stream packs the deg16 pair on the device: a deg(u) of
    2^15 or more sets the int32 sign bit, and the tail unpacks it
    unsigned."""
    du = torch.tensor([1, 32767, 32768, 40000, 65535], dtype=torch.int32)
    dw = torch.tensor([65535, 1, 7, 40000, 65535], dtype=torch.int32)
    got = port_scoring.pack_pair(du, dw)
    want = ((du.numpy().astype(np.uint32) << np.uint32(16))
            | dw.numpy().astype(np.uint32)).view(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)
    ud, wd = ft._unpack((got,))
    assert torch.equal(ud, du) and torch.equal(wd, dw)


def test_wrapper_refuses_cap_2_30():
    """The run start travels as ``start << 1 | alive`` in an int32, so the
    wrapper refuses 2^30 lanes before it looks at the device."""
    x = torch.empty(ft.MAX_CAP, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="run starts"):
        ft.fused_tail(x, x, [x], [], 0.0,
                      metrics=[port_metrics.METRICS["common_neighbors"]],
                      w_bits=8, n=256)


def _model_tail(x, tile, head, rng):
    """Test-only model, in numpy, of the CUDA kernel's decomposition
    (``kernels/csrc/fused_tail.cu``).  The lanes are cut into tiles of
    ``tile`` lanes, the first one ``head`` lanes short; each tile folds
    its aggregate carry (the last run start as ``start << 1 | alive``, and
    the weight sums since it); each tile looks back, in tile order, to the
    nearest predecessor that either has its inclusive carry visible (each
    one is, with probability 1/2 from ``rng``) or whose aggregate holds a
    run start, and folds forward from there; then it emits.  Scores come
    from the twin's ``score_keys``.  Returns ``(skeys, ku, kw)`` and the
    tiles' carries-in."""
    hi, lo, killers = x["hi"], x["lo"], x["killers"]
    cap = hi.shape[0]
    src = lo >> 1 if killers else lo
    new = (hi[1:] != hi[:-1]) | (src[1:] != src[:-1])
    start, end = np.r_[True, new], np.r_[new, True]
    alive = lo & 1 if killers else np.ones(cap, np.int64)
    wts = [np.asarray(w, np.float32) for w in x["wts"]]
    ident = (-1, tuple(np.float32(0) for _ in wts))

    def lane(i):
        return (int(i << 1 | alive[i]) if start[i] else -1,
                tuple(w[i] for w in wts))

    def combine(a, b):
        if b[0] >= 0:
            return b
        return a[0], tuple(np.float32(p + q) for p, q in zip(a[1], b[1]))

    n_tiles = -(-(cap + head) // tile)
    spans = [range(max(t * tile - head, 0), min((t + 1) * tile - head, cap))
             for t in range(n_tiles)]
    agg = []
    for span in spans:
        c = ident
        for i in span:
            c = combine(c, lane(i))
        agg.append(c)
    incl, carry_in = [], []
    for t in range(n_tiles):
        p, c = t - 1, ident
        while p >= 0:
            if rng.random() < 0.5:
                c = incl[p]
                break
            if agg[p][0] >= 0:
                c = agg[p]
                break
            p -= 1
        for q in range(p + 1, t):
            c = combine(c, agg[q])
        carry_in.append(c)
        incl.append(combine(c, agg[t]))
    ps = np.empty(cap, np.int64)
    sums = np.zeros((len(wts), cap), np.float32)
    for t, span in enumerate(spans):
        run = carry_in[t]
        for i in span:
            run = combine(run, lane(i))
            ps[i] = run[0]
            sums[:, i] = run[1]
    iota = torch.arange(cap, dtype=torch.int32)
    mets = [port_metrics.METRICS[m] for m in x["names"]]
    du, dw = ft._unpack([torch.as_tensor(d) for d in x["degs"]])
    hi_t = torch.as_tensor(hi)
    valid = torch.as_tensor(end & (ps & 1 == 1)) & (hi_t < (1 << x["w_bits"]))
    if x["maxf2"]:
        valid &= port_metrics.maxf2_mask(du, dw, x["maxf2"])
    cnt = iota - torch.as_tensor(ps >> 1, dtype=torch.int32) + 1
    weighted = [m.name for m in mets if m.needs_weight]
    accs = {name: torch.as_tensor(s) for name, s in zip(weighted, sums)}
    skeys = ft.score_keys(mets, cnt, accs, du, dw, valid, x["min_score"],
                          iota)
    out = (skeys, torch.as_tensor(src).clamp(max=x["n"] - 1),
           hi_t.clamp(max=x["n"] - 1))
    return [o.numpy() for o in out], carry_in


MODEL_METRICS = {
    0: ("jaccard_coefficient", "common_neighbors"),
    1: ("adamic_adar", "sorensen_index"),
    2: ("resource_allocation", "jaccard_coefficient", "adamic_adar"),
}


@pytest.mark.parametrize("killers", [False, True])
@pytest.mark.parametrize("n_wt", [0, 1, 2])
@pytest.mark.parametrize("run_len", [3, 40, 400])
@pytest.mark.parametrize("tile,head", [(16, 0), (32, 1), (64, 3)])
def test_tile_model_vs_twin(rng, tile, head, run_len, n_wt, killers):
    """The kernel's decomposition (tiles, aggregates, a look-back that
    stops at the first predecessor holding a run start or an inclusive
    carry, the emit) against the twin, with runs within a tile (3 lanes),
    over a few tiles (40) and over many (400); with and without killers;
    with 0-2 weight arrays.  Two walks that stop at different predecessors
    give the same bits."""
    cap, w_bits = 1024, 10
    hi, lo, degs, wts = _sorted_stream(rng, cap, w_bits, 0.9, run_len,
                                       kill=0.3 if killers else 0.0)
    names = list(MODEL_METRICS[n_wt])
    x = dict(hi=hi, lo=lo, degs=degs, wts=wts[:n_wt], names=names,
             w_bits=w_bits, n=1 << w_bits, min_score=0.0, maxf2=2 * n_wt,
             killers=killers)
    got, carries = _model_tail(x, tile, head, np.random.default_rng(1))
    again, carries_again = _model_tail(x, tile, head,
                                       np.random.default_rng(2))
    assert carries == carries_again
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    want = _port(x)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for i, name in enumerate(names):
        if not port_metrics.METRICS[name].needs_weight:
            np.testing.assert_array_equal(got[0][i], want[0][i])
            continue
        a = _decode(_to_u32(got[0][i]))
        b = _decode(_to_u32(want[0][i]))
        _assert_scores(a, b, name)
        inv = np.isneginf(b)
        np.testing.assert_array_equal(got[0][i][inv], want[0][i][inv])
    src = lo >> 1 if killers else lo
    first = np.r_[0, np.flatnonzero(np.diff(hi) | np.diff(src)) + 1]
    last = np.r_[first[1:], cap] - 1
    tiles = (last + head) // tile - (first + head) // tile + 1
    # test premise: runs lie within a tile, span two, or span many
    assert tiles.max() >= {3: 2, 40: 2, 400: 6}[run_len]
    assert run_len > 3 or np.diff(first).max() < tile
