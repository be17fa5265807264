"""Probes P2, P3 and P4, and K2 at ``ratio=1``: the port's counterparts of
``experiments/pallas_bitonic.py``, ``experiments/pallas_bitonic2.py`` and
``experiments/radix_probe.py`` on the CPU, against the JAX probes loaded
from their files (Pallas in interpret mode).

Bitonic: keys and payload bit-equal to the JAX network, on full-range keys
and on duplicate-heavy keys (16 values), where the payload shows the tie
rule (each lane keeps its own payload on equal keys).  The kernel's launch
planner: its rows cover the stage table once, in order; replayed launch by
launch, each CTA's lanes alone, they give the plain network bit for bit;
tables out of the network's order raise.  P4: whole (512, 128)
arrays equal, untouched rows included; the order the kernel applies the
stores in (band by band, ``radix_probe.dynstore_banded``) gives the same
arrays on the probe's offsets and on offsets that hypothesis draws, inside
and outside the clamp's [0, 504].  K2: the plain version's survivors
equal the concatenated live lanes of the JAX pack at a shrunk chunk.  The
kernels themselves run in test_torch_cuda.py.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from linkpred_tpu.ops import compact as ref_compact
from linkpred_tpu_torch.experiments import (pallas_bitonic, pallas_bitonic2,
                                            radix_probe)
from linkpred_tpu_torch.ops import compact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}_probe", os.path.join(REPO, "experiments", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_p2():
    return _load("pallas_bitonic")


@pytest.fixture(scope="module")
def jax_p3():
    return _load("pallas_bitonic2")


@pytest.fixture(scope="module")
def jax_radix():
    return _load("radix_probe")


def _operands(rng, n, dist):
    if dist == "dup16":
        x = rng.integers(-8, 8, n)
    else:
        x = rng.integers(-(1 << 31), 1 << 31, n)
    shape = (n // 128, 128)
    return (x.astype(np.int32).reshape(shape),
            rng.permutation(n).astype(np.int32).reshape(shape))


@pytest.mark.parametrize("dist", ["full", "dup16"])
@pytest.mark.parametrize("kv", [False, True])
def test_p2_vs_jax_probe(rng, jax_p2, dist, kv):
    n = 1 << 10
    x, pay = _operands(rng, n, dist)
    if kv:
        want = jax_p2.make_pallas_sort_kv(n, True)(jnp.asarray(x),
                                                   jnp.asarray(pay))
        got = pallas_bitonic.make_pallas_sort_kv(n)(torch.as_tensor(x),
                                                    torch.as_tensor(pay))
    else:
        want = (jax_p2.make_pallas_sort(n, True)(jnp.asarray(x)),)
        got = (pallas_bitonic.make_pallas_sort(n)(torch.as_tensor(x)),)
    for a, b in zip(got, want):
        assert tuple(a.shape) == (n // 128, 128) and a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(got[0].numpy().reshape(-1),
                                  np.sort(x.reshape(-1)))


@pytest.mark.parametrize("dist", ["full", "dup16"])
@pytest.mark.parametrize("with_payload", [True, False])
def test_p3_vs_jax_probe(rng, jax_p3, dist, with_payload):
    n = 1 << 12
    x, pay = _operands(rng, n, dist)
    want = jax_p3.make_sort(n, True, with_payload=with_payload)(
        jnp.asarray(x), jnp.asarray(pay))
    got = pallas_bitonic2.make_sort(n, with_payload=with_payload)(
        torch.as_tensor(x), torch.as_tensor(pay))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if not with_payload:
        np.testing.assert_array_equal(got[1].numpy(), pay)


def test_p3_stage_table_is_the_probes(jax_p3):
    for n in (128, 1 << 12, 1 << 21):
        for a, b in zip(pallas_bitonic2.stage_table(n),
                        jax_p3.stage_table(n)):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32
    ks, js = pallas_bitonic2.stage_table(1 << 21)
    assert ks.size == 21 * 22 // 2


def test_p2_and_p3_are_one_function(rng):
    """The unrolled network and the table walk, the payload included, on
    duplicate-heavy keys."""
    n = 1 << 13
    x = torch.as_tensor(_operands(rng, n, "dup16")[0])
    pay = torch.arange(n, dtype=torch.int32).reshape(x.shape)
    a = pallas_bitonic.make_pallas_sort_kv(n)(x, pay)
    b = pallas_bitonic2.make_sort(n)(x, pay)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    assert torch.equal(x.reshape(-1)[a[1].reshape(-1).long()],
                       a[0].reshape(-1))


def _run_plan_plain(x, p, ks, js, plan, tile):
    """The stages as the kernel groups them: each CTA's block of lanes
    alone, the plain compare-exchange inside it, directions from the global
    lane index.  A tile launch's block is a tile of consecutive lanes; a
    global launch's block gathers 2^count runs of tile / 2^count
    consecutive lanes at stride 2^g, g = log2 of the launch's last j.  A
    partner outside its block fails the reshape."""
    n = x.numel()
    tile = min(tile, n)
    v, q = x.reshape(n).clone(), p.reshape(n).clone()
    lane = torch.arange(n, dtype=torch.int32)
    for kind, first, count in plan.tolist():
        stages = list(zip(ks[first: first + count].tolist(),
                          js[first: first + count].tolist()))
        if kind == pallas_bitonic.TILE_LAUNCH:
            c = g = tile.bit_length() - 1
            blocks = lane.reshape(n // tile, tile)
        else:
            assert kind == pallas_bitonic.GLOBAL_LAUNCH
            assert len({k for k, _ in stages}) == 1
            g = stages[-1][1].bit_length() - 1
            c = tile.bit_length() - 1 - count
            assert c >= pallas_bitonic.RUN_LOG2 and stages[-1][1] >= tile
            # lane bits: [above g + count | count gathered | g - c | c run]
            blocks = lane.reshape(n >> (g + count), 1 << count, 1 << (g - c),
                                  1 << c).permute(0, 2, 1, 3) \
                .reshape(n // tile, tile)
        rows = blocks.shape[0]
        bl = blocks.long()
        gv, gq = v[bl], q[bl]
        for k, j in stages:
            jb = j.bit_length() - 1
            stride = 1 << (jb if jb < c else c + jb - g)

            def partner(a):
                return a.reshape(rows, tile // (2 * stride), 2, stride) \
                    .flip(2).reshape(rows, tile)

            vp, qp = partner(gv), partner(gq)
            take_min = ((blocks & k) == 0) == ((blocks & j) == 0)
            keep = (take_min & (gv <= vp)) | (~take_min & (gv >= vp))
            gq = torch.where(keep, gq, qp)
            gv = torch.where(take_min, torch.minimum(gv, vp),
                             torch.maximum(gv, vp))
        v[bl], q[bl] = gv, gq
    return v.reshape(x.shape), q.reshape(x.shape)


@pytest.mark.parametrize("log2n", range(7, 24))
def test_plan_covers_the_table_in_order(log2n):
    n = 1 << log2n
    ks, js = pallas_bitonic2.stage_table(n)
    plan = pallas_bitonic.plan_launches(ks, js, n)
    assert plan.dtype == np.int32 and plan.shape[1] == 3
    starts = np.r_[0, np.cumsum(plan[:, 2])[:-1]]
    np.testing.assert_array_equal(plan[:, 1], starts)
    assert plan[:, 2].sum() == ks.size and (plan[:, 2] >= 1).all()
    tile = min(pallas_bitonic.TILE, n)
    m, t = log2n, tile.bit_length() - 1
    span = t - pallas_bitonic.RUN_LOG2
    for kind, first, count in plan:
        run = js[first: first + count]
        if kind == pallas_bitonic.TILE_LAUNCH:
            assert (run < tile).all()
        else:
            assert (run >= tile).all() and count <= span
            assert (ks[first: first + count] == ks[first]).all()
    # all stages up to k = tile in the first launch; then per larger k its
    # global stages in ceil(s / span) launches and one tile launch
    assert len(plan) == 1 + sum(-(-(b - t) // span) + 1
                                for b in range(t + 1, m + 1))


@pytest.mark.parametrize("dist", ["full", "dup16"])
@pytest.mark.parametrize("log2n,tile", [(10, 64), (11, 256), (12, 128),
                                        (13, 256), (14, 512)])
def test_plan_grouping_is_the_network(rng, log2n, tile, dist):
    """With small tiles, global launches of one to four stages, split
    merges among them, occur: the network run launch by launch in the
    planner's grouping gives bitonic_stages' keys and payload bit for
    bit."""
    n = 1 << log2n
    x, pay = (torch.as_tensor(a) for a in _operands(rng, n, dist))
    ks, js = pallas_bitonic2.stage_table(n)
    plan = pallas_bitonic.plan_launches(ks, js, n, tile=tile)
    assert (plan[:, 0] == pallas_bitonic.GLOBAL_LAUNCH).any()
    got = _run_plan_plain(x, pay, ks, js, plan, tile)
    want = pallas_bitonic.bitonic_stages(x, n, payload=pay)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_plan_launches_per_sort():
    """At most 16 launches at 2^20, one up to one tile, three at two
    tiles; at 2^23 the merges of the two largest k take two global launches
    each."""
    count = {m: len(pallas_bitonic.plan_launches(
        *pallas_bitonic2.stage_table(1 << m), 1 << m))
        for m in (7, 13, 14, 20, 23)}
    assert count == {7: 1, 13: 1, 14: 3, 20: 15, 23: 23}


def _swap_two(ks, js):
    ks, js = ks.copy(), js.copy()
    ks[[5, 6]], js[[5, 6]] = ks[[6, 5]], js[[6, 5]]
    return ks, js


@pytest.mark.parametrize("case", ["swapped", "missing", "repeated",
                                  "j_not_below_k", "k_over_n", "not_pow2"])
def test_plan_refuses_tables_out_of_order(case):
    n = 1 << 10
    ks, js = pallas_bitonic2.stage_table(n)
    if case == "swapped":
        ks, js = _swap_two(ks, js)
    elif case == "missing":
        ks, js = np.delete(ks, 20), np.delete(js, 20)
    elif case == "repeated":
        ks, js = np.insert(ks, 20, ks[20]), np.insert(js, 20, js[20])
    elif case == "j_not_below_k":
        js = js.copy()
        js[0] = 2
    elif case == "k_over_n":
        ks, js = pallas_bitonic2.stage_table(2 * n)
    else:
        ks = ks.copy()
        ks[-1] = 3
    with pytest.raises(ValueError, match="plan_launches"):
        pallas_bitonic.plan_launches(ks, js, n)


@pytest.mark.parametrize("n,tile", [(16, 64), (1 << 10, 48), (1 << 10, 32),
                                    (1 << 10, 1 << 14), (96, 64)])
def test_plan_refuses_bad_n_or_tile(n, tile):
    with pytest.raises(ValueError, match="power of two"):
        pallas_bitonic.plan_launches([], [], n, tile=tile)


def test_plan_of_a_table_segment():
    """A table may start anywhere in the network's order."""
    n = 1 << 16
    ks, js = pallas_bitonic2.stage_table(n)
    plan = pallas_bitonic.plan_launches(ks[100:], js[100:], n, tile=1 << 12)
    assert plan[:, 2].sum() == ks.size - 100 and plan[0, 1] == 0
    assert pallas_bitonic.plan_launches(ks[:0], js[:0], n).shape == (0, 3)


def test_bitonic_payload_keeps_own_on_ties():
    """Two equal keys in one compare-exchange keep their payloads, where a
    sort by (key, payload) would not care."""
    n = 128
    x = torch.zeros((1, n), dtype=torch.int32)
    pay = torch.arange(n, dtype=torch.int32).flip(0).reshape(1, n)
    k, p = pallas_bitonic.make_pallas_sort_kv(n)(x, pay)
    assert torch.equal(k, x) and torch.equal(p, pay)


@pytest.mark.parametrize("iters", [1, 3])
def test_p4_vs_jax_probe(jax_radix, iters):
    jax_radix.rng = np.random.default_rng(5)
    want = np.asarray(jax_radix.dynstore_run(iters)())
    offs, x = radix_probe.dynstore_inputs(np.random.default_rng(5))
    before = radix_probe.LAUNCHES
    got = radix_probe.dynstore_run(iters, torch.as_tensor(offs),
                                   torch.as_tensor(x))
    assert radix_probe.LAUNCHES == before, "CPU tensors take the plain one"
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    untouched = (want == np.iinfo(np.int32).min).all(axis=1)
    assert untouched.any() and not untouched.all(), "test premise"


@pytest.mark.parametrize("iters", [1, 2])
def test_p4_banded_order_vs_jax_probe(jax_radix, iters):
    """The kernel's order of the stores, band by band, gives the JAX
    probe's array and the plain version's."""
    jax_radix.rng = np.random.default_rng(5)
    want = np.asarray(jax_radix.dynstore_run(iters)())
    offs, x = (torch.as_tensor(a) for a in
               radix_probe.dynstore_inputs(np.random.default_rng(5)))
    got = radix_probe.dynstore_banded(iters, offs, x)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, radix_probe.dynstore_reference(iters, offs, x))


_P4_X = torch.as_tensor(np.random.default_rng(9).integers(
    -(1 << 31), 1 << 31, (radix_probe.ROWS, radix_probe.COLS),
    dtype=np.int64).astype(np.int32))


@settings(max_examples=25, deadline=None, database=None)
@given(offs=st.lists(st.one_of(st.integers(-40, 560),
                               st.sampled_from([0, 31, 32, 33, 63, 64, 504,
                                                -5, 10 ** 6, -(1 << 31),
                                                (1 << 31) - 1])),
                     min_size=256, max_size=256),
       iters=st.sampled_from([1, 2]))
def test_p4_banded_order_on_drawn_offsets(offs, iters):
    """Offsets anywhere in int32 (the clamp moves those outside [0, 504]),
    runs across band edges, ties: band by band equals store by store, and
    full-range x shows the wrapping add."""
    o = torch.tensor(offs, dtype=torch.int32)
    assert torch.equal(radix_probe.dynstore_banded(iters, o, _P4_X),
                       radix_probe.dynstore_reference(iters, o, _P4_X))


def test_p4_banded_bands_are_the_kernels():
    """Every store lands in one or two bands of ``BAND`` rows; the probe's
    offsets give ~20 stores a band."""
    offs, _ = radix_probe.dynstore_inputs(np.random.default_rng(5))
    band = radix_probe.BAND
    counts = [sum(1 for o in offs if o < lo + band and o + radix_probe.BLK
                  > lo) for lo in range(0, radix_probe.ROWS, band)]
    assert radix_probe.ROWS % band == 0
    assert sum(counts) <= 2 * radix_probe.NSTORES
    assert 10 <= np.mean(counts) <= 30, counts


def test_p4_clamps_offsets_like_a_dynamic_slice():
    offs = torch.full((radix_probe.NSTORES,), 600, dtype=torch.int32)
    offs[0] = -5
    x = torch.arange(512 * 128, dtype=torch.int32).reshape(512, 128)
    out = radix_probe.dynstore_run(1, offs, x)
    assert torch.equal(out[:8], x[:8])                  # store 0, from row 0
    assert torch.equal(out[504:], x[(255 % 64) * 8:][:8] + 255)


CHUNK = 1 << 11


@pytest.mark.parametrize("thr", [1 << 30, 1 << 20, (1 << 32) - 1])
def test_pack_ratio_1_vs_jax_pack(rng, thr):
    """The radix probe's 1-bit split: K2 at ratio=1, where every survivor
    fits, against the JAX pack's live lanes."""
    total = CHUNK * 4
    key = rng.integers(0, 1 << 31, total, dtype=np.int64).astype(np.uint32)
    key[CHUNK: CHUNK + 100] = 7                       # a dense run
    rpk, rpidx, rcnt = (np.asarray(a) for a in ref_compact.pack_survivors(
        jnp.asarray(key), jnp.uint32(thr), chunk=CHUNK, ratio=1))
    live_k = np.concatenate([rpk[c * CHUNK: c * CHUNK + m]
                             for c, m in enumerate(rcnt)])
    live_i = np.concatenate([rpidx[c * CHUNK: c * CHUNK + m]
                             for c, m in enumerate(rcnt)])
    port = lambda a: torch.from_numpy(  # noqa: E731
        np.atleast_1d(np.asarray(a, np.uint32) ^ np.uint32(0x80000000))
        .view(np.int32))
    pk, pidx, cnt = compact.pack_survivors(port(key), port(thr).reshape(()),
                                           ratio=1)
    n = int(cnt)
    assert pk.shape == (total,) and n == rcnt.sum()
    np.testing.assert_array_equal(
        pk[:n].numpy().view(np.uint32) ^ np.uint32(0x80000000), live_k)
    np.testing.assert_array_equal(pidx[:n].numpy(), live_i)
    assert (pk[n:] == compact.DEAD_KEY).all() and (pidx[n:] == 0).all()


def test_radix_probe_columns_on_cpu():
    """The split column's threshold halves its keys; its pack keeps exactly
    the survivors; the sort column sorts.  (Timing needs the card.)"""
    key = radix_probe.pack_keys(np.random.default_rng(0), 1 << 12, "cpu")
    u32 = key.numpy().view(np.uint32) ^ np.uint32(0x80000000)
    assert (u32 < 1 << 31).all()
    frac = float((key <= radix_probe.SPLIT_THR).float().mean())
    assert 0.45 < frac < 0.55
    packed = radix_probe.pack_run(2, np.random.default_rng(0), 1 << 12,
                                  "cpu")()
    live = packed[packed != compact.DEAD_KEY]
    assert 0 < live.numel() < 1 << 12 and (live <= radix_probe.SPLIT_THR).all()
    k, p = radix_probe.sort_run(3, np.random.default_rng(1), 1 << 12, "cpu")()
    assert k.dtype == torch.int64 and p.dtype == torch.int32
    assert (k[1:] >= k[:-1]).all() and (k < 1 << 42).all()


def test_radix_probe_main_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        radix_probe.main(["--lanes-log2", "12"])


@pytest.mark.parametrize("n", [100, 64, 3 << 10])
def test_wrappers_refuse_bad_n(n):
    for make in (pallas_bitonic.make_pallas_sort,
                 pallas_bitonic.make_pallas_sort_kv,
                 pallas_bitonic2.make_sort):
        with pytest.raises(ValueError, match="power of two"):
            make(n)


def test_wrappers_refuse_other_devices_and_shapes():
    n = 1 << 10
    meta = torch.zeros((n // 128, 128), dtype=torch.int32, device="meta")
    cpu = torch.zeros((n // 128, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_bitonic.make_pallas_sort(n)(meta)
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_bitonic.make_pallas_sort_kv(n)(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_bitonic2.make_sort(n)(meta, meta)
    with pytest.raises(ValueError, match="expected int32"):
        pallas_bitonic.make_pallas_sort(n)(cpu.reshape(-1))
    with pytest.raises(ValueError, match="expected int32"):
        pallas_bitonic2.make_sort(n)(cpu, cpu.long())
    offs = torch.zeros(radix_probe.NSTORES, dtype=torch.int32)
    x = torch.zeros((512, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        radix_probe.dynstore_run(1, offs.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="iters"):
        radix_probe.dynstore_run(0, offs, x)


def test_p2_p3_run_checks_on_cpu():
    assert pallas_bitonic.run(10, payload=True, device="cpu") == {"n": 1024}
    assert pallas_bitonic2.run(11, device="cpu") == {"n": 2048}
