"""Probes P2, P3 and P4, and K2 at ``ratio=1``: the port's counterparts of
``experiments/pallas_bitonic.py``, ``experiments/pallas_bitonic2.py`` and
``experiments/radix_probe.py`` on the CPU, against the JAX probes loaded
from their files (Pallas in interpret mode).

Bitonic: keys and payload bit-equal to the JAX network, on full-range keys
and on duplicate-heavy keys (16 values), where the payload shows the tie
rule (each lane keeps its own payload on equal keys).  P4: whole (512, 128)
arrays equal, untouched rows included.  K2: the plain version's survivors
equal the concatenated live lanes of the JAX pack at a shrunk chunk.  The
kernels themselves run in test_torch_cuda.py.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
