"""K2, the survivor pack, and the selection around it: the port's plain twin
against the JAX package's Pallas ``pack_survivors`` (interpret mode on the
CPU, at a shrunk chunk as tests/test_compact.py runs it), the sampled
threshold against the reference's, both arms of ``_argselect_packed``
against a full sort.  The CUDA kernel against the twin is in
test_torch_cuda.py.

The reference packs per chunk; the port compacts globally, so the port's
survivors must equal the concatenation of the reference's per-chunk live
lanes, exactly and in order.  Keys are compared in the reference's u32 form.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linkpred_tpu.ops import compact as ref_compact
from linkpred_tpu.predict import scoring as ref_scoring
from linkpred_tpu_torch.ops import compact
from linkpred_tpu_torch.ops.topk import desc_score_key, spread_invalid
from linkpred_tpu_torch.predict import scoring
from linkpred_tpu_torch.utils.profiling import counter

CHUNK = 1 << 11
RATIO = 2


def _to_port(u32):
    """Reference u32 keys -> the port's sign-flipped int32 keys."""
    a = np.atleast_1d(np.asarray(u32, np.uint32)) ^ np.uint32(0x80000000)
    return torch.from_numpy(a.view(np.int32))


def _keys(rng, dist, total):
    if dist == "uniform":
        key = rng.integers(0, 1 << 32, total, dtype=np.int64)
        thr = 1 << 29                                   # ~12% survive
    elif dist == "clustered":
        key = np.full(total, 1 << 30, np.int64)
        key[CHUNK - 200: CHUNK + 77] = 5                # straddles a chunk
        key[-300:] = 7
        thr = 100
    elif dist == "high_keys":
        # survivors above 2^31 in u32: the sign flip must keep the order
        key = rng.integers(1 << 31, 1 << 32, total, dtype=np.int64)
        thr = (1 << 31) + (1 << 28)
    else:
        key = rng.integers(1 << 20, 1 << 31, total, dtype=np.int64)
        thr = 3                                         # nothing survives
    return key.astype(np.uint32), np.uint32(thr)


@pytest.mark.parametrize("dist", ["uniform", "clustered", "high_keys",
                                  "empty"])
def test_twin_vs_pallas_pack(rng, dist):
    total = CHUNK * 4
    key, thr = _keys(rng, dist, total)
    rpk, rpidx, rcnt = (np.asarray(a) for a in ref_compact.pack_survivors(
        jnp.asarray(key), jnp.uint32(thr), chunk=CHUNK, ratio=RATIO))
    w = CHUNK // RATIO
    assert rcnt.max() <= w, "test premise: no chunk overflows"
    live_k = np.concatenate([rpk[c * w: c * w + n] for c, n in enumerate(rcnt)])
    live_i = np.concatenate([rpidx[c * w: c * w + n]
                             for c, n in enumerate(rcnt)])
    pk, pidx, cnt = compact.pack_survivors(
        _to_port(key), _to_port(thr).reshape(()))
    n = int(cnt)
    assert pk.shape == (total // compact.PACK_RATIO,)
    assert n == rcnt.sum()
    np.testing.assert_array_equal(
        pk[:n].numpy().view(np.uint32) ^ np.uint32(0x80000000), live_k)
    np.testing.assert_array_equal(pidx[:n].numpy(), live_i)
    assert (pk[n:] == compact.DEAD_KEY).all() and (pidx[n:] == 0).all()


def test_twin_overflow_counts_all_keeps_prefix():
    key = torch.zeros(4096, dtype=torch.int32)          # everything survives
    pk, pidx, cnt = compact.pack_survivors(
        key, torch.tensor(10, dtype=torch.int32))
    assert int(cnt) == 4096 and pk.shape == (1024,)
    np.testing.assert_array_equal(pidx.numpy(), np.arange(1024))


@pytest.mark.parametrize("total,kk", [(1 << 16, 500), (1 << 16, 5000),
                                      (1 << 14, 100), (3000, 7)])
def test_sample_threshold_equals_reference(rng, total, kk):
    key = rng.integers(0, 1 << 32, total, dtype=np.int64).astype(np.uint32)
    key[: total // 3] = 0xFF800000 | (np.arange(total // 3) & 0x7FFFFE)
    rt, rq = ref_compact.sample_threshold(jnp.asarray(key), kk,
                                          sample_log2=12)
    pt, pq = compact.sample_threshold(_to_port(key), kk, sample_log2=12)
    assert pq == rq
    assert (pt.reshape(1).numpy().view(np.uint32)[0] ^ np.uint32(0x80000000)
            == np.uint32(rt))
    assert int((_to_port(key) <= pt).sum()) >= kk


def _selection_keys(rng, total, neg_frac=0.6):
    scores = rng.random(total, np.float32)
    scores[rng.random(total) < neg_frac] = -np.inf
    s = torch.from_numpy(scores)
    lane = torch.arange(total, dtype=torch.int32)
    return spread_invalid(desc_score_key(s), s, lane), scores


def _full_sort(key, kk):
    sk, order = torch.sort(key)
    return sk[:kk], order[:kk]


def test_argselect_packed_arm_exact(rng):
    key, scores = _selection_keys(rng, 1 << 16)
    kk = 300
    before = counter("select.packed_arm")
    sk, si = scoring._argselect_packed(key, kk)
    assert counter("select.packed_arm") == before + 1
    fk, fi = _full_sort(key, kk)
    np.testing.assert_array_equal(sk.numpy(), fk.numpy())
    assert set(zip(sk.tolist(), si.tolist())) == \
        set(zip(fk.tolist(), fi.tolist()))
    # the same winners as the reference's packed selection on its u32 keys
    rkey = key.numpy().view(np.uint32) ^ np.uint32(0x80000000)
    rk, ri = ref_scoring._argselect_packed(
        jnp.asarray(rkey), jnp.arange(key.shape[0], dtype=jnp.int32), kk)
    np.testing.assert_array_equal(
        sk.numpy().view(np.uint32) ^ np.uint32(0x80000000), np.asarray(rk))
    assert set(si.tolist()) == set(np.asarray(ri).tolist())


def test_argselect_sort_arm_on_overflow():
    """A tie plateau at the cut puts every lane under T: the survivors
    overflow the pack and the full sort runs, still exact."""
    key = desc_score_key(torch.full((1 << 14,), 0.5))
    before = counter("select.sort_arm")
    sk, si = scoring._argselect_packed(key, 64)
    assert counter("select.sort_arm") == before + 1
    np.testing.assert_array_equal(sk.numpy(), _full_sort(key, 64)[0].numpy())


def test_argselect_sort_arm_on_undershoot(rng, monkeypatch):
    """A threshold below the kk-th key (a sampling undershoot) takes the
    full-sort arm."""
    key, _ = _selection_keys(rng, 1 << 15)
    kk = 200
    low = torch.sort(key).values[kk // 2]
    monkeypatch.setattr(scoring, "sample_threshold",
                        lambda k, n: (low, 0))
    before = counter("select.sort_arm")
    sk, si = scoring._argselect_packed(key, kk)
    assert counter("select.sort_arm") == before + 1
    np.testing.assert_array_equal(sk.numpy(), _full_sort(key, kk)[0].numpy())


@pytest.mark.parametrize("kk,packs", [(100, True), (5000, False)])
def test_argselect_dispatch_rule(rng, monkeypatch, kk, packs):
    """The reference's rule: pack only when the buffer is large and
    kk * 4 <= total // PACK_RATIO."""
    monkeypatch.setattr(scoring, "SEL_PACK_MIN", 1 << 14)
    key, _ = _selection_keys(rng, 1 << 15)
    before = counter("select.packed_arm") + counter("select.sort_arm")
    sk, _ = scoring._argselect(key, kk)
    ran = counter("select.packed_arm") + counter("select.sort_arm") - before
    assert ran == (1 if packs else 0)
    np.testing.assert_array_equal(sk.numpy(), _full_sort(key, kk)[0].numpy())


def test_wrapper_refuses_other_devices():
    key = torch.zeros(4096, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        compact.pack_survivors(key, key[0])


def test_wrapper_refuses_2_31_lanes():
    """Lane indices and the count are int32 (a meta tensor: no memory)."""
    key = torch.zeros(compact.MAX_TOTAL, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="int32 lane indices"):
        compact.pack_survivors(key, key[0])
    assert compact.MAX_TOTAL == 1 << 31
