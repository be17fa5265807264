"""The port's metrics (linkpred_tpu_torch/predict/metrics.py) against the
reference's MetricSpec over a degree grid.

Tolerances: float32 formulas bit-equal, except Salton (the reference's XLA
rewrites a / sqrt(b) into a * rsqrt(b), which is not correctly rounded;
the port divides by the correctly rounded root, so it is held bit-equal to
NumPy's float32 IEEE arithmetic and within 2 ulp of the reference) and the
AA weight (the reference's own float32 log vs torch.log: within 1e-6
relative).  The float64 oracle branches are equal.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from linkpred_tpu.predict import metrics as ref
from linkpred_tpu_torch.predict import metrics as port

UNWEIGHTED = [n for n, m in port.METRICS.items() if not m.needs_weight]


def _grid(rng, size=20_000):
    du = rng.integers(1, 70_000, size)
    dv = rng.integers(1, 70_000, size)
    du[:8] = [1, 1, 2, 65535, 65536, 70000, 3, 1]
    dv[:8] = [1, 2, 1, 65535, 1, 70000, 3, 65536]
    cnt = np.minimum(rng.integers(1, 200, size), np.minimum(du, dv))
    return cnt.astype(np.int32), du.astype(np.int32), dv.astype(np.int32)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_metric_names_and_order_match_reference():
    assert list(port.METRICS) == list(ref.METRICS)
    for name, spec in ref.METRICS.items():
        assert port.METRICS[name].needs_weight == spec.needs_weight
    for alias in ("cn", "jaccard", "cosine", "lhn", "aa", "ra"):
        assert port.get_metric(alias).name == ref.get_metric(alias).name


@pytest.mark.parametrize("name", UNWEIGHTED)
def test_score_float32_vs_reference(rng, name):
    cnt, du, dv = _grid(rng)
    got = port.METRICS[name].score(torch.from_numpy(cnt), None,
                                   torch.from_numpy(du),
                                   torch.from_numpy(dv)).numpy()
    want = np.asarray(ref.METRICS[name].score(
        jnp.asarray(cnt), None, jnp.asarray(du), jnp.asarray(dv)))
    assert got.dtype == np.float32
    if name == "salton_cosine_similarity":
        f = np.float32
        ieee = cnt.astype(f) / np.sqrt(du.astype(f) * dv.astype(f))
        np.testing.assert_array_equal(got, ieee)
        assert _ulps(got, want).max() <= 2
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(port.METRICS))
def test_score_float64_oracle_branch(rng, name):
    cnt, du, dv = _grid(rng)
    acc = rng.random(cnt.shape[0])
    got = port.METRICS[name].score(cnt, acc, du, dv, xp=np)
    want = ref.METRICS[name].score(cnt, acc, du, dv, xp=np)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["adamic_adar", "resource_allocation"])
def test_weight_from_degree(name):
    deg = np.concatenate([np.arange(0, 5000), [65535, 65536, 1 << 20]]) \
        .astype(np.int32)
    got = port.METRICS[name].weight_from_degree(torch.from_numpy(deg)).numpy()
    want = np.asarray(ref.METRICS[name].weight_from_degree(jnp.asarray(deg)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(got == 0, want == 0)
    if name == "resource_allocation":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(
        port.METRICS[name].weight_from_degree(deg, xp=np),
        ref.METRICS[name].weight_from_degree(deg, xp=np))


@pytest.mark.parametrize("maxf2", [0, 1, 2, 7])
def test_maxf2_mask_verbatim(rng, maxf2):
    _, du, dv = _grid(rng)
    want = np.asarray(ref.maxf2_mask(jnp.asarray(du), jnp.asarray(dv), maxf2))
    got = port.maxf2_mask(torch.from_numpy(du), torch.from_numpy(dv),
                          maxf2).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.maxf2_mask(du, dv, maxf2), want)
