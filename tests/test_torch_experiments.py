"""Probes P1 and P5: the port's counterparts of ``experiments/pallas_tail.py``
and ``experiments/pallas_smoke.py`` on the CPU.

P1: the port's ``xla_tail`` against the JAX probe's ``xla_tail`` and its
Pallas ``pallas_tail`` (interpret mode), and the port's ``pallas_tail`` (K1's
wrapper; its plain version on the CPU) against both.  The JAX probe reads
its shape from the environment when it is imported, so it is loaded with
``LANES_LOG2=12``, ``CHR=8`` and ``W_BITS=12``: 4096 lanes in 4 grid steps,
so the cross-step carry runs.  Keys, ku and kw bit-equal.

P5: the plain version against ``2x + 1`` in numpy (the JAX ``f`` has no
interpret flag, so it cannot run on the CPU).  The kernels themselves run in
test_torch_cuda.py.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from linkpred_tpu_torch.experiments import pallas_smoke, pallas_tail

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_probe(monkeypatch):
    for k, v in (("LANES_LOG2", "12"), ("CHR", "8"), ("W_BITS", "12"),
                 ("METRIC", "jaccard_coefficient")):
        monkeypatch.setenv(k, v)
    spec = importlib.util.spec_from_file_location(
        "_jax_pallas_tail_probe",
        os.path.join(REPO, "experiments", "pallas_tail.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.N == 4096 and mod.N // 128 // mod.CHR == 4 and mod.INTERPRET
    return mod


@pytest.mark.parametrize("min_score,fill", [(0.0, 0.97), (0.002, 0.8)])
def test_p1_tail_vs_jax_probe(rng, jax_probe, min_score, fill):
    hi, lo, dpack = pallas_tail.make_stream(rng, 4096, fill=fill, w_bits=12)
    runs = np.diff(np.flatnonzero(np.diff(hi) | np.diff(lo)))
    assert runs.max() > 1 and (hi >= 1 << 12).any(), "test premise"
    t = [torch.as_tensor(a) for a in (hi, lo, dpack)]
    port_xla = pallas_tail.xla_tail(*t, min_score, w_bits=12)
    port_k1 = pallas_tail.pallas_tail(*t, min_score, w_bits=12)
    j = [jnp.asarray(a) for a in (hi, lo, dpack)]
    ms = jnp.float32(min_score)
    want_xla = jax_probe.xla_tail(*j, ms)
    want_pallas = jax_probe.pallas_tail(*j, ms)
    want = [np.asarray(a).view(np.int32) for a in want_xla]
    for got, ref in zip(want_pallas, want):
        np.testing.assert_array_equal(np.asarray(got).view(np.int32), ref)
    for got in (port_xla, port_k1):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b)


def test_p1_make_stream_shape(rng):
    hi, lo, dpack = pallas_tail.make_stream(rng, 1 << 10, w_bits=8)
    assert hi.dtype == lo.dtype == dpack.dtype == np.int32
    assert hi.shape == lo.shape == dpack.shape == (1 << 10,)
    n_real = int(1024 * 0.97)
    k = hi[:n_real].astype(np.int64) << 32 | lo[:n_real].astype(np.int64)
    assert np.all(np.diff(k) >= 0), "real lanes sorted by (w, src)"
    assert np.all(hi[n_real:] >= 1 << 8) and np.all(hi[:n_real] < 1 << 8)


@pytest.mark.parametrize("shape", [(8, 128), (1000,)])
def test_p5_plain_version(rng, shape):
    x = rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64) \
        .astype(np.int32)
    launches = pallas_smoke.LAUNCHES
    got = pallas_smoke.affine_smoke(torch.as_tensor(x))
    assert pallas_smoke.LAUNCHES == launches, "CPU tensors take the plain one"
    want = (x.astype(np.int64) * 2 + 1).astype(np.int32)   # wraps
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape


def test_p5_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        pallas_smoke.affine_smoke(torch.zeros(4, dtype=torch.int32,
                                              device="meta"))


@pytest.mark.parametrize("shift", [0, 1])
@pytest.mark.parametrize("n", [1, 3, 7, 1 << 12, (1 << 12) + 3])
def test_p5_plain_version_ragged_and_views(rng, n, shift):
    """The lengths and the offset view that the kernel's scalar paths
    take, on the plain version (the CPU path)."""
    host = rng.integers(-(1 << 31), 1 << 31, n + shift).astype(np.int32)
    got = pallas_smoke.affine_smoke(torch.as_tensor(host)[shift:])
    want = (host[shift:].astype(np.int64) * 2 + 1).astype(np.int32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_launch_floor_needs_a_card():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        pallas_smoke.launch_floor_us("cpu")
