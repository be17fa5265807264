"""Probe P1: K1 at the fused-tail prototype's one configuration.

Counterpart of ``experiments/pallas_tail.py`` (the Pallas kernel
``pallas_tail`` and its XLA twin ``xla_tail``).  The prototype computes K1's
function at one configuration: one metric (Jaccard), the deg16 pair, no
weights, no killers, ``W_BITS = 21``, 2^21 lanes.  K1's CUDA kernel covers
that configuration, so this module adds no CUDA source:

* :func:`xla_tail` is a plain PyTorch copy of the prototype's XLA tail,
  written out on its own (not a call of ``fused_tail_reference``);
* :func:`pallas_tail` launches K1 (``ops.fused_tail.fused_tail``) at that
  configuration; its launches count in the counter ``k1.launches``;
* :func:`make_stream` builds the prototype's sorted stream from a numpy
  generator.

Both functions return the prototype's results: the selection key as the
reference's u32 bits (held in an int32 tensor), ``ku`` and ``kw``.  Unlike
the JAX probe, importing this module runs nothing and reads no environment.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.fused_tail import fused_tail
from ..predict.metrics import METRICS

__all__ = ["LANES", "W_BITS", "METRIC", "xla_tail", "pallas_tail",
           "make_stream"]

LANES = 1 << 21                 # the prototype's tile (LANES_LOG2 = 21)
W_BITS = 21
METRIC = METRICS["jaccard_coefficient"]

_INT32_MIN = -(1 << 31)


def xla_tail(hi, lo, dpack, min_score: float, *, w_bits: int = W_BITS):
    """The prototype's XLA tail: run boundaries on (hi, lo), run-start
    cummax, count, Jaccard from the deg16 pair, the descending selection key
    with invalid lanes spread by lane index, clamped ``ku``/``kw``."""
    cap = hi.shape[0]
    nvert = 1 << w_bits
    iota = torch.arange(cap, dtype=torch.int32, device=hi.device)
    neq = (hi[1:] != hi[:-1]) | (lo[1:] != lo[:-1])
    one = torch.ones(1, dtype=torch.bool, device=hi.device)
    is_start = torch.cat([one, neq])
    is_end = torch.cat([neq, one])
    start = torch.cummax(torch.where(is_start, iota, 0), 0).values
    cnt = iota - start + 1
    du = (dpack >> 16) & 0xFFFF
    dw = dpack & 0xFFFF
    valid = is_end & (hi < nvert)
    s = METRIC.score(cnt, cnt.to(torch.float32), du, dw)
    s = torch.where(valid & (s > min_score), s, float("-inf"))
    # the u32 key ~(u ^ (sign ? 0xFFFFFFFF : 0x80000000)), in int32 bits
    u = s.view(torch.int32)
    key = ~torch.where(u < 0, ~u, u ^ _INT32_MIN)
    key = torch.where(torch.isneginf(s), key | (iota & 0x7FFFFE), key)
    return key, lo.clamp(max=nvert - 1), hi.clamp(max=nvert - 1)


def pallas_tail(hi, lo, dpack, min_score: float, *, w_bits: int = W_BITS):
    """The prototype's fused tail, computed by K1 (CPU tensors take K1's
    plain version).  Same arguments and results as :func:`xla_tail`."""
    skeys, ku, kw = fused_tail(hi, lo, (dpack,), [], min_score,
                               metrics=(METRIC,), w_bits=w_bits,
                               n=1 << w_bits)
    # K1's key is the u32 key with its sign bit flipped (ops/topk.py)
    return skeys[0] ^ _INT32_MIN, ku, kw


def make_stream(rng: np.random.Generator, n_lanes: int = LANES,
                fill: float = 0.97, w_bits: int = W_BITS):
    """The prototype's sorted stream: duplicate-heavy (w, src) pairs (~8
    lanes per run) sorted by the pair, pad lanes after them, random deg16
    pairs.  Returns numpy int32 ``(hi, lo, dpack)``."""
    nvert = 1 << w_bits
    n_real = int(n_lanes * fill)
    w = rng.integers(0, nvert, n_real, dtype=np.int64)
    src = rng.integers(0, nvert, n_real, dtype=np.int64)
    if n_real >= 8:
        w = w[rng.integers(0, n_real // 8, n_real)]
        src = src[rng.integers(0, n_real // 8, n_real)]
    key = np.sort((w << 32) | src)
    iota = np.arange(n_lanes, dtype=np.int64)
    hi = np.concatenate([(key >> 32).astype(np.int32),
                         (nvert | (iota[n_real:] & 1023)).astype(np.int32)])
    lo = np.concatenate([(key & 0xFFFFFFFF).astype(np.int32),
                         np.zeros(n_lanes - n_real, np.int32)])
    udeg = rng.integers(1, 1 << 16, n_lanes, dtype=np.int64)
    wdeg = rng.integers(1, 1 << 16, n_lanes, dtype=np.int64)
    dpack = ((udeg << 16) | wdeg).astype(np.uint32).view(np.int32)
    return hi, lo, dpack
