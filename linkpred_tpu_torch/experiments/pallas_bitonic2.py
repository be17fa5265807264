"""Probe P3: the bitonic network walked from a stage table.

Counterpart of ``experiments/pallas_bitonic2.py`` (the Pallas kernel
``make_sort``: one ``fori_loop`` body over a (k, j) table in SMEM, so that
Mosaic's compile time stops growing with the stage count).  It computes the
function of P2 (``pallas_bitonic.py``), and on the card it runs the same
CUDA source, ``kernels/csrc/bitonic.cu``, which runs this module's
:func:`stage_table` as ``pallas_bitonic.plan_launches`` groups it:

* :func:`stage_table` is the probe's table, in numpy;
* :func:`table_stages` is the plain PyTorch version: P2's compare-exchange
  applied stage by stage from the table;
* :func:`make_sort` returns ``f(x, p)`` on ``(n / 128, 128)`` int32 tensors
  (no ``interpret`` flag): CPU tensors take :func:`table_stages`, CUDA
  tensors launch the kernel or raise.  With ``with_payload=False`` the
  payload comes back unchanged (a copy), as the probe's does;
* :func:`run` is the counterpart of the probe's ``main()``.

Importing this module runs nothing and reads no environment.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.timing import measure_duration
from .pallas_bitonic import (LANES, check_n, check_operand, compare_exchange,
                             plan_launches, sort_network)

__all__ = ["LAUNCHES", "stage_table", "table_stages", "make_sort", "run"]

# Launches of the CUDA kernel by this probe's wrapper (one per sort).
LAUNCHES = 0


def stage_table(n: int):
    """The network's stages as two int32 arrays (ks, js), in order."""
    ks, js = [], []
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            ks.append(k)
            js.append(j)
            j //= 2
        k *= 2
    return np.asarray(ks, np.int32), np.asarray(js, np.int32)


def table_stages(x, p, ks, js):
    """Apply the stages (ks[s], js[s]) in order to ``x`` and the payload
    ``p`` (or None), row-major; returns (keys, payload) in ``x``'s shape."""
    shape, n = x.shape, x.numel()
    lane = torch.arange(n, dtype=torch.int32, device=x.device)
    v = x.reshape(n)
    q = None if p is None else p.reshape(n)
    for k, j in zip(ks.tolist(), js.tolist()):
        v, q = compare_exchange(v, q, lane, k, j)
    return v.reshape(shape), None if q is None else q.reshape(shape)


def make_sort(n: int, with_payload: bool = True):
    """``f(x, p)`` -> (keys sorted ascending, payload): the payload moves
    with its key, or with ``with_payload=False`` comes back unchanged."""
    check_n(n, "make_sort")
    ks, js = stage_table(n)
    plan = plan_launches(ks, js, n)

    def f(x, p):
        check_operand(x, n, "make_sort")
        check_operand(p, n, "make_sort")
        if p.device != x.device:
            raise ValueError("make_sort: x and p on different devices")
        if x.device.type == "cpu":
            v, q = table_stages(x, p if with_payload else None, ks, js)
            return v, (q if with_payload else p.clone())
        out = x.clone(memory_format=torch.contiguous_format)
        pout = p.clone(memory_format=torch.contiguous_format)
        sort_network(out, pout if with_payload else None, ks, js, plan,
                     "make_sort")
        global LAUNCHES
        LAUNCHES += 1
        return out, pout

    return f


def run(log2n: int = 12, device="cuda") -> dict:
    """The probe's ``main()``: the key-value sort of 2^log2n random 31-bit
    keys with the payload ``arange(n)``, checked against ``np.sort`` and
    ``x[p] == k``; on a CUDA device timed against ``torch.sort`` plus a
    payload gather.  Raises if the check fails.  Returns the times in ms
    (none on the CPU), each the mean of 8 calls after a warm-up."""
    n = 1 << log2n
    device = torch.device(device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 31, n, dtype=np.int32)
    xt = torch.as_tensor(x, device=device).reshape(n // LANES, LANES)
    pay = torch.arange(n, dtype=torch.int32, device=device)
    pt = pay.reshape(n // LANES, LANES)
    f = make_sort(n)
    ks, ps = (a.reshape(-1).cpu().numpy() for a in f(xt, pt))
    ok = np.array_equal(ks, np.sort(x)) and np.array_equal(x[ps], ks)
    print(f"P3 table-driven bitonic 2^{log2n} on {device}: sorted correctly: "
          f"{ok}")
    if not ok:
        raise RuntimeError("P3: key-value sort wrong")
    out = {"n": n}
    if device.type == "cuda":
        flat = xt.reshape(-1)

        def library():
            v, idx = torch.sort(flat)
            return v, pay[idx]

        out["ms"] = measure_duration(lambda: f(xt, pt), 8, device=device)[0]
        out["library_ms"] = measure_duration(library, 8, device=device)[0]
        print(f"  bitonic {out['ms']:.4f} ms, torch.sort + gather "
              f"{out['library_ms']:.4f} ms per 2^{log2n} sort "
              f"({out['ms'] * 1e6 / n:.2f} vs "
              f"{out['library_ms'] * 1e6 / n:.2f} ns/lane)")
    return out
