"""Probe P4 and the radix-sort feasibility columns, on the card.

Counterpart of ``experiments/radix_probe.py``.  A multi-pass radix sort
needs, per pass, digit ranks and a scatter of every (chunk, bucket) group
to its offset.  The probe measures three primitives and prices two radix
schemes with them against the tile sort they would replace:

* ``sort``: the engine's tile sort, an int64 key below 2^42 with an int32
  payload (``torch.sort`` plus a gather by its indices; the probe's
  ``lax-2op-u64``), XOR-ed anew each iteration;
* ``pack-split``: one 1-bit split pass, the survivor pack K2
  (``ops/compact.py``) at ``ratio=1`` with a threshold that halves the
  lanes; keys in the port's sign-flipped int32 form (``ops/topk.py``);
* ``dynstore``: one sequential dynamic-offset store of an 8 x 128 int32
  block into a resident (512, 128) array, the kernel P4 of this module
  (:func:`dynstore_run`, ``kernels/csrc/dynstore.cu``; its plain version
  :func:`dynstore_reference`, and :func:`dynstore_banded`, the same stores
  in the order the kernel applies them).

:func:`bench` times ``make_run(1)`` and ``make_run(iters)`` with CUDA events
and takes ``(t_n - t_1) / (n - 1)``; the store column takes the same
difference of device times queued behind a sleep (:func:`queued_ms`), since
one call of the kernel takes less device time than its host path.
:func:`main` prints the columns and the radix arithmetic
(:func:`radix_arithmetic`), with the card's memory rate in place of the
v5e's, and the card's name and power limit.  Importing this module runs
nothing, prints nothing and reads no environment:

    python -m linkpred_tpu_torch.experiments.radix_probe [--lanes-log2 21]
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from ..ops.compact import pack_survivors
from ..utils.timing import measure_duration

__all__ = ["ROWS", "COLS", "NSTORES", "BLK", "BAND", "LAUNCHES",
           "SPLIT_THR", "HBM_BYTES_PER_S", "dynstore_inputs",
           "dynstore_reference", "dynstore_banded", "dynstore_run",
           "sort_run", "pack_keys", "pack_run", "bench", "queued_ms",
           "radix_arithmetic", "main"]

ROWS, COLS, NSTORES, BLK = 512, 128, 256, 8
# Rows of a band of the kernel's output (dynstore.cu's kBand).
BAND = 32
INT32_MIN = -(1 << 31)
# The card's memory rate (H100 SXM data sheet), for the radix arithmetic.
HBM_BYTES_PER_S = 3.35e12
# The 1-bit split's threshold, 1 << 30 as a u32 key, in the port's form.
SPLIT_THR = (1 << 30) - (1 << 31)

# Launches of the P4 kernel (the wrapper adds one per launch).
LAUNCHES = 0


def dynstore_inputs(rng: np.random.Generator):
    """The probe's inputs, drawn in its order: ``offs`` int32[256] in
    [0, 504), then ``x`` int32[512, 128] below 2^30."""
    offs = rng.integers(0, ROWS - BLK, NSTORES, dtype=np.int64) \
        .astype(np.int32)
    x = rng.integers(0, 1 << 30, (ROWS, COLS), dtype=np.int64) \
        .astype(np.int32)
    return offs, x


def dynstore_reference(iters: int, offs, x):
    """``iters`` times, store i = 0..255 in order:
    ``out[off[i]:off[i]+8] = x[(i % 64) * 8:+8] + i`` into an output that
    starts as INT32_MIN; ``off`` clamped to [0, 504] as a dynamic slice
    clamps its start."""
    out = torch.full((ROWS, COLS), INT32_MIN, dtype=torch.int32,
                     device=x.device)
    starts = offs.clamp(0, ROWS - BLK).tolist()
    for _ in range(iters):
        for i, o in enumerate(starts):
            src = (i % (ROWS // BLK)) * BLK
            out[o: o + BLK] = x[src: src + BLK] + i
    return out


def dynstore_banded(iters: int, offs, x):
    """:func:`dynstore_reference`'s stores in the order the kernel applies
    them, in plain PyTorch: band by band of ``BAND`` rows, each band taking
    the stores that touch it in store order (a store of 8 rows touches at
    most two bands), and ``iters`` times over that list, each store writing
    only its rows inside the band.  The same output as the reference: a
    row's stores are the same stores in the same order.  For the tests and
    the smoke, never on a path."""
    out = torch.full((ROWS, COLS), INT32_MIN, dtype=torch.int32,
                     device=x.device)
    starts = offs.clamp(0, ROWS - BLK).tolist()
    for lo in range(0, ROWS, BAND):
        hi = lo + BAND
        band = [(i, o) for i, o in enumerate(starts)
                if o < hi and o + BLK > lo]
        for _ in range(iters):
            for i, o in band:
                r0, r1 = max(o, lo), min(o + BLK, hi)
                src = (i % (ROWS // BLK)) * BLK - o
                out[r0:r1] = x[src + r0: src + r1] + i
    return out


def dynstore_run(iters: int, offs, x):
    """P4: the stores of :func:`dynstore_reference` on ``x``'s device.
    ``offs`` int32[256] and ``x`` int32[512, 128] on one device; CPU tensors
    take the plain version, CUDA tensors launch the kernel or raise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dynstore_run: unsupported device {x.device}")
    if x.dtype != torch.int32 or tuple(x.shape) != (ROWS, COLS) \
            or offs.dtype != torch.int32 or tuple(offs.shape) != (NSTORES,) \
            or offs.device != x.device:
        raise ValueError(f"dynstore_run: expects offs int32[{NSTORES}] and "
                         f"x int32[{ROWS}, {COLS}] on one device")
    if iters < 1:
        raise ValueError(f"dynstore_run: iters must be >= 1, got {iters}")
    if x.device.type == "cpu":
        return dynstore_reference(iters, offs, x)
    from ..kernels import _build

    lib = _build.load()
    offs, x = offs.contiguous(), x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()           # the kernel reads x 16 bytes at a time
    out = torch.full((ROWS, COLS), INT32_MIN, dtype=torch.int32,
                     device=x.device)
    err = lib.lp_dynstore(x.device.index, offs.data_ptr(), x.data_ptr(),
                          out.data_ptr(), iters,
                          torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "dynstore_run")
    global LAUNCHES
    LAUNCHES += 1
    return out


def sort_run(iters: int, rng: np.random.Generator, n: int, device):
    """The tile-sort column: a thunk that sorts an int64 key below 2^42
    XOR-ed with a new value each of ``iters`` times, gathering an int32
    payload by the sort's indices."""
    k = torch.as_tensor(rng.integers(0, 1 << 42, n, dtype=np.int64),
                        device=device)
    p = torch.as_tensor(rng.integers(0, 1 << 31, n, dtype=np.int64)
                        .astype(np.int32), device=device)
    xors = rng.integers(1, 1 << 21, iters, dtype=np.int64).tolist()

    def go():
        c, q = k, p
        for x in xors:
            c, idx = torch.sort(c ^ x)
            q = q[idx]
        return c, q

    return go


def pack_keys(rng: np.random.Generator, n: int, device):
    """The split column's keys: u32 below 2^31, in the port's int32 form."""
    k = rng.integers(0, 1 << 31, n, dtype=np.int64).astype(np.uint32)
    return torch.as_tensor((k ^ np.uint32(0x80000000)).view(np.int32),
                           device=device)


def pack_run(iters: int, rng: np.random.Generator, n: int, device):
    """The 1-bit split column: a thunk that packs, ``iters`` times, the
    previous pack's keys XOR-ed with a new value below 2^21 at
    ``ratio=1`` (the sign bit is untouched, so the XOR commutes with the
    port's key form)."""
    key = pack_keys(rng, n, device)
    thr = torch.tensor(SPLIT_THR, dtype=torch.int32, device=device)
    xors = rng.integers(1, 1 << 21, iters, dtype=np.int64).tolist()

    def go():
        c = key
        for x in xors:
            c = pack_survivors(c ^ x, thr, ratio=1)[0]
        return c

    return go


def bench(name: str, make_run, device, iters: int = 8,
          repeat: int = 3) -> float:
    """``(t_iters - t_1) / (iters - 1)`` in ms, each t the mean of
    ``repeat`` calls of ``make_run(...)``'s thunk timed with CUDA events
    after a warm-up."""
    f1, fn = make_run(1), make_run(iters)
    t1, _ = measure_duration(f1, repeat, device=device)
    tn, _ = measure_duration(fn, repeat, device=device)
    per = (tn - t1) / (iters - 1)
    print(f"{name:12s} {per:8.4f} ms  (t1 {t1:.4f}, t{iters} {tn:.4f})",
          flush=True)
    return per


# A sleep kernel of this many cycles (~25 ms at the H100's clocks) holds
# the stream while the host issues the calls that queued_ms times.
SLEEP_CYCLES = 50_000_000


def queued_ms(fn, device, repeat: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``repeat`` calls queued
    behind a sleep kernel (after a warm-up call): the host issues every
    call while the card sleeps, so the events time the device work back to
    back and not the host's issue rate.  Raises if the issue outlasted half
    the sleep's nominal time at 2 GHz."""
    fn()
    torch.cuda.synchronize(device)
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record(stream)
    for _ in range(repeat):
        fn()
    end.record(stream)
    issue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    if issue_ms >= SLEEP_CYCLES / 2e9 * 1e3 / 2:
        raise RuntimeError(f"queued_ms: issuing {repeat} calls took "
                           f"{issue_ms:.1f} ms, too long for the sleep")
    return start.elapsed_time(end) / repeat


def radix_arithmetic(log2n: int, sort_ms: float, pack_ms: float,
                     per_store_us: float, bits: int = 42) -> None:
    """Prices the two radix schemes over a ``bits``-bit key at ``2^log2n``
    lanes against the tile sort (``sort_ms``): the shift-routing radix at
    ``bits`` 1-bit splits of ``pack_ms`` each, and the block-scatter radix
    at r = 4 and 8 bits a pass over 2^17-lane chunks, each pass one store
    of ``per_store_us`` a (chunk, bucket) group plus the key and payload
    read and written once, and prints them."""
    n = 1 << log2n
    print(f"\nradix arithmetic at 2^{log2n} lanes, {bits}-bit key:")
    print(f"  shift-routing radix: {bits} x {pack_ms:.4f} ms = "
          f"{bits * pack_ms:.3f} ms vs torch.sort {sort_ms:.4f} ms "
          f"({bits * pack_ms / sort_ms:.1f}x)")
    for r, chunk in [(4, 1 << 17), (8, 1 << 17)]:
        passes = -(-bits // r)
        stores = (n // chunk) * (1 << r)
        scatter_ms = stores * per_store_us / 1e3
        hbm_ms = 2 * 12 * n / HBM_BYTES_PER_S * 1e3
        total = passes * (scatter_ms + hbm_ms)
        print(f"  block-scatter radix r={r}: {passes} passes x ({stores} "
              f"stores x {per_store_us:.5f} us + {hbm_ms:.4f} ms HBM) = "
              f"{total:.4f} ms ({total / sort_ms:.2f}x torch.sort)")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("radix_probe: needs a CUDA device")
    return torch.device("cuda", 0)


def main(argv=None) -> dict:
    """The probe's three columns and its radix arithmetic on CUDA device 0;
    raises without one.  Returns the columns: ``sort_ms``, ``pack_ms`` per
    iteration, ``per_store_us`` and ``per_grid_ms`` (256 stores)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes-log2", type=int, default=21)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--repeat", type=int, default=3)
    a = ap.parse_args(argv)
    device = _card()
    n = 1 << a.lanes_log2
    rng = np.random.default_rng(0)
    print(f"radix probe on {card_line()}, 2^{a.lanes_log2} lanes",
          flush=True)
    sort_ms = bench("sort-2op-i64", lambda i: sort_run(i, rng, n, device),
                    device, a.iters, a.repeat)
    pack_ms = bench("pack-split", lambda i: pack_run(i, rng, n, device),
                    device, a.iters, a.repeat)
    offs, x = (torch.as_tensor(v, device=device)
               for v in dynstore_inputs(rng))
    # the store loop's repeats are its own iteration axis: per-store cost
    grid_iters = a.iters * 4
    t1 = queued_ms(lambda: dynstore_run(1, offs, x), device, a.repeat)
    tn = queued_ms(lambda: dynstore_run(grid_iters, offs, x), device,
                   a.repeat)
    per_grid = (tn - t1) / (grid_iters - 1)
    per_store_us = per_grid / NSTORES * 1e3
    print(f"{'dynstore':12s} {per_store_us:8.5f} us/store (8x128 rows; "
          f"{per_grid:.5f} ms per 256 stores; device t1 {t1:.5f}, "
          f"t{grid_iters} {tn:.5f} ms)", flush=True)
    radix_arithmetic(a.lanes_log2, sort_ms, pack_ms, per_store_us)
    return dict(sort_ms=sort_ms, pack_ms=pack_ms, per_store_us=per_store_us,
                per_grid_ms=per_grid)


if __name__ == "__main__":
    main()
