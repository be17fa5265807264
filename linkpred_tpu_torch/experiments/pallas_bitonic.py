"""Probe P2: the bitonic sorting network over n = 2^m int32 keys.

Counterpart of ``experiments/pallas_bitonic.py`` (the Pallas kernels
``make_pallas_sort`` and ``make_pallas_sort_kv``: every (k, j) stage of the
network unrolled in one kernel over a VMEM-resident block, with or without
an int32 payload).  P3 (``pallas_bitonic2.py``) computes the same function
from a stage table; on the TPU the two differ only in how Mosaic was made to
compile it.  On the card one CUDA source, ``kernels/csrc/bitonic.cu``, serves
both, as K1's serves P1:

* :func:`bitonic_stages` is the plain PyTorch network, the partner of each
  stage a reshape-flip over the flat lane index;
* :func:`plan_launches` groups a stage table into the kernel's launches:
  one tile launch for a run of stages whose partners lie in one CTA's
  block of :data:`TILE` consecutive lanes, one global launch for up to
  log2(TILE) - :data:`RUN_LOG2` stages of one k above it (a CTA gathers
  runs of 2^RUN_LOG2 consecutive lanes at the stages' strides);
* :func:`make_pallas_sort` and :func:`make_pallas_sort_kv` return functions
  on ``(n / 128, 128)`` int32 tensors, like the JAX ones (without their
  ``interpret`` flag): CPU tensors take :func:`bitonic_stages`, CUDA tensors
  launch the kernel through :func:`sort_network` or raise;
* :func:`run` is the counterpart of the probe's ``main()``.

The function.  Stage (k, j) compare-exchanges lane i with lane i ^ j,
ascending iff (i & k) == 0.  The payload moves only where the key order is
strict: on equal keys each lane keeps its own payload (the probe's
``keep_own``), so the payload is part of the function, lane for lane.  Keys
compare signed.  Unlike the JAX probe, importing this module runs nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.timing import measure_duration

__all__ = ["LANES", "LAUNCHES", "GRID_LAUNCHES", "TILE", "RUN_LOG2",
           "TILE_LAUNCH", "GLOBAL_LAUNCH", "bitonic_stages",
           "compare_exchange", "plan_launches", "make_pallas_sort",
           "make_pallas_sort_kv", "sort_network", "check_n", "check_operand", "run"]

LANES = 128

# Launches of the CUDA kernel by this probe's wrappers (one per sort).
LAUNCHES = 0
# The kernel's grid launches, as bitonic.cu counts them: one per row of a
# sort's launch table (P3's sorts, which run through sort_network, too).
GRID_LAUNCHES = 0

# The limits the kernel is planned for (bitonic.cu kMaxBlockLog2, kHold,
# kTileLaunch, kGlobalLaunch; sort_network refuses a library whose limits
# differ): lanes a CTA holds in shared memory, log2 of the shortest run of
# consecutive lanes a global launch's CTA gathers, and the launch kinds of
# a plan's rows.
TILE = 1 << 13
RUN_LOG2 = 5
TILE_LAUNCH, GLOBAL_LAUNCH = 0, 1


def _stages(n: int):
    """The network's stages (k, j) in order."""
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2
        k *= 2


def compare_exchange(v, p, lane, k: int, j: int):
    """One stage (k, j) over flat int32 lanes ``v`` and payload ``p`` (or
    None); ``lane`` is the lane index.  Returns the new (v, p)."""
    n = v.shape[0]
    vp = v.reshape(n // (2 * j), 2, j).flip(1).reshape(n)
    take_min = ((lane & k) == 0) == ((lane & j) == 0)
    if p is not None:
        pp = p.reshape(n // (2 * j), 2, j).flip(1).reshape(n)
        keep_own = (take_min & (v <= vp)) | (~take_min & (v >= vp))
        p = torch.where(keep_own, p, pp)
    v = torch.where(take_min, torch.minimum(v, vp), torch.maximum(v, vp))
    return v, p


def bitonic_stages(v, n: int, payload=None):
    """The whole network over ``v`` (any shape of n lanes, row-major) and
    ``payload`` (same shape, or None).  Returns the sorted keys, or (keys,
    payload), in ``v``'s shape."""
    shape = v.shape
    lane = torch.arange(n, dtype=torch.int32, device=v.device)
    v = v.reshape(n)
    p = None if payload is None else payload.reshape(n)
    for k, j in _stages(n):
        v, p = compare_exchange(v, p, lane, k, j)
    v = v.reshape(shape)
    return v if payload is None else (v, p.reshape(shape))


def check_n(n: int, what: str) -> None:
    if n < LANES or n & (n - 1):
        raise ValueError(f"{what}: n must be a power of two >= {LANES}, "
                         f"got {n}")


def check_operand(x, n: int, what: str) -> None:
    """Raise unless ``x`` is an int32 ``(n / 128, 128)`` tensor on the CPU
    or a CUDA device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dtype != torch.int32 or tuple(x.shape) != (n // LANES, LANES):
        raise ValueError(f"{what}: expected int32[{n // LANES}, {LANES}], got "
                         f"{x.dtype}{list(x.shape)}")


def _pow2(x: int) -> bool:
    return x > 0 and x & (x - 1) == 0


def plan_launches(ks, js, n: int, tile: int = TILE):
    """Group the stages (ks[s], js[s]) of a network over n lanes into the
    kernel's launches, with tiles of ``min(tile, n)`` lanes (``tile`` below
    :data:`TILE` only in tests, to reach global launches at small n).

    Returns int32[L, 3] rows (kind, first stage, stage count), covering the
    table once, in order: a maximal run of stages with j < tile is one
    ``TILE_LAUNCH`` (the partners lie in one tile); a maximal run with
    j >= tile, which stays in one k, is split evenly into launches of at
    most log2(tile) - ``RUN_LOG2`` stages (``GLOBAL_LAUNCH`` rows).  Raises
    ``ValueError`` for a bad n or tile, or a table whose stages are not the
    network's, each the successor of the one before: (k, j / 2), or
    (2k, k) after j = 1."""
    if n < 1 << RUN_LOG2 or not _pow2(n):
        raise ValueError(f"plan_launches: n must be a power of two >= "
                         f"{1 << RUN_LOG2}, got {n}")
    if tile < 2 << RUN_LOG2 or tile > TILE or not _pow2(tile):
        raise ValueError(f"plan_launches: tile must be a power of two in "
                         f"[{2 << RUN_LOG2}, {TILE}], got {tile}")
    tile = min(tile, n)
    span = tile.bit_length() - 1 - RUN_LOG2
    ks, js = np.asarray(ks).tolist(), np.asarray(js).tolist()
    if len(ks) != len(js):
        raise ValueError("plan_launches: ks and js differ in length")
    for s, (k, j) in enumerate(zip(ks, js)):
        if not (_pow2(k) and _pow2(j) and j < k <= n):
            raise ValueError(f"plan_launches: stage {s} ({k}, {j}) is not "
                             f"a stage of the network over {n} lanes")
        if s:
            pk, pj = ks[s - 1], js[s - 1]
            if (k, j) != ((pk, pj // 2) if pj > 1 else (2 * pk, pk)):
                raise ValueError(f"plan_launches: stage {s} ({k}, {j}) does "
                                 f"not follow ({pk}, {pj}) in the network's "
                                 "order")
    rows, s = [], 0
    while s < len(js):
        small = js[s] < tile
        e = s
        while e < len(js) and (js[e] < tile) == small:
            e += 1
        if small:
            rows.append((TILE_LAUNCH, s, e - s))
        else:
            run = e - s
            groups = -(-run // span)
            for g in range(groups):
                size = run // groups + (g < run % groups)
                rows.append((GLOBAL_LAUNCH, s, size))
                s += size
        s = e
    return np.asarray(rows, np.int32).reshape(-1, 3)


def sort_network(key, payload, ks, js, plan, what: str,
                 tile: int = TILE) -> int:
    """Run the stages (ks[s], js[s]) on the card, grouped into launches by
    ``plan`` (from :func:`plan_launches` with the same ``tile``, a test-only
    argument), in place on the contiguous CUDA tensors ``key`` and
    ``payload`` (or None).  Returns the kernel's grid launches, as the
    library counts them, and adds them to :data:`GRID_LAUNCHES`."""
    from ..kernels import _build

    global GRID_LAUNCHES
    lib = _build.load()
    limits = (ctypes.c_int32 * 4)()
    lib.lp_bitonic_limits(limits)
    planned = (TILE.bit_length() - 1, RUN_LOG2, TILE_LAUNCH, GLOBAL_LAUNCH)
    if tuple(limits) != planned:
        raise RuntimeError(f"{what}: bitonic.cu's limits {tuple(limits)} "
                           f"differ from the planner's {planned}")
    ks = np.ascontiguousarray(ks, dtype=np.int32)
    js = np.ascontiguousarray(js, dtype=np.int32)
    plan = np.ascontiguousarray(plan, dtype=np.int32)
    launched = ctypes.c_int64(0)
    err = lib.lp_bitonic_sort(
        key.device.index, key.data_ptr(),
        None if payload is None else payload.data_ptr(), key.numel(),
        ks.ctypes.data, js.ctypes.data, ks.size, plan.ctypes.data,
        plan.shape[0], min(tile, key.numel()).bit_length() - 1,
        torch.cuda.current_stream(key.device).cuda_stream,
        ctypes.byref(launched))
    GRID_LAUNCHES += launched.value
    _build.check(lib, err, what)
    return launched.value


def _copy(x):
    return x.clone(memory_format=torch.contiguous_format)


def make_pallas_sort(n: int):
    """``f(x)``: ``x`` int32 ``(n / 128, 128)`` sorted ascending, row-major,
    in a new tensor."""
    check_n(n, "make_pallas_sort")
    ks, js = (np.asarray(a, np.int32) for a in zip(*_stages(n)))
    plan = plan_launches(ks, js, n)

    def f(x):
        check_operand(x, n, "make_pallas_sort")
        if x.device.type == "cpu":
            return bitonic_stages(x, n)
        out = _copy(x)
        sort_network(out, None, ks, js, plan, "make_pallas_sort")
        global LAUNCHES
        LAUNCHES += 1
        return out

    return f


def make_pallas_sort_kv(n: int):
    """``f(x, p)``: ``x`` sorted as by :func:`make_pallas_sort`, with the
    int32 payload ``p`` (same shape) moved along; new tensors."""
    check_n(n, "make_pallas_sort_kv")
    ks, js = (np.asarray(a, np.int32) for a in zip(*_stages(n)))
    plan = plan_launches(ks, js, n)

    def f(x, p):
        check_operand(x, n, "make_pallas_sort_kv")
        check_operand(p, n, "make_pallas_sort_kv")
        if p.device != x.device:
            raise ValueError("make_pallas_sort_kv: x and p on different "
                             "devices")
        if x.device.type == "cpu":
            return bitonic_stages(x, n, payload=p)
        out, pout = _copy(x), _copy(p)
        sort_network(out, pout, ks, js, plan, "make_pallas_sort_kv")
        global LAUNCHES
        LAUNCHES += 1
        return out, pout

    return f


def run(log2n: int = 12, payload: bool = False, device="cuda") -> dict:
    """The probe's ``main()``: sort 2^log2n random 31-bit keys, check
    against ``np.sort`` (with ``payload``, also the key-value sort: keys
    sorted and ``x[p] == k``), and on a CUDA device time the sort against
    ``torch.sort`` (plus a payload gather by its indices for the key-value
    sort).  Raises if a check fails.  Returns the times in ms (none on the
    CPU, where nothing is timed).  Each time is the mean of 8 calls after
    a warm-up."""
    n = 1 << log2n
    device = torch.device(device)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 31, n, dtype=np.int32)
    want = np.sort(x)
    xt = torch.as_tensor(x, device=device).reshape(n // LANES, LANES)
    f = make_pallas_sort(n)
    ok = np.array_equal(f(xt).reshape(-1).cpu().numpy(), want)
    print(f"P2 bitonic 2^{log2n} on {device}: sorted correctly: {ok}")
    if not ok:
        raise RuntimeError("P2: keys not sorted")
    timed = device.type == "cuda"
    out = {"n": n}
    if timed:
        flat = xt.reshape(-1)
        out["ms"] = measure_duration(lambda: f(xt), 8, device=device)[0]
        out["library_ms"] = measure_duration(lambda: torch.sort(flat), 8,
                                             device=device)[0]
        print(f"  bitonic {out['ms']:.4f} ms, torch.sort "
              f"{out['library_ms']:.4f} ms per 2^{log2n} sort")
    if payload:
        pay = torch.arange(n, dtype=torch.int32, device=device)
        pt = pay.reshape(n // LANES, LANES)
        fkv = make_pallas_sort_kv(n)
        ks, ps = (a.reshape(-1).cpu().numpy() for a in fkv(xt, pt))
        kv_ok = np.array_equal(ks, want) and np.array_equal(x[ps], ks)
        print(f"  kv sorted correctly: {kv_ok}")
        if not kv_ok:
            raise RuntimeError("P2: key-value sort wrong")
        if timed:
            flat = xt.reshape(-1)

            def library():
                v, idx = torch.sort(flat)
                return v, pay[idx]

            out["kv_ms"] = measure_duration(lambda: fkv(xt, pt), 8,
                                            device=device)[0]
            out["kv_library_ms"] = measure_duration(library, 8,
                                                    device=device)[0]
            print(f"  bitonic kv {out['kv_ms']:.4f} ms, torch.sort + gather "
                  f"{out['kv_library_ms']:.4f} ms per 2^{log2n} sort")
    return out
