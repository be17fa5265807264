"""The post-sort tail of a tile: kernel K1 and its plain twin.

Counterpart of ``linkpred_tpu/ops/fused_tail.py`` (the Pallas kernel
``_tail_kernel``, launched by ``fused_tail``).  After the tile sort, one pass
over the sorted (w, u) lanes computes: the run boundaries, the run-start
position (a cummax), the run length (= the common-neighbour count), the
segmented sum of the AA/RA mid weights, the degree pair, validity (run end,
``w < 2^w_bits``, MAXFACTOR2), each metric's score, the min-score cut, the
descending selection key with invalid lanes spread by lane index, and the
clamped ``ku``/``kw``.

Two branches, as in the reference.  The packed stream dropped dead slots at
plan time, so ``lo`` is the bare source id (``killers=False``).  The edge
stream carries killer slots (``killers=True``): ``lo`` is
``u << 1 | real``, runs are (w, u) pairs compared on ``lo >> 1``, the sort
puts a run's killer first, and a run is alive iff its first slot is real.

``fused_tail`` is the wrapper.  For CPU tensors it runs
:func:`fused_tail_reference`, the plain PyTorch version; for CUDA tensors it
launches ``kernels/csrc/fused_tail.cu`` or raises.
"""
from __future__ import annotations

import torch

from ..predict.metrics import METRICS, MetricSpec, get_metric, maxf2_mask
from .segment import cummax, run_boundaries, segment_run_totals
from .topk import desc_score_key, spread_invalid

__all__ = ["fused_tail", "fused_tail_reference", "fused_tail_supported",
           "score_keys", "LAUNCHES", "KILLER_LAUNCHES", "MAX_CAP"]

# Launches of the CUDA kernel (the wrapper adds one per launch), and of
# those, the launches with the killer branch on.
LAUNCHES = 0
KILLER_LAUNCHES = 0

# Lanes a tile may hold: the run start travels as start << 1 | alive.
MAX_CAP = 1 << 30

_CODES = {name: i for i, name in enumerate(METRICS)}


def fused_tail_supported(*, packed: bool, deg16: bool, metrics,
                         cap: int) -> bool:
    """Whether K1 takes this engine configuration (the reference's
    predicate and signature; ``metrics`` are names or specs).  As there,
    ``packed`` and ``deg16`` do not restrict.

    K1 takes a tile of ``1 <= cap < MAX_CAP`` lanes and up to 16 metrics,
    at most two of them weighted.  Where it differs from the reference's
    ``cap % 128 == 0 and cap >= 128``: K1 runs a tile's ragged ends lane
    by lane, so it needs no rows of 128 lanes and takes the sub-plans'
    caps below 128 and a caller's cap that 128 does not divide; and a run
    start travels as ``start << 1 | alive`` in an int32, so it refuses
    ``cap >= 2^30``, which the planner does not produce (its largest is a
    hub sub-plan's, at most half of ``auto_seg_lanes``' 2^29)."""
    del packed, deg16
    specs = [m if isinstance(m, MetricSpec) else get_metric(m)
             for m in metrics]
    return (0 < cap < MAX_CAP and len(specs) <= 16
            and sum(s.needs_weight for s in specs) <= 2)


def _unpack(degs):
    if len(degs) == 2:
        return degs
    # mask after the shift: deg(u) >= 2^15 sets the int32 sign bit
    return (degs[0] >> 16) & 0xFFFF, degs[0] & 0xFFFF


def score_keys(metrics, cnt, accs, du, dw, valid, min_score, iota):
    """Selection keys ``[M, cap]`` of the scored runs: each metric's score
    where ``valid`` and above ``min_score``, -inf (spread by ``iota``)
    elsewhere.  ``accs`` maps a weighted metric's name to its run sums."""
    cntf = cnt.to(torch.float32)
    rows = []
    for metric in metrics:
        sc = metric.score(cnt, accs.get(metric.name, cntf), du, dw)
        sc = torch.where(valid & (sc > min_score), sc, float("-inf"))
        rows.append(spread_invalid(desc_score_key(sc), sc, iota))
    return torch.stack(rows)


def fused_tail_reference(hi, lo, degs, wts, min_score, *, metrics,
                         w_bits: int, n: int, maxf2: int = 0,
                         killers: bool = False):
    """Plain PyTorch tail; same arguments and results as :func:`fused_tail`."""
    cap = hi.shape[0]
    iota = torch.arange(cap, dtype=torch.int32, device=hi.device)
    src = lo >> 1 if killers else lo
    is_start, is_end = run_boundaries(hi, src)
    valid = is_end & (hi < (1 << w_bits))
    if killers:
        # one max-scan carries the run start and its first slot's flag
        m = cummax(torch.where(is_start, (iota << 1) | (lo & 1), 0))
        start = m >> 1
        valid &= (m & 1) == 1
    else:
        start = cummax(torch.where(is_start, iota, 0))
    cnt = iota - start + 1                     # run length == Nuv
    du, dw = _unpack(degs)
    if maxf2:
        valid &= maxf2_mask(du, dw, maxf2)
    accs = {}
    weighted = [m for m in metrics if m.needs_weight]
    if weighted:
        tots = segment_run_totals(is_start, *wts)
        tots = tots if isinstance(tots, tuple) else (tots,)
        accs = {m.name: t for m, t in zip(weighted, tots)}
    skeys = score_keys(metrics, cnt, accs, du, dw, valid, min_score, iota)
    return skeys, src.clamp(max=n - 1), hi.clamp(max=n - 1)


def fused_tail(hi, lo, degs, wts, min_score, *, metrics, w_bits: int,
               n: int, maxf2: int = 0, killers: bool = False):
    """Run the tail over one sorted tile.

    ``hi``/``lo``: the sorted (candidate id w, source payload) pairs,
    int32[cap]; the payload is the source id u, or ``u << 1 | real`` with
    ``killers``; ``degs``: ``(dpack,)`` deg16-packed pairs
    ``deg(u) << 16 | deg(w)`` or ``(udeg, wdeg)``, int32[cap]; ``wts``: one
    float32[cap] weight array per weighted metric, in ``metrics`` order;
    ``min_score``: a float.
    Returns ``(skeys int32[M, cap], ku int32[cap], kw int32[cap])``: the
    selection keys (``ops/topk.py`` form, spread applied) and the clamped
    pair ids.  Run boundaries come from comparing neighbouring (w, u)
    pairs, which is what the reference's ``neq`` argument held.  Raises
    ``ValueError`` for ``cap >= 2^30``: a run start travels as
    ``start << 1 | alive`` in an int32."""
    cap = hi.shape[0]
    if cap >= MAX_CAP:
        raise ValueError(f"fused_tail: {cap} lanes, the int32 run starts "
                         f"take fewer than {MAX_CAP}")
    if hi.device.type == "cpu":
        return fused_tail_reference(hi, lo, degs, wts, min_score,
                                    metrics=metrics, w_bits=w_bits, n=n,
                                    maxf2=maxf2, killers=killers)
    if hi.device.type != "cuda":
        raise ValueError(f"fused_tail: unsupported device {hi.device}")
    ints = (hi, lo, *degs)
    if len(degs) not in (1, 2) or len(wts) > 2 or len(wts) != sum(
            m.needs_weight for m in metrics) or len(metrics) > 16:
        raise ValueError("fused_tail: bad degree/weight/metric arity")
    for t in (*ints, *wts):
        if t.device != hi.device or t.shape != (cap,) \
                or not t.is_contiguous():
            raise ValueError("fused_tail: operands must be contiguous "
                             f"[{cap}] tensors on {hi.device}")
    if any(t.dtype != torch.int32 for t in ints) \
            or any(w.dtype != torch.float32 for w in wts):
        raise ValueError("fused_tail: int32 keys/degrees, float32 weights")
    from ..kernels import _build

    lib = _build.load()
    dev = hi.device
    # one allocation: skeys, ku and kw start as far past a 16-byte boundary
    # as hi does, so the kernel's 16-byte accesses line up with its loads;
    # then the kernel's scratch (8-byte words)
    head = hi.data_ptr() // 4 % 4
    m = len(metrics)
    o_ku = head + -(-m * cap // 4) * 4
    o_kw = o_ku + -(-cap // 4) * 4
    o_scratch = -(-(o_kw + cap) // 4) * 4
    buf = torch.empty(o_scratch + lib.lp_fused_tail_scratch_bytes(cap) // 4,
                      dtype=torch.int32, device=dev)
    skeys = buf[head: head + m * cap].view(m, cap)
    ku, kw = buf[o_ku: o_ku + cap], buf[o_kw: o_kw + cap]
    codes = 0
    for i, met in enumerate(metrics):
        codes |= _CODES[met.name] << (4 * i)
    err = lib.lp_fused_tail(
        dev.index, hi.data_ptr(), lo.data_ptr(), degs[0].data_ptr(),
        degs[1].data_ptr() if len(degs) == 2 else None,
        wts[0].data_ptr() if len(wts) > 0 else None,
        wts[1].data_ptr() if len(wts) > 1 else None,
        cap, m, codes, w_bits, n, maxf2, float(min_score),
        1 if killers else 0, skeys.data_ptr(), ku.data_ptr(), kw.data_ptr(),
        buf[o_scratch:].data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused_tail")
    global LAUNCHES, KILLER_LAUNCHES
    LAUNCHES += 1
    KILLER_LAUNCHES += bool(killers)
    return skeys, ku, kw
