"""The post-sort tail of a packed tile: kernel K1 and its plain twin.

Counterpart of ``linkpred_tpu/ops/fused_tail.py`` (the Pallas kernel
``_tail_kernel``, launched by ``fused_tail``).  After the tile sort, one pass
over the sorted (w, u) lanes computes: the run boundaries, the run-start
position (a cummax), the run length (= the common-neighbour count), the
segmented sum of the AA/RA mid weights, the degree pair, validity (run end,
``w < 2^w_bits``, MAXFACTOR2), each metric's score, the min-score cut, the
descending selection key with invalid lanes spread by lane index, and the
clamped ``ku``/``kw``.

``fused_tail`` is the wrapper.  For CPU tensors it runs
:func:`fused_tail_reference`, the plain PyTorch version; for CUDA tensors it
launches ``kernels/csrc/fused_tail.cu`` or raises.  The packed stream drops
dead slots at plan time, so the reference's killer-flag branch (the edge
stream's) is not here; it comes with the edge stream.
"""
from __future__ import annotations

import torch

from ..predict.metrics import METRICS, maxf2_mask
from .segment import cummax, run_boundaries, segment_run_totals
from .topk import desc_score_key, spread_invalid

__all__ = ["fused_tail", "fused_tail_reference", "LAUNCHES"]

# Launches of the CUDA kernel (the wrapper adds one per launch).
LAUNCHES = 0

_CODES = {name: i for i, name in enumerate(METRICS)}


def _unpack(degs):
    if len(degs) == 2:
        return degs
    # mask after the shift: deg(u) >= 2^15 sets the int32 sign bit
    return (degs[0] >> 16) & 0xFFFF, degs[0] & 0xFFFF


def fused_tail_reference(hi, lo, degs, wts, min_score, *, metrics,
                         w_bits: int, n: int, maxf2: int = 0):
    """Plain PyTorch tail; same arguments and results as :func:`fused_tail`."""
    cap = hi.shape[0]
    iota = torch.arange(cap, dtype=torch.int32, device=hi.device)
    is_start, is_end = run_boundaries(hi, lo)
    start = cummax(torch.where(is_start, iota, 0))
    cnt = iota - start + 1                     # run length == Nuv
    du, dw = _unpack(degs)
    valid = is_end & (hi < (1 << w_bits))
    if maxf2:
        valid &= maxf2_mask(du, dw, maxf2)
    accs = {}
    weighted = [m for m in metrics if m.needs_weight]
    if weighted:
        tots = segment_run_totals(is_start, *wts)
        tots = tots if isinstance(tots, tuple) else (tots,)
        accs = {m.name: t for m, t in zip(weighted, tots)}
    cntf = cnt.to(torch.float32)
    rows = []
    for metric in metrics:
        sc = metric.score(cnt, accs.get(metric.name, cntf), du, dw)
        sc = torch.where(valid & (sc > min_score), sc, float("-inf"))
        rows.append(spread_invalid(desc_score_key(sc), sc, iota))
    return torch.stack(rows), lo.clamp(max=n - 1), hi.clamp(max=n - 1)


def fused_tail(hi, lo, degs, wts, min_score, *, metrics, w_bits: int,
               n: int, maxf2: int = 0):
    """Run the tail over one sorted tile.

    ``hi``/``lo``: the sorted (candidate id w, source id u) pairs, int32[cap];
    ``degs``: ``(dpack,)`` deg16-packed pairs ``deg(u) << 16 | deg(w)`` or
    ``(udeg, wdeg)``, int32[cap]; ``wts``: one float32[cap] weight array per
    weighted metric, in ``metrics`` order; ``min_score``: a float.
    Returns ``(skeys int32[M, cap], ku int32[cap], kw int32[cap])``: the
    selection keys (``ops/topk.py`` form, spread applied) and the clamped
    pair ids.  Run boundaries come from comparing neighbouring (hi, lo)
    pairs, which is what the reference's ``neq`` argument held."""
    if hi.device.type == "cpu":
        return fused_tail_reference(hi, lo, degs, wts, min_score,
                                    metrics=metrics, w_bits=w_bits, n=n,
                                    maxf2=maxf2)
    if hi.device.type != "cuda":
        raise ValueError(f"fused_tail: unsupported device {hi.device}")
    cap = hi.shape[0]
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
    skeys = torch.empty((len(metrics), cap), dtype=torch.int32, device=dev)
    ku = torch.empty(cap, dtype=torch.int32, device=dev)
    kw = torch.empty(cap, dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.lp_fused_tail_scratch_bytes(cap),
                          dtype=torch.uint8, device=dev)
    codes = 0
    for i, m in enumerate(metrics):
        codes |= _CODES[m.name] << (4 * i)
    err = lib.lp_fused_tail(
        dev.index, hi.data_ptr(), lo.data_ptr(), degs[0].data_ptr(),
        degs[1].data_ptr() if len(degs) == 2 else None,
        wts[0].data_ptr() if len(wts) > 0 else None,
        wts[1].data_ptr() if len(wts) > 1 else None,
        cap, len(metrics), codes, w_bits, n, maxf2, float(min_score),
        skeys.data_ptr(), ku.data_ptr(), kw.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "fused_tail")
    global LAUNCHES
    LAUNCHES += 1
    return skeys, ku, kw
