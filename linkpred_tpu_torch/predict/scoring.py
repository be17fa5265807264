"""The scoring engine: per tile, one sort on the int64 key (w, u) → the
fused tail (K1); then the deferred top-k selection with the survivor pack
(K2).

Counterpart of ``linkpred_tpu/predict/scoring.py``, key64 engine only.  Two
streams, as the plan decides:

* the packed slot stream (``tile_candidates_packed``): the tile's slot
  window (a view) is sorted on ``w << 32 | u`` with the degree pair and the
  AA/RA weights gathered through the permutation;
* the edge stream (``tile_candidates``, IHub at scale): the tile's edge rows
  are expanded on the device (an inclusive prefix of the tile's rows'
  slot counts, and a binary search of it for each lane's row), the
  candidates gathered from the CSR ``indices``, and the killer rows' slots
  ride the sort with a flag in the low bit of ``u << 1 | real`` (K1's
  killer branch).  Ids too wide for the w key (n > 2^30) take the
  sentinel two-key branch, plain torch.

Every tile's selection keys and (u, v) lanes go to one buffer, and one
selection per metric over all lanes picks the top k (``_select_topk``);
large scans select per segment of tiles and merge the winners.  Hub sources
too big for the device are scored on the host
(``score_huge_sources_host_multi``).

Not ported: the u32 engine (``key64=False``; the port keeps one engine) and
the mesh.  The reference's chunked dispatch existed only for its device
relay.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import compact
from ..ops.compact import pack_survivors, sample_threshold
from ..ops.fused_tail import fused_tail, score_keys
from ..ops.segment import run_boundaries, segment_run_totals
from ..ops.topk import TopK, desc_key_score, desc_score_key, spread_invalid
from .metrics import METRICS, maxf2_mask
from .plan import KILL

__all__ = ["score_tiles", "scan_tiles", "tile_scorer", "tile_candidates",
           "tile_candidates_packed", "edge_keys", "keyed_sort", "pack_pair",
           "score_huge_sources_host_multi", "score_huge_sources_host"]

# Key of dead lanes in the sentinel two-key branch: sorts after every id.
_SENTINEL = (1 << 31) - 1

# Lane bound of one deferred-selection segment (single-metric basis).
# ``None`` sizes it from the device's memory (utils/device.py); tests patch
# a concrete int to reach the segmented branch.
SEG_LANES = None

# Smallest selection buffer that takes the survivor pack (the reference's
# value); tests patch it to reach the pack at small sizes.
SEL_PACK_MIN = 1 << 22

# Which arm of _argselect_packed ran, and how many segments the segmented
# selection of scan_tiles selected over (plain counts, read by the smoke
# run).
PACKED_ARM_RUNS = 0
SORT_ARM_RUNS = 0
SEGMENT_RUNS = 0


def _seg_lanes(device) -> int:
    if SEG_LANES is not None:
        return SEG_LANES
    from ..utils.device import auto_seg_lanes
    return auto_seg_lanes(device)


def _pad_key(iota, w_bits: int):
    """Keys of padding lanes: one value range above every candidate id,
    spread by lane index."""
    return (1 << w_bits) | (iota & 1023)


def pack_pair(udeg, wdeg):
    """The deg16 pair ``deg(u) << 16 | deg(w)`` as int32 bits, packed
    through int64 (a deg(u) >= 2^15 sets the int32 sign bit)."""
    return ((udeg.to(torch.int64) << 16) | wdeg.to(torch.int64)) \
        .to(torch.int32)


def keyed_sort(key, upay, udeg, wdeg, wts, *, deg16: bool,
               predpacked: bool = True):
    """One sort of the int64 key ``w << 32 | upay`` (both zero-extended);
    the degree payload and the weights are gathered through the
    permutation.  With ``deg16`` the payload is one packed pair: ``udeg``
    already holds it when ``predpacked`` (the packed stream), else it is
    packed here before the sort (the edge stream).  Returns the sorted
    ``(hi, lo, degs, wts)`` that :func:`fused_tail` takes."""
    k64 = ((key.to(torch.int64) & 0xFFFFFFFF) << 32) \
        | (upay.to(torch.int64) & 0xFFFFFFFF)
    # stable: the weights' order inside a run, and so their float sums, is
    # the same from run to run
    k64, perm = torch.sort(k64, stable=True)
    hi = (k64 >> 32).to(torch.int32)
    lo = (k64 & 0xFFFFFFFF).to(torch.int32)
    if deg16:
        degs = ((udeg if predpacked else pack_pair(udeg, wdeg))[perm],)
    else:
        degs = (udeg[perm], wdeg[perm])
    return hi, lo, degs, [w[perm] for w in wts]


def _keyed_sort_reduce(key, upay, udeg, wdeg, wts, metrics, *, w_bits: int,
                       n: int, maxf2: int, min_score: float, deg16: bool,
                       killers: bool = False, predpacked: bool = True):
    """:func:`keyed_sort`, then the fused tail.  Grouping is by the whole
    key, so runs are (w, u) pairs; with ``killers`` the low bit of ``upay``
    is the real/killer flag, so a run's killers sort first.  Returns
    ``(skeys [M, cap], ku, kw)``."""
    hi, lo, degs, wts = keyed_sort(key, upay, udeg, wdeg, wts, deg16=deg16,
                                   predpacked=predpacked)
    return fused_tail(hi, lo, degs, wts, min_score, metrics=metrics,
                      w_bits=w_bits, n=n, maxf2=maxf2, killers=killers)


def tile_candidates_packed(
    slot_w, slot_u, slot_udeg, slot_wdeg, slot_middeg, t_start: int,
    t_end: int, *, metrics, cap: int, maxf2: int, min_score: float,
    w_bits: int, n: int, deg16: bool,
):
    """Score one tile of the packed slot stream: every per-slot quantity is a
    window read (no gathers before the sort); with ``deg16`` the degree pair
    is pre-packed in ``slot_udeg``.  Returns ``(skeys [M, cap], ku, kw)``."""
    iota = torch.arange(cap, dtype=torch.int32, device=slot_w.device)

    def window(a):
        return a[t_start: t_start + cap]

    src = window(slot_u)
    udeg = window(slot_udeg)
    wdeg = udeg if deg16 else window(slot_wdeg)
    lanes = iota < (t_end - t_start)
    key = torch.where(lanes, window(slot_w), _pad_key(iota, w_bits))
    weighted = [m for m in metrics if m.needs_weight]
    wts = []
    if weighted:
        middeg = window(slot_middeg)
        wts = [torch.where(lanes, m.weight_from_degree(middeg), 0.0)
               for m in weighted]
    return _keyed_sort_reduce(key, src, udeg, wdeg, wts, metrics,
                              w_bits=w_bits, n=n, maxf2=maxf2,
                              min_score=min_score, deg16=deg16)


def _slot_map(fe_work, t_start: int, t_end: int, iota):
    """One edge tile's slot -> row map, from the tile's own rows.

    ``fe_work[t_start:t_end]`` are the tile's rows (the first ``cap =
    len(iota)`` of them; one row when the tile has none, as the window of
    an empty tile reads its first row).  Lane ``l`` belongs to the row
    whose slot range ``[incl - work, incl)`` holds it: a binary search of
    the rows' inclusive slot prefix, where ``right=True`` steps over rows
    without work.  A dead lane (``l >= total``) searches ``total - 1``
    instead, so it takes the last row with work, or row 0 when no row has
    any: the row the reference's scatter of row starts and running max
    give it.  ``iota`` is the int32 lane ids.  Returns ``(rows, eprefix,
    total, eloc)``: the rows' slice of the stream, their exclusive slot
    prefix, the tile's slot total (a 1-lane tensor) and the int64 row of
    each lane."""
    nrows = min(t_end - t_start, iota.shape[0])
    rows = slice(t_start, t_start + max(nrows, 1))
    ework = fe_work[rows] if nrows > 0 else torch.zeros(
        1, dtype=fe_work.dtype, device=fe_work.device)
    incl = torch.cumsum(ework, 0, dtype=torch.int32)
    total = incl[-1:]
    eloc = torch.searchsorted(incl, torch.minimum(iota, total - 1),
                              right=True)
    return rows, incl - ework, total, eloc


def _edge_slots(indices, stream, t_start: int, t_end: int, *, cap: int,
                weighted: bool):
    """Build one edge tile's slot map on the device (:func:`_slot_map`)
    and gather each slot's candidate.  ``stream`` is the plan's
    ``(fe_work, fe_adr, fe_usrc, fe_middeg)``.  Returns ``(iota, svalid, w,
    u, real, dmid)``: lane ids, live slots, candidate w, source u, real (not
    a killer row), and deg(mid) (None unless ``weighted``)."""
    fe_work, fe_adr, fe_usrc, fe_middeg = stream
    # the plan pads fe_* to m1 + cap, so every tile's window lies inside
    # the stream (the reference's dynamic_slice would clamp its start)
    if t_start + cap > fe_work.shape[0]:
        raise ValueError(f"edge window [{t_start}, +{cap}) runs past "
                         f"the stream ({fe_work.shape[0]} rows)")
    iota = torch.arange(cap, dtype=torch.int32, device=fe_work.device)
    rows, eprefix, total, eloc = _slot_map(fe_work, t_start, t_end, iota)
    svalid = iota < total
    # adr = fe_adr[row] + (lane - eprefix[row]): one gather for both.
    # Lanes past the tile's total read past their row; the reference's
    # gather clamps there, and so does this one (those slots are dead).
    adr = (fe_adr[rows] - eprefix)[eloc] + iota
    w = indices[adr.clamp_(max=indices.shape[0] - 1).to(torch.int64)]
    raw = fe_usrc[rows][eloc]
    real = raw >= 0                         # killer rows store ~src
    u = torch.where(real, raw, ~raw)
    dmid = fe_middeg[rows][eloc] if weighted else None
    return iota, svalid, w, u, real, dmid


def edge_keys(indices, degrees, stream, t_start: int, t_end: int, *,
              metrics, cap: int, w_bits: int, upper_only: bool):
    """The keyed edge tile up to its sort: the slot map and gathers
    (:func:`_edge_slots`), then the sort inputs ``(key, upay, udeg, wdeg,
    wts)`` of :func:`keyed_sort`: dead lanes (past the tile's slots, and
    ``w == u`` in serving mode) take the pad key, ``upay = u << 1 | real``,
    the degrees come from clamped ids, and the AA/RA weights are those of
    live real slots."""
    weighted = [m for m in metrics if m.needs_weight]
    iota, svalid, w, u, real, dmid = _edge_slots(
        indices, stream, t_start, t_end, cap=cap, weighted=bool(weighted))
    n = degrees.shape[0]
    # upper_only plans dropped w <= u at plan time already
    dead = ~svalid if upper_only else (~svalid | (w == u))
    key = torch.where(dead, _pad_key(iota, w_bits), w)
    upay = (u << 1) | real.to(torch.int32)
    udeg = degrees[u.clamp(0, n - 1).to(torch.int64)]
    wdeg = degrees[w.clamp(0, n - 1).to(torch.int64)]
    live = svalid & real
    wts = [torch.where(live, m.weight_from_degree(dmid), 0.0)
           for m in weighted]
    return key, upay, udeg, wdeg, wts


def _sentinel_reduce(degrees, slots, metrics, *, upper_only: bool,
                     maxf2: int, min_score: float):
    """The sentinel two-key branch (ids too wide for the w key): one sort
    of ``ku << 32 | kw`` with the counts and weights as payloads; a killer
    adds ``KILL``, so a run is valid iff its count total is > 0."""
    iota, svalid, w, u, real, dmid = slots
    n = degrees.shape[0]
    cand = svalid & ((w > u) if upper_only else (w != u))
    ku = torch.where(cand, u, _SENTINEL)
    kw = torch.where(cand, w, _SENTINEL)
    cnt = torch.where(cand, torch.where(real, 1, KILL), 0).to(torch.int32)
    weighted = [m for m in metrics if m.needs_weight]
    wts = [torch.where(cnt > 0, m.weight_from_degree(dmid), 0.0)
           for m in weighted]
    k64, perm = torch.sort((ku.to(torch.int64) << 32) | kw.to(torch.int64),
                           stable=True)
    ku = (k64 >> 32).to(torch.int32)
    kw = (k64 & 0xFFFFFFFF).to(torch.int32)
    is_start, is_end = run_boundaries(ku, kw)
    tots = segment_run_totals(is_start, cnt[perm], *[x[perm] for x in wts])
    tots = tots if isinstance(tots, tuple) else (tots,)
    accs = {m.name: t for m, t in zip(weighted, tots[1:])}
    valid = is_end & (ku != _SENTINEL) & (tots[0] > 0)
    ku, kw = ku.clamp(max=n - 1), kw.clamp(max=n - 1)
    du, dw = degrees[ku.to(torch.int64)], degrees[kw.to(torch.int64)]
    if maxf2:
        valid &= maxf2_mask(du, dw, maxf2)
    return (score_keys(metrics, tots[0].clamp(min=0), accs, du, dw, valid,
                       min_score, iota), ku, kw)


def tile_candidates(indices, degrees, stream, t_start: int, t_end: int, *,
                    metrics, cap: int, maxf2: int, min_score: float,
                    w_bits: int, deg16: bool, upper_only: bool):
    """Score one tile of the edge stream.  ``w_bits > 0``: the keyed
    branch (:func:`edge_keys`, one int64 sort, K1 with killers);
    ``w_bits == 0``: the sentinel two-key branch.  Returns
    ``(skeys [M, cap], ku, kw)``."""
    if w_bits:
        key, upay, udeg, wdeg, wts = edge_keys(
            indices, degrees, stream, t_start, t_end, metrics=metrics,
            cap=cap, w_bits=w_bits, upper_only=upper_only)
        return _keyed_sort_reduce(key, upay, udeg, wdeg, wts, metrics,
                                  w_bits=w_bits, n=degrees.shape[0],
                                  maxf2=maxf2, min_score=min_score,
                                  deg16=deg16, killers=True,
                                  predpacked=False)
    slots = _edge_slots(indices, stream, t_start, t_end, cap=cap,
                        weighted=any(m.needs_weight for m in metrics))
    return _sentinel_reduce(degrees, slots, metrics, upper_only=upper_only,
                            maxf2=maxf2, min_score=min_score)


def _argselect_sort(key, kk: int):
    """The kk smallest keys and their lane indices by one full sort.  (The
    reference sorts in 2^23-lane blocks because its sort's cost per lane
    grows with length on the TPU; torch.sort is a radix sort, so one sort
    per level is kept.)"""
    sk, order = torch.sort(key)
    return sk[:kk], order[:kk]


def _argselect_packed(key, kk: int):
    """Exact kk smallest keys via the sampled threshold and the survivor
    pack, sorting only the survivors; when the sample undershot
    (count < kk) or the survivors overflow the pack (count > capacity), the
    full sort runs instead.  One host sync reads the count."""
    global PACKED_ARM_RUNS, SORT_ARM_RUNS
    thr, _ = sample_threshold(key, kk)
    pk, pidx, cnt = pack_survivors(key, thr)
    count = int(cnt)
    if kk <= count <= pk.shape[0]:
        PACKED_ARM_RUNS += 1
        # only the live prefix needs sorting (shapes may vary here)
        sk, order = torch.sort(pk[:count])
        return sk[:kk], pidx[order[:kk]].to(torch.int64)
    SORT_ARM_RUNS += 1
    return _argselect_sort(key, kk)


def _argselect(key, kk: int, allow_pack: bool = True):
    """The kk smallest keys of int32 ``key`` and their lane indices: the
    survivor pack where it pays (large buffer, kk a small fraction; the
    reference's rule), one full sort otherwise."""
    total = key.shape[0]
    if (allow_pack and total >= SEL_PACK_MIN
            and kk * 4 <= total // compact.PACK_RATIO):
        return _argselect_packed(key, kk)
    return _argselect_sort(key, kk)


def _select_topk(keys, us, vs, k: int, allow_pack: bool = True) -> TopK:
    """One selection per metric over ready-made selection keys
    ``keys [M, total]`` and the lanes' pairs ``us``/``vs [total]``;
    returns TopK of [M, min(k, total)]."""
    kk = min(k, keys.shape[1])
    out_s, out_u, out_v = [], [], []
    for row in keys:
        sk, idx = _argselect(row, kk, allow_pack)
        out_s.append(desc_key_score(sk))
        out_u.append(us[idx])
        out_v.append(vs[idx])
    return TopK(torch.stack(out_s), torch.stack(out_u), torch.stack(out_v))


def _merge_stacked(stacked: TopK, k: int) -> TopK:
    """Merge per-segment winners [S, M, kk] into [M, k]: one selection per
    metric over the S*kk candidates."""
    outs = []
    for i in range(stacked.scores.shape[1]):
        scores = stacked.scores[:, i, :].reshape(-1)
        lane = torch.arange(scores.shape[0], dtype=torch.int32,
                            device=scores.device)
        key = spread_invalid(desc_score_key(scores), scores, lane)
        outs.append(_select_topk(key[None], stacked.u[:, i, :].reshape(-1),
                                 stacked.v[:, i, :].reshape(-1), k))
    return TopK(*(torch.cat(parts) for parts in zip(*outs)))


def _segments(t_pad: int, cap: int, num_metrics: int, device):
    """``(n_seg, seg)``: how many segments of ``seg`` tiles the selection
    of a ``t_pad``-tile pass runs over; ``(1, t_pad)`` when its buffer fits
    the segment bound.  Segments are balanced."""
    seg_lanes = max(cap, _seg_lanes(device) * 12 // (4 * num_metrics + 8))
    seg = max(1, seg_lanes // cap)
    if t_pad <= seg:
        return 1, t_pad
    n_seg = -(-t_pad // seg)
    return n_seg, -(-t_pad // n_seg)


def _fill_buffer(tile_fn, tile_start, tiles, num_metrics: int, cap: int,
                 device):
    """Score ``tiles`` (indices into the tile bounds; those past the last
    bound are ghosts) into one buffer ``(keys [M, len * cap], us, vs)``."""
    t_pad = len(tile_start) - 1
    lane = torch.arange(cap, dtype=torch.int32, device=device)
    # what an empty tile emits: key(-inf) with the lane spread
    empty_key = (0x7F800000 | (lane & 0x7FFFFE)).expand(num_metrics, cap)
    keys = torch.empty((num_metrics, len(tiles) * cap), dtype=torch.int32,
                       device=device)
    us = torch.zeros(len(tiles) * cap, dtype=torch.int32, device=device)
    vs = torch.zeros(len(tiles) * cap, dtype=torch.int32, device=device)
    for j, t in enumerate(tiles):
        sl = slice(j * cap, (j + 1) * cap)
        s, e = (int(tile_start[t]), int(tile_start[t + 1])) \
            if t < t_pad else (0, 0)
        if s < e:
            keys[:, sl], us[sl], vs[sl] = tile_fn(s, e)
        else:
            keys[:, sl] = empty_key
    return keys, us, vs


def scan_tiles(tile_fn, tile_start, k: int, num_metrics: int, cap: int,
               *, device) -> TopK:
    """Run ``tile_fn(t_start, t_end) -> (skeys [M, cap], u, v)`` over every
    non-empty tile (a Python loop over the host tile bounds), buffer all
    lanes, and select the global top k.

    Plans whose buffer would exceed the segment bound select per segment of
    tiles and merge the segments' winners (exact: a global winner is in its
    segment's top k); segments skip the survivor pack, as in the
    reference."""
    t_pad = len(tile_start) - 1
    n_seg, seg = _segments(t_pad, cap, num_metrics, device)
    if n_seg == 1:
        return _select_topk(*_fill_buffer(tile_fn, tile_start, range(t_pad),
                                          num_metrics, cap, device), k)
    # a segment selects over all its lanes, ghost or not
    global SEGMENT_RUNS
    kk = min(k, seg * cap)
    SEGMENT_RUNS += n_seg
    tops = [_select_topk(*_fill_buffer(tile_fn, tile_start,
                                       range(s * seg, (s + 1) * seg),
                                       num_metrics, cap, device), kk,
                         allow_pack=False) for s in range(n_seg)]
    return _merge_stacked(TopK(*(torch.stack(parts) for parts in zip(*tops))),
                          k)


def tile_scorer(stream, *, metric_names, cap: int, n: int, maxf2: int = 0,
                min_score: float = 0.0, w_bits: int, deg16: bool,
                packed: bool = True, indices=None, degrees=None,
                upper_only: bool = True):
    """``tile_fn(t_start, t_end) -> (skeys [M, cap], ku, kw)`` for one
    pass, as :func:`scan_tiles` takes it.

    ``stream`` is ``TilePlan.device_stream(device, weighted)``; ``n`` the
    vertex count.  Edge-stream plans (``packed=False``) also read the device
    CSR ``indices``/``degrees`` and score pairs w > u, or w != u in serving
    mode (``upper_only=False``); ``w_bits=0`` takes the sentinel branch."""
    metrics = tuple(METRICS[name] for name in metric_names)
    kw = dict(metrics=metrics, cap=cap, maxf2=maxf2, min_score=min_score,
              w_bits=w_bits, deg16=deg16)
    if packed:
        def tile_fn(t_start, t_end):
            return tile_candidates_packed(*stream, t_start, t_end, n=n, **kw)
    else:
        def tile_fn(t_start, t_end):
            return tile_candidates(indices, degrees, stream, t_start, t_end,
                                   upper_only=upper_only, **kw)
    return tile_fn


def score_tiles(stream, tile_start, min_score: float, *, metric_names,
                k: int, device, **kw) -> TopK:
    """Score every tile for each metric in ``metric_names`` in one shared
    expansion+sort pass; returns TopK of [M, k'] (k' = min(k, lanes)).
    ``tile_start`` is the plan's host tile bounds; the other keywords are
    :func:`tile_scorer`'s."""
    tile_fn = tile_scorer(stream, metric_names=metric_names,
                          min_score=min_score, **kw)
    return scan_tiles(tile_fn, tile_start, k, len(metric_names), kw["cap"],
                      device=device)


def score_huge_sources_host_multi(g, huge_src, metrics, min_degree1: int,
                                  maxf2: int, min_score: float,
                                  k: Optional[int] = None,
                                  upper_only: bool = True):
    """Exact host scoring of hub sources whose expansion exceeds what one
    device tile may hold (``plan.host_src``), every metric from one
    expansion per source: a dense per-source count by ``np.bincount``, the
    analog of the reference's dense scratch.  NumPy in float64
    (``MetricSpec.score``/``weight_from_degree`` with ``xp=np``), as the
    reference's host scorer.  Keeps each source's best ``k`` per metric.
    Returns ``{metric_name: (scores f32[*], u i32[*], w i32[*])}``."""
    g = g.host()
    deg = np.asarray(g.degrees, dtype=np.int64)
    offsets = np.asarray(g.offsets, dtype=np.int64)
    indices = np.asarray(g.indices, dtype=np.int64)
    out = {m.name: ([], [], []) for m in metrics}
    for u in np.asarray(huge_src, dtype=np.int64):
        nbrs = indices[offsets[u]: offsets[u] + deg[u]]
        ok = deg[nbrs] > 0
        if min_degree1:
            ok &= deg[nbrs] <= min_degree1
        mids = nbrs[ok]
        if mids.size == 0:
            continue
        dm = deg[mids]
        # every neighbour of every mid (repeat + offset trick)
        base = np.repeat(offsets[mids], dm)
        step = np.arange(base.shape[0], dtype=np.int64) - np.repeat(
            np.cumsum(dm) - dm, dm)
        cand = indices[base + step]
        sel = (cand > u) if upper_only else (cand != u)
        cand = cand[sel]
        cnt = np.bincount(cand, minlength=g.n).astype(np.int64)
        accs = {m.name: np.bincount(
                    cand, weights=np.repeat(
                        m.weight_from_degree(dm, xp=np), dm)[sel],
                    minlength=g.n)
                for m in metrics if m.needs_weight}
        # drop self and first-order neighbours
        cnt[nbrs] = 0
        cnt[u] = 0
        ws_all = np.nonzero(cnt > 0)[0]
        if ws_all.size == 0:
            continue
        du, dws = float(deg[u]), deg[ws_all].astype(np.float64)
        nuv = cnt[ws_all].astype(np.float64)
        for m in metrics:
            acc = accs[m.name][ws_all] if m.needs_weight else nuv
            s = m.score(nuv, acc, du, dws, xp=np).astype(np.float32)
            keep = s > min_score
            if maxf2:
                keep &= maxf2_mask(du, dws, maxf2)
            ws, s = ws_all[keep], s[keep]
            if k is not None and s.shape[0] > k:
                top = np.argpartition(-s, k - 1)[:k]
                ws, s = ws[top], s[top]
            o = out[m.name]
            o[0].append(s)
            o[1].append(np.full(ws.shape[0], u, dtype=np.int32))
            o[2].append(ws.astype(np.int32))

    def cat(lists):
        if not lists[0]:
            return (np.empty(0, dtype=np.float32),
                    np.empty(0, dtype=np.int32), np.empty(0, dtype=np.int32))
        return tuple(np.concatenate(x) for x in lists)

    return {name: cat(lists) for name, lists in out.items()}


def score_huge_sources_host(g, huge_src, metric, min_degree1: int,
                            maxf2: int, min_score: float,
                            k: Optional[int] = None, upper_only: bool = True):
    """Single-metric :func:`score_huge_sources_host_multi`; returns
    ``(scores, u, w)``."""
    return score_huge_sources_host_multi(
        g, huge_src, (metric,), min_degree1, maxf2, min_score, k=k,
        upper_only=upper_only)[metric.name]
