"""The scoring engine on the packed slot stream: window reads → one sort on
the int64 key (w, u) → the fused tail (K1) → deferred top-k selection with
the survivor pack (K2).

Counterpart of ``linkpred_tpu/predict/scoring.py``, packed path and key64
engine only.  Per tile: the tile's slot window (a view), one ``torch.sort``
of ``w << 32 | u`` with the degree pair and AA/RA weights gathered through
the permutation, then ``ops.fused_tail``.  Every tile's selection keys and
(u, v) lanes go to one buffer, and one selection per metric over all lanes
picks the top k (``_select_topk``).

Not ported yet (``api.predict_links_multi`` raises ``NotImplementedError``
for them): the edge stream (``packed=False``, ROADMAP A8), the u32 engine
(``key64=False``; the port keeps one engine), the host scorer for mega-hubs
(``host_src``) and the mesh.  The reference's chunked dispatch existed only
for its device relay and is not ported.
"""
from __future__ import annotations

import torch

from ..ops import compact
from ..ops.compact import pack_survivors, sample_threshold
from ..ops.fused_tail import fused_tail
from ..ops.topk import TopK, desc_key_score, desc_score_key, spread_invalid
from .metrics import METRICS

__all__ = ["score_tiles", "scan_tiles", "tile_candidates_packed"]

# Lane bound of one deferred-selection segment (single-metric basis).
# ``None`` sizes it from the device's memory (utils/device.py); tests patch
# a concrete int to reach the segmented branch.
SEG_LANES = None

# Smallest selection buffer that takes the survivor pack (the reference's
# value); tests patch it to reach the pack at small sizes.
SEL_PACK_MIN = 1 << 22

# Which arm of _argselect_packed ran (plain counts, read by the smoke run).
PACKED_ARM_RUNS = 0
SORT_ARM_RUNS = 0


def _seg_lanes(device) -> int:
    if SEG_LANES is not None:
        return SEG_LANES
    from ..utils.device import auto_seg_lanes
    return auto_seg_lanes(device)


def _pad_key(iota, w_bits: int):
    """Keys of padding lanes: one value range above every candidate id,
    spread by lane index."""
    return (1 << w_bits) | (iota & 1023)


def _keyed_sort_reduce(key, src, udeg, wdeg, wts, metrics, *, w_bits: int,
                       n: int, maxf2: int, min_score: float, deg16: bool):
    """One sort of the int64 key ``w << 32 | src`` (src zero-extended; the
    degree pair and weights are gathered through the permutation), then
    the fused tail.  Grouping is by the whole key, so runs are (w, u)
    pairs.  Returns ``(skeys [M, cap], ku, kw)``."""
    k64 = ((key.to(torch.int64) & 0xFFFFFFFF) << 32) \
        | (src.to(torch.int64) & 0xFFFFFFFF)
    # stable: the weights' order inside a run, and so their float sums, is
    # the same from run to run
    k64, perm = torch.sort(k64, stable=True)
    hi = (k64 >> 32).to(torch.int32)
    lo = (k64 & 0xFFFFFFFF).to(torch.int32)
    degs = (udeg[perm],) if deg16 else (udeg[perm], wdeg[perm])
    return fused_tail(hi, lo, degs, [w[perm] for w in wts], min_score,
                      metrics=metrics, w_bits=w_bits, n=n, maxf2=maxf2)


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
    seg_lanes = max(cap, _seg_lanes(device) * 12 // (4 * num_metrics + 8))
    seg = max(1, seg_lanes // cap)
    lane = torch.arange(cap, dtype=torch.int32, device=device)
    # what an empty tile emits: key(-inf) with the lane spread
    empty_key = (0x7F800000 | (lane & 0x7FFFFE)).expand(num_metrics, cap)

    def run(tiles):
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

    if t_pad <= seg:
        return _select_topk(*run(range(t_pad)), k)
    # balanced segments (a segment selects over all its lanes, ghost or not)
    n_seg = -(-t_pad // seg)
    seg = -(-t_pad // n_seg)
    kk = min(k, seg * cap)
    tops = [_select_topk(*run(range(s * seg, (s + 1) * seg)), kk,
                         allow_pack=False) for s in range(n_seg)]
    return _merge_stacked(TopK(*(torch.stack(parts) for parts in zip(*tops))),
                          k)


def score_tiles(stream, tile_start, min_score: float, *, metric_names,
                cap: int, k: int, n: int, maxf2: int = 0, w_bits: int,
                deg16: bool, device) -> TopK:
    """Score every tile for each metric in ``metric_names`` in one shared
    expansion+sort pass; returns TopK of [M, k'] (k' = min(k, lanes)).

    ``stream`` is ``TilePlan.device_stream(device, weighted)``;
    ``tile_start`` the plan's host tile bounds; ``n`` the vertex count."""
    metrics = tuple(METRICS[name] for name in metric_names)
    slot_w, slot_u, slot_udeg, slot_wdeg, slot_middeg = stream

    def tile_fn(t_start, t_end):
        return tile_candidates_packed(
            slot_w, slot_u, slot_udeg, slot_wdeg, slot_middeg, t_start,
            t_end, metrics=metrics, cap=cap, maxf2=maxf2,
            min_score=min_score, w_bits=w_bits, n=n, deg16=deg16)

    return scan_tiles(tile_fn, tile_start, k, len(metrics), cap,
                      device=device)
