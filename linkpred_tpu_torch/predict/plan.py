"""Work-balanced tiling plan for the second-hop expansion.

Counterpart of ``linkpred_tpu/predict/plan.py``: the same host planner in
NumPy (plus the native C++ expansion), producing the reference's plan field
for field — ``tests/test_torch_plan.py`` pins that.  What differs:

* the memory budgets are sized for the target ``device`` (the card unless
  the caller names the CPU);
* ``TilePlan.device_stream(device, weighted)`` uploads torch tensors, once
  per plan and device (the slot stream, or the edge stream's ``fe_*`` rows),
  and uploads the deg(mid) array only when a weighted metric asks for it.

The plan: filter first-hop edges (u → mid) by the LHub mask
``deg(mid) <= min_degree1``; expand each into deg(mid) candidate slots,
dropping the dead ones (w == u or w ∈ N(u)) on the packed path; partition
sources into tiles of at most ``cap`` slots; route sources too big for one
tile to a hub sub-plan (or to the host beyond ``HUGE_DEVICE_MAX``); route
slots whose degree pair does not fit 16 bits to a side plan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graph import CSRGraph
from ..utils.device import resolve_device
from ..utils.numeric import next_pow2 as _next_pow2

__all__ = ["TilePlan", "build_plan", "KILL"]

# Count contribution of a killer slot in the edge-stream path.
KILL = -(1 << 30)

# Ceiling on precomputed slots (packed path).  ``None`` sizes it from the
# target device's memory (utils/device.py); tests patch a concrete int.
SLOT_BUDGET = None

# Largest hub expansion scored on the device (one tile).  ``None`` sizes it to
# half a selection segment of the target device; tests patch a concrete int.
HUGE_DEVICE_MAX = None

# Adaptive cap (cap=None): target tile count and cap bounds.  The reference's
# values, not yet re-derived on a GPU.
AUTO_CAP_TILES = 32
AUTO_CAP_MIN = 1 << 16
AUTO_CAP_MAX = 1 << 21


def _slot_budget(device) -> int:
    if SLOT_BUDGET is not None:
        return SLOT_BUDGET
    from ..utils.device import auto_slot_budget
    return auto_slot_budget(device)


def _huge_device_max(device) -> int:
    if HUGE_DEVICE_MAX is not None:
        return HUGE_DEVICE_MAX
    from ..utils.device import auto_seg_lanes
    return auto_seg_lanes(device) // 2


def _native_expand(g, src, mid, skip, est: int, deg16: bool):
    """Fused C++ slot expansion + dead-slot removal; returns
    ``(kept, sw, su, sudeg, swdeg, smid, cnt_u)`` or None when the native
    library is unavailable (the NumPy pipeline then runs)."""
    from ..io.native import native_lib

    lib = native_lib()
    if lib is None:
        return None
    n = g.n
    offs = np.ascontiguousarray(np.asarray(g.offsets, dtype=np.int32))
    inds = np.ascontiguousarray(np.asarray(g.indices, dtype=np.int32))
    rsrc = np.ascontiguousarray(src.astype(np.int32))
    rmid = np.ascontiguousarray(mid.astype(np.int32))
    rskip = np.ascontiguousarray(skip.astype(np.int32))
    sw = np.empty(est, dtype=np.int32)
    su = np.empty(est, dtype=np.int32)
    sudeg = np.empty(est, dtype=np.int32)
    swdeg = np.empty(1 if deg16 else est, dtype=np.int32)
    smid = np.empty(est, dtype=np.int32)
    cnt_u = np.empty(n, dtype=np.int64)
    kept = int(lib.lp_plan_expand(
        offs, inds, n, rsrc, rmid, rskip, rsrc.shape[0],
        1, 1 if deg16 else 0, est, sw, su, sudeg, swdeg, smid, cnt_u))
    if kept < 0:  # cannot happen (est is an upper bound)
        return None
    return (kept, sw[:kept], su[:kept], sudeg[:kept],
            None if deg16 else swdeg[:kept], smid[:kept], cnt_u)


def _native_firsthop(g, min_degree1: int, upper_only: bool):
    """C++ first-hop stage: the filtered (src, mid, skip) rows plus the
    killer (kuniq, kskip) list, or None when the native library is
    unavailable.  Full-graph mode only."""
    from ..io.native import native_lib

    lib = native_lib()
    if lib is None:
        return None
    import ctypes

    n, m = g.n, g.m
    offs = np.ascontiguousarray(np.asarray(g.offsets, dtype=np.int32))
    inds = np.ascontiguousarray(np.asarray(g.indices, dtype=np.int32))
    src = np.empty(max(m, 1), dtype=np.int32)
    mid = np.empty(max(m, 1), dtype=np.int32)
    skip = np.empty(max(m, 1), dtype=np.int32)
    kuniq = np.empty(max(n, 1), dtype=np.int32)
    kskip = np.empty(max(n, 1), dtype=np.int32)
    ku = ctypes.c_int64(0)
    m1 = int(lib.lp_plan_firsthop(offs, inds, n, int(min_degree1),
                                  1 if upper_only else 0, src, mid, skip,
                                  kuniq, kskip, ctypes.byref(ku)))
    k = int(ku.value)
    return (src[:m1].astype(np.int64), mid[:m1].astype(np.int64),
            skip[:m1].astype(np.int64), kuniq[:k].astype(np.int64),
            kskip[:k].astype(np.int64))


def _pad_bucket(x: int) -> int:
    """Smallest value >= x of the form m * 2^e with 8 <= m <= 16."""
    x = max(int(x), 8)
    e = max(x.bit_length() - 4, 0)
    return -(-x // (1 << e)) << e


def _pad_tiles(t: int) -> int:
    """Tile-count padding: a multiple of 4."""
    return max(4, (t + 3) & ~3)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    # Edge stream (1-element dummies for packed plans).
    fe_work: np.ndarray    # int32[M1_pad] neighbours of mid expanded
    fe_adr: np.ndarray     # int32[M1_pad] offsets[mid] + skip
    fe_usrc: np.ndarray    # int32[M1_pad] source; killer rows store ~src
    fe_middeg: np.ndarray  # int32[M1_pad] deg(mid)
    tile_edge_start: np.ndarray  # int32[T_pad + 1]
    cap: int               # slot budget per tile
    num_tiles: int         # true tile count (<= T_pad)
    huge_src: np.ndarray   # int64[H] sources too big for one tile
    total_slots: int       # expansion slots across tiles
    huge_slots: int        # expansion slots of the huge sources
    w_bits: int            # bit width of candidate ids (pads at 2^w_bits+)
    upper_only: bool       # True => score pairs w > u only (full graph)
    deg16: bool            # True => every pair degree here < 2^16 (the pair
    #                        packs into one int32; oversized pairs ride
    #                        ``side_plan``)
    keyed: bool            # True => candidate ids fit the w key
    packed: bool           # True => slot stream precomputed
    huge_plan: Optional["TilePlan"] = None  # device sub-plan for hub sources
    side_plan: Optional["TilePlan"] = None  # slots with a >16-bit degree
    # Hubs whose expansion exceeds HUGE_DEVICE_MAX slots (scored on the
    # host, ``scoring.score_huge_sources_host_multi``).
    host_src: np.ndarray = dataclasses.field(
        default_factory=lambda: np.empty(0, dtype=np.int64))
    # Packed slot stream (None unless packed):
    slot_w: Optional[np.ndarray] = None      # int32[S_pad] candidate w
    slot_u: Optional[np.ndarray] = None      # int32[S_pad] source id
    slot_udeg: Optional[np.ndarray] = None   # int32[S_pad] deg(u); with
    #                        deg16, the pair (deg(u) << 16 | deg(w))
    slot_wdeg: Optional[np.ndarray] = None   # int32[S_pad] deg(w); 1-elem
    #                        dummy with deg16
    slot_middeg: Optional[np.ndarray] = None  # int32[S_pad] deg(mid)
    tile_slot_start: Optional[np.ndarray] = None  # int32[T_pad + 1]
    # Uploaded device copies, per device (not part of equality).
    _device: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def num_tiles_padded(self) -> int:
        return int(self.tile_edge_start.shape[0]) - 1

    @property
    def tile_start(self) -> np.ndarray:
        """Per-tile stream offsets for the active path (host array)."""
        return self.tile_slot_start if self.packed else self.tile_edge_start

    def device_stream(self, device, weighted: bool = False):
        """The plan's stream as torch tensors on ``device``, uploaded once
        per plan and device: the packed slot stream ``(slot_w, slot_u,
        slot_udeg, slot_wdeg, slot_middeg)``, or the edge stream ``(fe_work,
        fe_adr, fe_usrc, fe_middeg)``.  The deg(mid) array (the AA/RA weight
        input) is uploaded only when ``weighted``; otherwise it is None."""
        device = torch.device(device)
        d = self._device.setdefault(str(device), {})
        *arrays, middeg = self.host_stream(weighted=True)
        if "stream" not in d:
            d["stream"] = tuple(torch.as_tensor(a, device=device)
                                for a in arrays)
        if weighted and "middeg" not in d:
            d["middeg"] = torch.as_tensor(middeg, device=device)
        return (*d["stream"], d.get("middeg") if weighted else None)

    def host_stream(self, weighted: bool = False):
        """The host arrays :meth:`device_stream` uploads, in its order:
        deg(mid) last, None unless ``weighted``."""
        if self.packed:
            arrays = (self.slot_w, self.slot_u, self.slot_udeg,
                      self.slot_wdeg)
            middeg = self.slot_middeg
        else:
            arrays = (self.fe_work, self.fe_adr, self.fe_usrc)
            middeg = self.fe_middeg
        return (*arrays, middeg if weighted else None)


def build_plan(g: CSRGraph, min_degree1: int, cap: Optional[int] = None,
               pad_tiles_pow2: bool = True,
               slot_budget: Optional[int] = None,
               sources: Optional[np.ndarray] = None,
               _keep_src: Optional[np.ndarray] = None,
               _allow_huge: bool = True, *, device="cuda") -> TilePlan:
    """Build the tile plan of ``g`` for scoring on ``device``.

    ``min_degree1`` = 0 is IHub; > 0 skips intermediates of higher degree.
    ``sources``: optional vertex subset (serving mode: directed candidates
    (s, w) for every second-order w, ``upper_only=False``).
    ``cap=None`` picks the tile capacity adaptively (~``AUTO_CAP_TILES``
    tiles, clamped to [2^16, 2^21]).  ``slot_budget=None`` sizes the packed
    stream's ceiling from ``device``'s memory (``0`` forces the edge stream).
    ``device`` sets the memory budgets only (the card by default; a
    missing card raises); planning is host work.
    ``_keep_src``/``_allow_huge`` are internal (the hub sub-plan)."""
    device = resolve_device(device)
    if slot_budget is None:
        slot_budget = _slot_budget(device)
    g = g.host()
    n = g.n
    deg = np.asarray(g.degrees, dtype=np.int64)
    offsets64 = np.asarray(g.offsets, dtype=np.int64)
    indices = np.asarray(g.indices, dtype=np.int64)

    upper_only = sources is None
    _gk = [None]

    def gkeys():
        # globally sorted (src*n + dst) edge keys, built lazily
        if _gk[0] is None:
            _gk[0] = (np.repeat(np.arange(n, dtype=np.int64), deg) * n
                      + indices[: g.m])
        return _gk[0]

    # Stage 1: the filtered first-hop edge list and the killer list (one
    # pseudo-edge per active source; its count enters the per-source totals
    # that drive cap selection and hub routing).
    fh = (_native_firsthop(g, min_degree1, upper_only)
          if sources is None and _keep_src is None else None)
    if fh is not None:
        src, mid, skip, kuniq, kskip = fh
    else:
        src = np.repeat(np.arange(n, dtype=np.int64), deg)
        mid = indices[: g.m]
        dmid = deg[mid]
        keep = dmid > 0
        if min_degree1:
            keep &= dmid <= min_degree1
        if sources is not None:
            keep &= np.isin(src, np.asarray(sources, dtype=np.int64))
        if _keep_src is not None:
            keep &= np.isin(src, np.asarray(_keep_src, dtype=np.int64))
        src, mid = src[keep], mid[keep]

        if upper_only and src.size:
            skip = np.searchsorted(gkeys(), mid * n + src, side="right") \
                - offsets64[mid]
            nz = deg[mid] - skip > 0
            src, mid, skip = src[nz], mid[nz], skip[nz]
        else:
            skip = np.zeros(src.shape[0], dtype=np.int64)

        uniq = np.unique(src)
        if upper_only and uniq.size:
            kskip = np.searchsorted(gkeys(), uniq * n + uniq, side="right") \
                - offsets64[uniq]
            knz = deg[uniq] - kskip > 0
            kuniq, kskip = uniq[knz], kskip[knz]
        else:
            kuniq = uniq
            kskip = np.zeros(uniq.shape[0], dtype=np.int64)
    kwork = deg[kuniq] - kskip
    work = deg[mid] - skip

    if cap is None:
        est = int(work.sum() + kwork.sum())
        cap = int(min(max(_next_pow2(-(-est // AUTO_CAP_TILES)),
                          AUTO_CAP_MIN), AUTO_CAP_MAX))

    # Per-source slot counts; sources too big for one tile are "huge".
    w_u = (np.bincount(src, weights=work.astype(np.float64), minlength=n)
           + np.bincount(kuniq, weights=kwork.astype(np.float64),
                         minlength=n)).astype(np.int64)
    huge_src = np.nonzero(w_u > cap)[0]
    huge_slots = int(w_u[huge_src].sum())
    huge_plan = None
    host_src = np.empty(0, dtype=np.int64)
    dev_huge_slots = 0
    if huge_src.size:
        not_huge = ~np.isin(src, huge_src)
        src, mid, work, skip = (src[not_huge], mid[not_huge],
                                work[not_huge], skip[not_huge])
        not_huge_k = ~np.isin(kuniq, huge_src)
        kuniq, kskip, kwork = (kuniq[not_huge_k], kskip[not_huge_k],
                               kwork[not_huge_k])
        huge_sizes = w_u[huge_src]
        w_u = w_u.copy()
        w_u[huge_src] = 0
        if _allow_huge:
            # hubs get a sub-plan whose cap holds the biggest one in a tile;
            # beyond HUGE_DEVICE_MAX they go to host_src
            on_device = huge_sizes <= _huge_device_max(device)
            dev_huge = huge_src[on_device]
            host_src = huge_src[~on_device]
            dev_huge_slots = int(huge_sizes[on_device].sum())
            if dev_huge.size:
                huge_plan = build_plan(
                    g, min_degree1,
                    cap=_next_pow2(int(huge_sizes[on_device].max())),
                    pad_tiles_pow2=False, slot_budget=slot_budget,
                    sources=sources, _keep_src=dev_huge, _allow_huge=False,
                    device=device)

    m1 = src.shape[0] + kuniq.shape[0]
    total_slots = int(work.sum() + kwork.sum())

    deg16 = bool(deg.max(initial=0) < (1 << 16))
    w_bits = max(int(max(n - 1, 1)).bit_length(), 1)
    keyed = w_bits + 1 <= 31             # one spare value range for pads
    # The budget bounds the main stream at its padded size plus the hub
    # sub-plan's stream, which is resident beside it.
    packed = keyed and total_slots * 9 // 8 + dev_huge_slots <= slot_budget

    def partition(prefix, cap_s=None):
        # source-aligned greedy partition: each tile's slot total <= cap
        cap_s = cap if cap_s is None else cap_s
        starts, ends = [], []
        b = 0
        while prefix[b] < prefix[-1]:
            a = int(np.searchsorted(prefix, prefix[b], side="right")) - 1
            a = max(a, b)
            nb = int(np.searchsorted(prefix, prefix[a] + cap_s, side="right")) - 1
            if nb <= a:  # cannot happen since per-source work <= cap
                nb = a + 1
            starts.append(a)
            ends.append(nb)
            b = nb
        return starts, ends

    slot_w = slot_u = slot_udeg = slot_wdeg = slot_middeg = None
    tile_slot_start = None
    side_plan = None
    if packed:
        # host-side slot expansion with dead-slot removal (w == u, w ∈ N(u))
        expanded = _native_expand(g, src, mid, skip, int(work.sum()), deg16)
        if expanded is not None:
            kept, sw, su, sudeg, swdeg_k, smid, cnt_u = expanded
        else:
            work32 = work.astype(np.int64)
            eprefix = np.cumsum(work32) - work32
            eloc = np.repeat(np.arange(src.shape[0], dtype=np.int64), work32)
            s_iota = np.arange(int(work.sum()), dtype=np.int64)
            j = s_iota - eprefix[eloc]
            adr = offsets64[mid][eloc] + skip[eloc] + j
            wv = indices[adr]
            slot_src = np.repeat(src, work32)
            kq = slot_src * n + wv
            gk = gkeys()
            pos = np.searchsorted(gk, kq)
            is_edge = np.zeros(kq.shape[0], dtype=bool)
            if gk.size:
                inb = pos < gk.size
                is_edge[inb] = gk[pos[inb]] == kq[inb]
            keep_s = ~is_edge & (wv != slot_src)
            wv = wv[keep_s]
            slot_src = slot_src[keep_s]
            smid = deg[np.repeat(mid, work32)[keep_s]].astype(np.int32)
            kept = int(wv.shape[0])
            cnt_u = np.bincount(slot_src, minlength=n).astype(np.int64)
            sw = wv.astype(np.int32)
            su = slot_src.astype(np.int32)
            if deg16:
                # the pair (udeg << 16 | wdeg), packed as uint32 bits
                pair = (deg[slot_src].astype(np.uint32) << np.uint32(16)) \
                    | deg[wv].astype(np.uint32)
                sudeg = pair.view(np.int32)
                swdeg_k = None
            else:
                sudeg = deg[slot_src].astype(np.int32)
                swdeg_k = deg[wv].astype(np.int32)

        def _emit(sw_s, su_s, sudeg_s, swdeg_s, smid_s, cnt_u_s, cap_s,
                  deg16_s, pad4):
            """Pad one slot sub-stream and partition it into tiles of at most
            cap_s slots."""
            kept_s = int(sw_s.shape[0])
            prefix_s = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(cnt_u_s, out=prefix_s[1:])
            starts, ends = partition(prefix_s, cap_s)
            s_pad = _pad_bucket(kept_s + cap_s)
            z_w = np.zeros(s_pad, dtype=np.int32)
            z_u = np.zeros(s_pad, dtype=np.int32)
            z_ud = np.zeros(s_pad, dtype=np.int32)
            z_md = np.zeros(s_pad, dtype=np.int32)
            z_w[:kept_s] = sw_s
            z_u[:kept_s] = su_s
            z_ud[:kept_s] = sudeg_s
            if deg16_s:
                z_wd = np.zeros(1, dtype=np.int32)  # unused dummy
            else:
                z_wd = np.zeros(s_pad, dtype=np.int32)
                z_wd[:kept_s] = swdeg_s
            z_md[:kept_s] = smid_s
            nt = max(len(starts), 1)
            tp = _pad_tiles(nt) if pad4 else nt
            t_start = np.full(tp + 1, kept_s, dtype=np.int32)
            if starts:
                bounds = np.asarray(starts + [ends[-1]], dtype=np.int64)
                t_start[: nt + 1] = prefix_s[bounds]
            else:
                t_start[:] = 0
            return z_w, z_u, z_ud, z_wd, z_md, t_start, nt, kept_s

        # Degree-regime split: slots whose pair degrees fit 16 bits keep the
        # packed pair; the rest ride a side plan with wide degrees.
        split_hi = None
        if not deg16:
            hi = (sudeg >= (1 << 16)) | (swdeg_k >= (1 << 16))
            n_hi = int(np.count_nonzero(hi))
            if n_hi == 0:
                pair = (sudeg.astype(np.uint32) << np.uint32(16)) \
                    | swdeg_k.astype(np.uint32)
                sudeg, swdeg_k = pair.view(np.int32), None
                deg16 = True
            elif n_hi < kept:
                lo = ~hi
                cnt_hi = np.bincount(su[hi], minlength=n).astype(np.int64)
                split_hi = (sw[hi], su[hi], sudeg[hi], swdeg_k[hi],
                            smid[hi], cnt_hi)
                pair = (sudeg[lo].astype(np.uint32) << np.uint32(16)) \
                    | swdeg_k[lo].astype(np.uint32)
                sw, su, smid = sw[lo], su[lo], smid[lo]
                sudeg, swdeg_k = pair.view(np.int32), None
                cnt_u = cnt_u.astype(np.int64) - cnt_hi
                deg16 = True

        (slot_w, slot_u, slot_udeg, slot_wdeg, slot_middeg, tile_slot_start,
         num_tiles, total_slots) = _emit(sw, su, sudeg, swdeg_k, smid, cnt_u,
                                         cap, deg16, pad_tiles_pow2)

        if split_hi is not None:
            hw, hu, hud, hwd, hmd, cnt_hi = split_hi
            hi_total = int(hw.shape[0])
            cap_h = int(min(cap, max(
                _next_pow2(max(int(cnt_hi.max()), 1)),
                _next_pow2(-(-hi_total // AUTO_CAP_TILES)))))
            (zw, zu, zud, zwd, zmd, t_s, nt_h, tot_h) = _emit(
                hw, hu, hud, hwd, hmd, cnt_hi, cap_h, False, False)
            dummy1 = np.zeros(1, dtype=np.int32)
            side_plan = TilePlan(
                fe_work=dummy1, fe_adr=dummy1, fe_usrc=dummy1,
                fe_middeg=dummy1, tile_edge_start=t_s.copy(), cap=cap_h,
                num_tiles=nt_h, huge_src=np.empty(0, dtype=np.int64),
                total_slots=tot_h, huge_slots=0, w_bits=w_bits,
                upper_only=upper_only, deg16=False, keyed=keyed, packed=True,
                slot_w=zw, slot_u=zu, slot_udeg=zud, slot_wdeg=zwd,
                slot_middeg=zmd, tile_slot_start=t_s)
        tile_edge_start = tile_slot_start.copy()
        fe_work = fe_adr = fe_usrc = fe_middeg = np.zeros(1, dtype=np.int32)
    else:
        # edge stream: killer rows interleaved killers-first per source
        esrc = np.concatenate([src, kuniq])
        emid = np.concatenate([mid, kuniq])
        eskip = np.concatenate([skip, kskip])
        real = np.concatenate([np.ones(src.shape[0], dtype=bool),
                               np.zeros(kuniq.shape[0], dtype=bool)])
        order = np.lexsort((emid, real, esrc))
        esrc, emid, real, eskip = (esrc[order], emid[order], real[order],
                                   eskip[order])
        ework = deg[emid] - eskip

        row_prefix = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(w_u, out=row_prefix[1:])
        starts, ends = partition(row_prefix)
        num_tiles = max(len(starts), 1)
        t_pad = _pad_tiles(num_tiles) if pad_tiles_pow2 else num_tiles

        row_edge_start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(esrc, minlength=n), out=row_edge_start[1:])
        tile_edge_start = np.full(t_pad + 1, m1, dtype=np.int32)
        if starts:
            bounds = np.asarray(starts + [ends[-1]], dtype=np.int64)
            tile_edge_start[: num_tiles + 1] = row_edge_start[bounds]
        else:
            tile_edge_start[:] = 0

        m1_pad = _pad_bucket(m1 + cap)
        fe_work = np.zeros(m1_pad, dtype=np.int32)
        fe_adr = np.zeros(m1_pad, dtype=np.int32)
        fe_usrc = np.zeros(m1_pad, dtype=np.int32)
        fe_middeg = np.zeros(m1_pad, dtype=np.int32)
        fe_work[:m1] = ework
        fe_adr[:m1] = offsets64[emid] + eskip
        fe_usrc[:m1] = np.where(real, esrc, ~esrc)
        fe_middeg[:m1] = deg[emid]

    return TilePlan(
        fe_work=fe_work,
        fe_adr=fe_adr,
        fe_usrc=fe_usrc,
        fe_middeg=fe_middeg,
        tile_edge_start=tile_edge_start,
        cap=cap,
        num_tiles=num_tiles,
        huge_src=huge_src,
        total_slots=total_slots,
        huge_slots=huge_slots,
        w_bits=w_bits,
        upper_only=upper_only,
        deg16=deg16,
        keyed=keyed,
        packed=packed,
        huge_plan=huge_plan,
        side_plan=side_plan,
        host_src=host_src,
        slot_w=slot_w,
        slot_u=slot_u,
        slot_udeg=slot_udeg,
        slot_wdeg=slot_wdeg,
        slot_middeg=slot_middeg,
        tile_slot_start=tile_slot_start,
    )
