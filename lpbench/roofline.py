"""The yardstick of the kernels' roofline shares: the card's peak memory
rate, and the least bytes K1 and K2 must move, counted from the plan's own
tiles by what each kernel must read and write (each input byte read once,
each output byte written once, over the filled lanes only).

K1 (``fused_tail``, one launch a non-empty tile) reads a tile's sorted
``hi`` and ``lo`` (4 B each), its degrees (one packed 4 B pair, or 8 B when
the pass's degrees do not fit 16 bits) and one 4 B weight a weighted
metric, and writes one 4 B selection key a metric and the clamped ``ku``
and ``kw`` (4 B each).  K2 (``pack_survivors``, one launch a selection that
takes the survivor pack, and a pass selects once a metric) reads one 4 B
key a filled lane and writes at least the ``kk`` survivors' key and lane
index (8 B each).  The selection takes the pack as the program states it:
one segment, a buffer of at least 2^22 lanes, and ``4 kk`` at most a
quarter of it; a pass selected by segments packs in none of them, and
its merge of the segments' winners is one more selection a metric.
"""
from __future__ import annotations

import re

import numpy as np

__all__ = ["PEAKS", "peak_bytes_per_s", "k1_bytes", "k2_bytes",
           "selection_packs", "segments", "exact_k"]

# Peak memory bytes/s of the card the benchmark runs on, by the name
# torch.cuda.get_device_name gives (NVIDIA's data sheet, SXM part; copied
# from the program's roofline table).
PEAKS = [
    (re.compile(r"H100.*(SXM|80GB HBM3)", re.I), 3.35e12),
]

PACK_MIN_LANES = 1 << 22


def peak_bytes_per_s(kind: str):
    for rx, peak in PEAKS:
        if rx.search(kind or ""):
            return peak
    return None


def k1_bytes(tile_lanes, *, wide_degrees: bool, n_weighted: int,
             n_metrics: int) -> int:
    """Bytes K1 must move over tiles of ``tile_lanes`` filled lanes."""
    per_lane = (4 + 4 + (8 if wide_degrees else 4) + 4 * n_weighted
                + 4 * n_metrics + 4 + 4)
    return int(np.asarray(tile_lanes, dtype=np.int64).sum()) * per_lane


def k2_bytes(filled_lanes: int, kk: int) -> int:
    """Bytes K2 must move over a selection buffer of ``filled_lanes``
    filled lanes from which ``kk`` survive."""
    return 4 * int(filled_lanes) + 8 * int(kk)


def exact_k(all_slots: int, max_edges: int) -> int:
    """The k every pass selects: ``max_edges`` rounded up to a multiple of
    1024, at most the plan's slots."""
    all_slots = max(all_slots, 1)
    return min(-(-min(max_edges, all_slots) // 1024) * 1024, all_slots)


def selection_packs(buffer_lanes: int, kk: int, segments: int) -> bool:
    """Whether a selection of ``kk`` over ``buffer_lanes`` lanes takes K2."""
    return (segments == 1 and buffer_lanes >= PACK_MIN_LANES
            and kk * 4 <= buffer_lanes // 4)


def segments(tiles: int, cap: int, n_metrics: int, device_bytes: int) -> int:
    """How many segments of tiles a pass's selection runs over: one while
    its buffer fits a fifth of the device's memory at 12 B a lane."""
    seg_lanes = min(int(device_bytes * 0.20) // 12, 1 << 29)
    seg = max(1, max(cap, seg_lanes * 12 // (4 * n_metrics + 8)) // cap)
    return 1 if tiles <= seg else -(-tiles // seg)
