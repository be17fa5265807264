"""A/B for the non-deg16 packed tile: do the degrees ride the sort, or are
they gathered after it?

Counterpart of ``experiments/ab_deg_gather.py``: ``T`` (16) tiles of
``CAP`` (2^21) lanes, random (w, u) slots over ``N`` (2^22) vertices, with
degrees in [1, ``DEG_MAX``) (2^20, so the pair does not pack into 16 bits).
Each tile sorts the engine's int64 key ``w << 32 | u``; then

* A: the degrees ride the sort: ``udeg``/``wdeg``, slot-stream arrays like
  the plan's, are gathered through the sort's permutation (the engine's
  non-deg16 tile, ``scoring.keyed_sort``);
* B: the degrees are gathered after the sort from the degree table,
  ``degrees[u]`` and ``degrees[w]``; the slot stream holds two arrays, not
  four;

and reduces its runs: run ends, the run length by a cummax of run starts,
the Jaccard score (the engine's formula).  The two arms' lanes are equal,
and the scored runs equal the engine's ``scoring._keyed_sort_reduce`` (K1,
non-deg16) on the same lanes.  Each arm's pass over the T tiles (a sum a
tile, as the JAX probe) is timed with CUDA events over ``--repeat`` (3)
calls after a warm one.  Dropped from the JAX probe: the jitted
``lax.scan`` over the tiles (the engine's tile loop is Python).

    python -m linkpred_tpu_torch.experiments.ab_deg_gather [--cap 2097152]
        [--t 16] [--n 4194304] [--deg-max 1048576] [--repeat 3]
        [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import JACCARD, Rows, ms, parser

__all__ = ["SIZES", "make_stream", "reduce_tail", "tile_a", "tile_b",
           "engine_tile", "check_tile", "main"]

SIZES = {"CAP": (1 << 21, int, False), "T": (16, int, False),
         "N": (1 << 22, int, False), "DEG_MAX": (1 << 20, int, False),
         "REPEAT": (3, int, False)}


def make_stream(cap: int, t: int, n: int, deg_max: int, device) -> dict:
    """The JAX probe's draw from seed 0 (``slot_w``, ``slot_u``,
    ``degrees``), then ``slot_udeg``/``slot_wdeg`` looked up; tensors on
    ``device``."""
    rng = np.random.default_rng(0)
    slot_w = rng.integers(0, n, t * cap, dtype=np.int32)
    slot_u = rng.integers(0, n, t * cap, dtype=np.int32)
    degrees = rng.integers(1, deg_max, n, dtype=np.int32)
    arrays = dict(slot_w=slot_w, slot_u=slot_u, degrees=degrees,
                  slot_udeg=degrees[slot_u], slot_wdeg=degrees[slot_w])
    return {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}


def _sorted(w, u):
    k64, perm = torch.sort((w.to(torch.int64) << 32) | u.to(torch.int64))
    return (k64 >> 32).to(torch.int32), (k64 & 0xFFFFFFFF).to(torch.int32), \
        perm


def reduce_tail(key, src, udeg, wdeg, w_bits: int):
    """The runs of a sorted tile: ``(score, src, key)`` with -inf off the
    run ends and for pad keys (``key >= 2^w_bits``)."""
    from ..ops.segment import cummax, run_boundaries
    from ..predict.metrics import METRICS

    iota = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    is_start, is_end = run_boundaries(key, src)
    start = cummax(torch.where(is_start, iota, 0))
    cnt = iota - start + 1
    score = METRICS[JACCARD].score(cnt, cnt.to(torch.float32), udeg, wdeg)
    valid = is_end & (key < (1 << w_bits))
    return torch.where(valid, score, float("-inf")), src, key


def tile_a(s: dict, t0: int, cap: int, w_bits: int):
    """A: the degrees from the slot stream, through the permutation."""
    key, src, perm = _sorted(s["slot_w"][t0: t0 + cap],
                             s["slot_u"][t0: t0 + cap])
    return reduce_tail(key, src, s["slot_udeg"][t0: t0 + cap][perm],
                       s["slot_wdeg"][t0: t0 + cap][perm], w_bits)


def tile_b(s: dict, t0: int, cap: int, w_bits: int):
    """B: the degrees from the table, after the sort."""
    key, src, _ = _sorted(s["slot_w"][t0: t0 + cap],
                          s["slot_u"][t0: t0 + cap])
    n = s["degrees"].shape[0]
    deg = s["degrees"]
    return reduce_tail(key, src, deg[src.clamp(max=n - 1).to(torch.int64)],
                       deg[key.clamp(max=n - 1).to(torch.int64)], w_bits)


def engine_tile(s: dict, t0: int, cap: int, w_bits: int):
    """The engine's non-deg16 tile on the same lanes: ``(skeys, ku, kw)``
    of ``scoring._keyed_sort_reduce`` (K1)."""
    from ..predict.metrics import METRICS
    from ..predict.scoring import _keyed_sort_reduce

    win = slice(t0, t0 + cap)
    return _keyed_sort_reduce(
        s["slot_w"][win], s["slot_u"][win], s["slot_udeg"][win],
        s["slot_wdeg"][win], [], (METRICS[JACCARD],), w_bits=w_bits,
        n=s["degrees"].shape[0], maxf2=0, min_score=0.0, deg16=False)


def check_tile(a, b, engine, where: str) -> None:
    """A's and B's lanes are equal, and their scored runs are the engine's
    (K1 keeps the runs whose score is above 0: every run here)."""
    from ..ops.topk import desc_key_score

    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"{where}: arms A and B differ")
    skeys, ku, kw = engine
    es = desc_key_score(skeys[0])
    live, elive = torch.isfinite(a[0]), torch.isfinite(es)
    if not (torch.equal(live, elive) and torch.equal(a[0][live], es[elive])
            and torch.equal(a[1][live], ku[elive])
            and torch.equal(a[2][live], kw[elive])):
        raise AssertionError(f"{where}: the arms' runs are not the "
                             "engine's")


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES).parse_args(argv)
    device = resolve_device(args.device)
    cap, t = args.cap, args.t
    w_bits = max(1, (args.n - 1).bit_length())
    rows = Rows("ab_deg_gather", device, cap=cap, tiles=t, n=args.n,
                deg_max=args.deg_max)
    s = make_stream(cap, t, args.n, args.deg_max, device)
    for i in range(t):
        check_tile(tile_a(s, i * cap, cap, w_bits),
                   tile_b(s, i * cap, cap, w_bits),
                   engine_tile(s, i * cap, cap, w_bits),
                   f"ab_deg_gather tile {i}")

    def run(tile):
        return [tuple(x.sum() for x in (torch.where(torch.isfinite(o[0]),
                                                    o[0], 0.0), *o[1:]))
                for o in (tile(s, i * cap, cap, w_bits) for i in range(t))]

    for name, tile in (("A", tile_a), ("B", tile_b)):
        total = ms(lambda: run(tile), device, args.repeat)
        rows.emit(row="arm", arm=name, ms=total, ms_tile=total / t)
    return rows.rows


if __name__ == "__main__":
    main()
