"""A/B: the full pass against its tile scan alone and its selection alone.

Counterpart of ``experiments/ab_split.py`` and, with ``--deferred``, of
``experiments/ab_deferred.py``.  On RMAT-``BENCH_SCALE`` (18) at the bench
protocol (``--deferred``: the generator's RMAT-18, no edges removed),
LHub-64 Jaccard, cap 2^20, three arms, each timed with CUDA events over
``--repeat`` (3) calls after a warm one:

* ``full``: the pass as ``predict_links`` runs it (``scoring.scan_tiles``:
  the tile loop and the selection of the top k); its result, with the
  plan's sub-plans and host-scored hubs merged, equals ``predict_links``'s;
* ``scan``: the tile loop alone (``scoring._fill_buffer`` over every tile),
  its buffers reduced to checksums; its buffer's selection equals the full
  arm's top k;
* ``sel``: the selection alone (``scoring._select_topk``) on a buffer of
  the pass's shape, 35% of its lanes valid with uniform scores (as at
  ``experiments/ab_deferred.py:84-88``); its scores equal the buffer's top
  k.

k is 2^18 (``--deferred``: 2^19).  Launches K1 and K2.  Dropped from the
JAX probes: the jitted scan with its empty-tile ``lax.cond`` (the port's
loop launches no empty tile) and ``sync`` (the relay's fetch).

    python -m linkpred_tpu_torch.experiments.ab_split [--deferred]
        [--bench-scale 18] [--cap 1048576] [--k K] [--repeat 3]
        [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import (Rows, bench_graph, ms, parser, plan_result,
                     same_result, tile_fn_of, top_result)

__all__ = ["SIZES", "fake_buffer", "split", "main"]

SIZES = {"BENCH_SCALE": (18, int, True), "CAP": (1 << 20, int, False),
         "K": (0, int, False), "REPEAT": (3, int, False)}


def fake_buffer(total: int, device, valid: float = 0.35):
    """A selection buffer of ``total`` lanes as a pass leaves it: keys
    ``[1, total]`` (the -inf lanes spread), ``us``, ``vs`` (zeros); a
    ``valid`` share of the lanes hold uniform scores (numpy, seed 0, the
    JAX probe's draw).  Returns ``(keys, us, vs, scores)``."""
    from ..ops.topk import desc_score_key, spread_invalid

    rng = np.random.default_rng(0)
    scores = np.full(total, -np.inf, np.float32)
    nv = int(total * valid)
    pos = rng.choice(total, nv, replace=False)
    scores[pos] = rng.random(nv, dtype=np.float32)
    s = torch.as_tensor(scores, device=device)
    lane = torch.arange(total, dtype=torch.int32, device=device)
    keys = spread_invalid(desc_score_key(s), s, lane)[None]
    zeros = torch.zeros(total, dtype=torch.int32, device=device)
    return keys, zeros, zeros.clone(), s


def split(y, plan, k: int, device, rows: Rows, repeat: int = 3,
          min_degree1: int = 64):
    """Time and hold equal the three arms on ``plan``; returns the full
    arm's result with the sub-plans merged (a ``PredictResult``)."""
    from ..predict import scoring
    from ..predict.api import PredictOptions, predict_links

    tile_fn = tile_fn_of(y, plan, device)
    ts, cap, t_pad = plan.tile_start, plan.cap, plan.num_tiles_padded

    def full():
        return scoring.scan_tiles(tile_fn, ts, k, 1, cap, device=device)

    def scan():
        keys, us, vs = scoring._fill_buffer(tile_fn, ts, range(t_pad), 1,
                                            cap, device)
        return keys[:, ::1024].sum(), us[::1024].sum(), vs[::1024].sum()

    fkeys, fu, fv, fscores = fake_buffer(t_pad * cap, device)

    def sel():
        return scoring._select_topk(fkeys, fu, fv, k)

    times = {name: ms(fn, device, repeat)
             for name, fn in (("full", full), ("scan", scan), ("sel", sel))}
    top = full()
    got = plan_result(y, plan, k, device, min_degree1, main_top=top)
    want = predict_links(y, "jaccard_coefficient", min_degree1=min_degree1,
                         options=PredictOptions(max_edges=k), plan=plan,
                         device=device)
    same_result(got, want, f"{rows.probe}: the full arm against "
                "predict_links")
    buf = scoring._fill_buffer(tile_fn, ts, range(t_pad), 1, cap, device)
    kk = min(k, t_pad * cap)
    main = top_result([(top.scores[0], top.u[0], top.v[0])], kk)
    scanned = scoring._select_topk(*buf, kk)
    same_result(top_result([(scanned.scores[0], scanned.u[0],
                             scanned.v[0])], kk), main,
                f"{rows.probe}: the scan arm's buffer against the full arm")
    picked = sel().scores[0]
    best = torch.sort(fscores, descending=True).values[:kk]
    if not torch.equal(picked.cpu(), best.cpu()):
        raise AssertionError(f"{rows.probe}: the sel arm's scores are not "
                             "the buffer's top k")
    rows.emit(row="arms", k=k, slots=plan.total_slots, tiles=plan.num_tiles,
              padded=t_pad, cap=cap, sel_lanes=t_pad * cap,
              full_ms=times["full"], scan_ms=times["scan"],
              sel_ms=times["sel"],
              full_minus_scan_ms=times["full"] - times["scan"])
    return got


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    ap = parser(__doc__, SIZES, graph=True)
    ap.add_argument("--deferred", action="store_true",
                    help="ab_deferred's configuration: no edges removed, "
                    "k = 2^19")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    from ..predict.plan import build_plan

    probe = "ab_deferred" if args.deferred else "ab_split"
    rows = Rows(probe, device, scale=args.bench_scale)
    y, _ = bench_graph(args.bench_scale, args.cache_dir,
                       removal=not args.deferred)
    plan = build_plan(y, 64, cap=args.cap, device=device)
    k = args.k or (1 << 19 if args.deferred else 1 << 18)
    split(y, plan, k, device, rows, args.repeat)
    return rows.rows


if __name__ == "__main__":
    main()
