"""Where a pass spends its time, pass by pass, and the plan's routing.

Counterpart of ``experiments/diag_scale.py``: on RMAT-``BENCH_SCALE`` (21)
at the bench protocol, LHub-64 Jaccard, cap ``CAP`` (adaptive when unset),
k = ``DIAG_K`` (2^20):

* the plan's routing stats for the main plan, the hub sub-plan and the side
  plan (slots, tiles, padded tiles, cap, deg16, packed, selection lanes,
  and whether the selection runs by segment: ``scoring._segments``, the
  port's counterpart of the JAX probe's ``_seg_lanes`` rule);
* each pass alone (``scoring.score_tiles``, in place of the relay-only
  ``score_tiles_chunked``) in ms and ns a slot, ``REPEAT`` (3) calls after
  a warm one, CUDA events; the host scorer's ms for the mega-hubs;
* the blended total, its ns a slot and its edges/s; with ``DIAG_TRACE=1``
  the per-op table of one main pass (``utils.profiling.profile_fn``).

The passes' merged top k must equal ``predict_links``'s.  They launch K1
and K2.  Dropped from the JAX probe: the device touch before the host plan
(the relay's init rule) and the chunked dispatch (relay only).

    python -m linkpred_tpu_torch.experiments.diag_scale [--bench-scale 21]
        [--cap N] [--diag-k 1048576] [--repeat 3] [--diag-trace 1]
        [--device cpu]
"""
from __future__ import annotations

import time

import numpy as np

from ..utils.device import resolve_device
from ._probe import (Rows, bench_graph, host_rows, parser, pass_runner,
                     passes, profiled, same_result, top_result)

__all__ = ["SIZES", "describe", "diagnose", "main"]

SIZES = {"BENCH_SCALE": (21, int, True), "CAP": (0, int, True),
         "DIAG_K": (1 << 20, int, True), "REPEAT": (3, int, True),
         "DIAG_TRACE": (0, int, True)}


def describe(p, device) -> dict:
    """The routing stats of pass ``p``."""
    from ..predict import scoring

    n_seg, seg = scoring._segments(p.num_tiles_padded, p.cap, 1, device)
    return dict(slots=p.total_slots, tiles=p.num_tiles,
                padded=p.num_tiles_padded, cap=p.cap, deg16=p.deg16,
                packed=p.packed, sel_lanes=p.num_tiles_padded * p.cap,
                segments=n_seg, segment_tiles=seg, by_segment=n_seg > 1)


def diagnose(y, plan, k: int, device, rows: Rows, repeat: int = 3,
             trace: bool = False, min_degree1: int = 64):
    """Time every pass of ``plan`` alone and the host scorer; emit the
    rows; hold the merged top k against ``predict_links``.  Returns the
    merged result."""
    from ..predict.api import PredictOptions, predict_links
    from ..utils.timing import measure_duration

    deg = np.asarray(y.degrees)
    big = deg >= 1 << 16
    rows.emit(row="graph", n=y.n, m=y.m, max_deg=int(deg.max()),
              verts_deg_2_16=int(big.sum()),
              deg_mass_2_16=float(deg[big].sum() / max(deg.sum(), 1)),
              huge_src=int(plan.huge_src.size), huge_slots=plan.huge_slots,
              host_src=int(plan.host_src.size))
    parts, total_ms, all_slots, main_fn = [], 0.0, 0, None
    for label, p in passes(plan):
        fn = pass_runner(y, p, k, device)
        main_fn = main_fn or fn
        ms, top = measure_duration(fn, repeat, device=device)
        parts.append((top.scores[0], top.u[0], top.v[0]))
        total_ms += ms
        all_slots += p.total_slots
        rows.emit(row="pass", plan=label, ms=ms,
                  ns_slot=ms * 1e6 / max(p.total_slots, 1),
                  **describe(p, device))
    if plan.host_src.size:
        t0 = time.perf_counter()
        parts.append(host_rows(y, plan, k, min_degree1))
        host_ms = (time.perf_counter() - t0) * 1e3
        total_ms += host_ms
        rows.emit(row="host", ms=host_ms, sources=int(plan.host_src.size))
    if trace:
        _, table = profiled(main_fn, top=30)
        rows.emit(row="ops", plan="main",
                  ops=[[n[:120], t] for n, t in table])
    merged = top_result(parts, k)
    want = predict_links(y, "jaccard_coefficient", min_degree1=min_degree1,
                         options=PredictOptions(max_edges=k), plan=plan,
                         device=device)
    same_result(merged, want, f"{rows.probe}: the passes' merged top k "
                "against predict_links")
    rows.emit(row="total", ms=total_ms,
              ns_slot=total_ms * 1e6 / max(all_slots, 1), slots=all_slots,
              edges_per_s=y.m / (total_ms / 1e3) if total_ms else None,
              results=len(merged))
    return merged


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES, graph=True).parse_args(argv)
    device = resolve_device(args.device)
    from ..predict.plan import build_plan

    rows = Rows("diag_scale", device, scale=args.bench_scale)
    y, _ = bench_graph(args.bench_scale, args.cache_dir)
    t0 = time.perf_counter()
    plan = build_plan(y, 64, cap=args.cap or None, device=device)
    rows.emit(row="plan", plan_ms=(time.perf_counter() - t0) * 1e3)
    diagnose(y, plan, args.diag_k, device, rows, args.repeat,
             bool(args.diag_trace))
    return rows.rows


if __name__ == "__main__":
    main()
