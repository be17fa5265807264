"""A/B: the edge stream's keyed branch against its sentinel branch.

Counterpart of ``experiments/ab_edge2.py``: IHub Jaccard on RMAT-``SCALE``
(13), edge factor ``EDGE_FACTOR`` (12), seed 3, cap 2^19,
``slot_budget=0`` (the edge stream), k = ``MAXE`` (4096), ``repeat=2``.
The keyed branch (one int64 sort, K1 with its killer branch) against the
same plan with ``keyed=False`` (the sentinel two-key branch, plain torch);
the two results are equal (score multisets and the pairs above the k-th
score).  Dropped from the JAX probe: nothing of the relay applied to it.

    python -m linkpred_tpu_torch.experiments.ab_edge2 [--scale 13]
        [--edge-factor 12] [--cap 524288] [--maxe 4096] [--device cpu]
"""
from __future__ import annotations

import dataclasses

from ..utils.device import resolve_device
from ._probe import JACCARD, Rows, parser, same_result

__all__ = ["SIZES", "branches", "main"]

SIZES = {"SCALE": (13, int, False), "EDGE_FACTOR": (12, int, False),
         "CAP": (1 << 19, int, False), "MAXE": (4096, int, False),
         "REPEAT": (2, int, False)}


def branches(g, plan, k: int, device, repeat: int = 2) -> dict:
    """``{"keyed": result, "sentinel": result}`` of ``predict_links`` on
    ``plan`` and on ``plan`` with ``keyed=False``; raises unless equal."""
    from ..predict.api import PredictOptions, predict_links

    o = PredictOptions(repeat=repeat, max_edges=k)
    out = {name: predict_links(g, JACCARD, min_degree1=0, options=o,
                               plan=p, device=device)
           for name, p in (("keyed", plan),
                           ("sentinel", dataclasses.replace(plan,
                                                            keyed=False)))}
    same_result(out["sentinel"], out["keyed"], "ab_edge2: sentinel against "
                "keyed")
    return out


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES).parse_args(argv)
    device = resolve_device(args.device)
    from ..bench.synth import rmat_graph
    from ..predict.plan import build_plan

    rows = Rows("ab_edge2", device, scale=args.scale)
    g = rmat_graph(args.scale, edge_factor=args.edge_factor, seed=3)
    plan = build_plan(g, 0, cap=args.cap, slot_budget=0, device=device)
    rows.emit(row="plan", slots=plan.total_slots, tiles=plan.num_tiles,
              packed=plan.packed, keyed=plan.keyed)
    out = branches(g, plan, args.maxe, device, args.repeat)
    rows.emit(row="arms", keyed_ms=out["keyed"].scoring_ms,
              sentinel_ms=out["sentinel"].scoring_ms,
              sentinel_over_keyed=out["sentinel"].scoring_ms
              / out["keyed"].scoring_ms, results=len(out["keyed"]))
    return rows.rows


if __name__ == "__main__":
    main()
