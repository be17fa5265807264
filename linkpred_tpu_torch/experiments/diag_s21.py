"""Where one pass's device time goes at s21, and whether the survivor pack
engages there.

Counterpart of ``experiments/diag_s21.py``, composed of this package's
``profile_bench`` and ``diag_pack``: on RMAT-``BENCH_SCALE`` (21) at the
bench protocol, LHub-64 Jaccard, the adaptive cap, k = the removed edges /
2: one warm pass, one profiled pass and its per-op table (the traced result
equal to the warm one), which arm the engine's selection took in the
profiled pass (``scoring.PACKED_ARM_RUNS`` / ``SORT_ARM_RUNS``), then
``diag_pack``'s reproduction of the decision (the threshold, the survivor
count, the capacity) with ``DIAG_PACK=1`` (the default).  Launches K1 and
K2.  Dropped from the JAX probe: nothing of the relay applied to it.

    python -m linkpred_tpu_torch.experiments.diag_s21 [--bench-scale 21]
        [--diag-pack 1] [--device cpu]
"""
from __future__ import annotations

from ..utils.device import resolve_device
from ._probe import Rows, bench_graph, parser
from .diag_pack import decision
from .profile_bench import profile_pass

__all__ = ["SIZES", "diagnose", "main"]

SIZES = {"BENCH_SCALE": (21, int, True), "DIAG_PACK": (1, int, True)}


def diagnose(y, plan, request: int, device, rows: Rows, top: int = 30,
             pack: bool = True):
    """The profiled pass with the selection arms it took, then (with
    ``pack``) the pack's decision.  Returns the warm pass's result."""
    from ..predict import api, scoring

    packed, sorted_ = scoring.PACKED_ARM_RUNS, scoring.SORT_ARM_RUNS
    warm = profile_pass(y, plan, request, device, rows, top)
    rows.emit(row="arms", passes=2, k=api._exact_k(plan, request),
              packed_arm_runs=scoring.PACKED_ARM_RUNS - packed,
              sort_arm_runs=scoring.SORT_ARM_RUNS - sorted_)
    if pack:
        decision(y, plan, request, device, rows)
    return warm


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES, graph=True).parse_args(argv)
    device = resolve_device(args.device)
    from ..predict.plan import build_plan

    rows = Rows("diag_s21", device, scale=args.bench_scale)
    y, deletions = bench_graph(args.bench_scale, args.cache_dir)
    plan = build_plan(y, 64, device=device)
    diagnose(y, plan, max(deletions.shape[0] // 2, 1), device, rows,
             pack=bool(args.diag_pack))
    return rows.rows


if __name__ == "__main__":
    main()
