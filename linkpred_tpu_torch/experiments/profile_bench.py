"""Per-op device-time table of ``bench.py``'s configuration, on the card.

Counterpart of ``experiments/profile_bench.py``: RMAT-``BENCH_SCALE`` (18)
at the bench protocol (0.1|E| removed), LHub-64 Jaccard, cap ``BENCH_CAP``
(2^20), k = the removed edges / 2.  One warm ``predict_links`` pass, then
one under the profiler (``utils.profiling.profile_fn``), whose result must
equal the warm pass's; then the per-op table (device kernels and host spans,
by total ms, the top 30; names cut at 120 characters).  The pass launches
K1 and K2.  Dropped from the JAX probe: its rule to run alone through the
device relay (the card has no relay).

    python -m linkpred_tpu_torch.experiments.profile_bench
        [--bench-scale 18] [--bench-cap 1048576] [--device cpu]
"""
from __future__ import annotations

from ..utils.device import resolve_device
from ._probe import (JACCARD, Rows, bench_graph, parser, profiled,
                     same_result)

__all__ = ["SIZES", "profile_pass", "main"]

SIZES = {"BENCH_SCALE": (18, int, True), "BENCH_CAP": (1 << 20, int, True)}


def profile_pass(y, plan, k: int, device, rows: Rows, top: int = 30,
                 min_degree1: int = 64):
    """One warm pass and one profiled pass of ``predict_links`` (Jaccard,
    ``min_degree1``, ``max_edges=k``) on ``plan``; emits the plan, both
    ``scoring_ms`` and the per-op table.  Returns the warm result."""
    from ..predict.api import PredictOptions, predict_links

    o = PredictOptions(repeat=1, max_edges=k)
    kw = dict(metric=JACCARD, min_degree1=min_degree1, options=o, plan=plan,
              device=device)
    warm = predict_links(y, **kw)
    traced, table = profiled(predict_links, y, top=top, **kw)
    same_result(traced, warm, f"{rows.probe}: the traced pass against the "
                "warm one")
    rows.emit(row="pass", n=y.n, m=y.m, slots=plan.total_slots,
              tiles=plan.num_tiles, padded=plan.num_tiles_padded,
              cap=plan.cap, k=k, results=len(warm),
              warm_scoring_ms=warm.scoring_ms,
              traced_scoring_ms=traced.scoring_ms)
    rows.emit(row="ops", ops=[[name[:120], ms, on_card]
                              for name, ms, on_card in table])
    return warm


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES, graph=True).parse_args(argv)
    device = resolve_device(args.device)
    from ..predict.plan import build_plan

    rows = Rows("profile_bench", device, scale=args.bench_scale)
    y, deletions = bench_graph(args.bench_scale, args.cache_dir)
    plan = build_plan(y, 64, cap=args.bench_cap, device=device)
    profile_pass(y, plan, max(deletions.shape[0] // 2, 1), device, rows)
    return rows.rows


if __name__ == "__main__":
    main()
