"""Warm and traced ``scoring_ms`` and the per-op table of one LHub pass.

Counterpart of ``experiments/profile_tiles.py``: the generator's RMAT-18
(no edges removed), LHub-64 Jaccard, cap 2^20, k = ``PROF_MAXE`` (4096).
The trace comes from ``utils.profiling.profile_fn`` (the JAX probe's
hand-parsed ``/tmp/jaxtrace``, productized there); the traced result must
equal the warm one.  The pass launches K1.  Dropped from the JAX probe:
nothing of the relay applied to it.

    python -m linkpred_tpu_torch.experiments.profile_tiles [--prof-maxe 4096]
        [--scale 18] [--cap 1048576] [--device cpu]
"""
from __future__ import annotations

from ..utils.device import resolve_device
from ._probe import Rows, bench_graph, parser
from .profile_bench import profile_pass

__all__ = ["SIZES", "main"]

SIZES = {"PROF_MAXE": (4096, int, True), "SCALE": (18, int, False),
         "CAP": (1 << 20, int, False)}


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES).parse_args(argv)
    device = resolve_device(args.device)
    from ..predict.plan import build_plan

    rows = Rows("profile_tiles", device, scale=args.scale)
    g, _ = bench_graph(args.scale, removal=False)
    plan = build_plan(g, 64, cap=args.cap, device=device)
    profile_pass(g, plan, args.prof_maxe, device, rows, top=40)
    return rows.rows


if __name__ == "__main__":
    main()
