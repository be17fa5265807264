"""Does the survivor pack engage at the bench shape?  The selection's
decision inputs, reproduced at the engine's k.

Counterpart of ``experiments/diag_pack.py``: on RMAT-``BENCH_SCALE`` (21)
at the bench protocol, LHub-64 Jaccard, the main pass's real selection
buffer (``scoring._fill_buffer`` over every tile) at the ENGINE's k
(``api._exact_k``: the request rounded up to a 1024 multiple, the lesson at
``experiments/diag_pack.py:32-36``), then the sampled threshold
(``sample_threshold``), the global survivor count of the pack (K2,
``pack_survivors``), its capacity, and which arm ``scoring._argselect``
takes (read from its counters) at what ``scoring.SEL_PACK_MIN``.  The pack
arm's selection and a full sort's are held equal.  The port compacts
globally, so the JAX probe's per-chunk budget has no counterpart; the
check is the global count alone.  Dropped from the JAX probe: the jitted
scan with its empty-tile ``lax.cond`` (the port's loop never launches an
empty tile).

    python -m linkpred_tpu_torch.experiments.diag_pack [--bench-scale 21]
        [--device cpu]
"""
from __future__ import annotations

from ..utils.device import resolve_device
from ._probe import (Rows, bench_graph, parser, same_keys,
                     tile_fn_of, top_result)

__all__ = ["SIZES", "decision", "main"]

SIZES = {"BENCH_SCALE": (21, int, True)}

INT32_MIN = -(1 << 31)


def decision(y, plan, request: int, device, rows: Rows):
    """The selection of ``plan``'s main pass at the engine's k for a
    request of ``request`` edges: emits the decision row and returns the
    selection's top k (a ``PredictResult``)."""
    from ..ops import compact
    from ..ops.topk import desc_key_score
    from ..predict import api, scoring

    k = api._exact_k(plan, request)
    t_pad, cap = plan.num_tiles_padded, plan.cap
    keys, us, vs = scoring._fill_buffer(tile_fn_of(y, plan, device),
                                        plan.tile_start, range(t_pad), 1,
                                        cap, device)
    key = keys[0]
    total = key.shape[0]
    kk = min(k, total)
    n_seg, _ = scoring._segments(t_pad, cap, 1, device)
    attempt = (n_seg == 1 and total >= scoring.SEL_PACK_MIN
               and kk * 4 <= total // compact.PACK_RATIO)
    thr, _ = compact.sample_threshold(key, kk)
    pk, _, cnt = compact.pack_survivors(key, thr)
    count, capacity = int(cnt), pk.shape[0]
    packed = attempt and kk <= count <= capacity
    before = scoring.PACKED_ARM_RUNS
    sk, idx = scoring._argselect(key, kk, allow_pack=n_seg == 1)
    took = "packed" if scoring.PACKED_ARM_RUNS > before else "sort"
    if took != ("packed" if packed else "sort"):
        raise AssertionError(f"{rows.probe}: _argselect took the {took} "
                             f"arm, the reproduction says otherwise")
    same_keys(key, {"argselect": (sk, idx),
                    "sort": scoring._argselect_sort(key, kk)}, kk,
              f"{rows.probe}: the selection against a full sort")
    thr_u32 = (int(thr) - INT32_MIN) & 0xFFFFFFFF
    rows.emit(row="decision", request=request, k=k, kk=kk, lanes=total,
              segments=n_seg, sel_pack_min=scoring.SEL_PACK_MIN,
              pack_ratio=compact.PACK_RATIO, threshold=int(thr),
              threshold_u32=f"{thr_u32:#010x}", survivors=count,
              survivors_over_kk=count / kk, capacity=capacity,
              attempt=attempt, arm=took)
    return top_result([(desc_key_score(sk), us[idx], vs[idx])], k)


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES, graph=True).parse_args(argv)
    device = resolve_device(args.device)
    from ..predict.plan import build_plan

    rows = Rows("diag_pack", device, scale=args.bench_scale)
    y, deletions = bench_graph(args.bench_scale, args.cache_dir)
    plan = build_plan(y, 64, device=device)
    decision(y, plan, max(deletions.shape[0] // 2, 1), device, rows)
    return rows.rows


if __name__ == "__main__":
    main()
