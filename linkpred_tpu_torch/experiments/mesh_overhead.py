"""What the sharded pass costs against one pass: the same plan scored
single and on 1, 2, 4 and 8 rank processes.

Counterpart of ``experiments/mesh_overhead.py``: RMAT-``MO_SCALE`` (15),
LHub ``MO_DEG`` (16), cap ``2^MO_CAP_LOG2`` (2^16), k = ``MO_K`` (2048),
Jaccard, ``REPEAT`` (3).  The single pass is ``predict_links`` in this
process; each rank count runs ``parallel.sim.launch``: that many rank
processes (gloo on the CPU, or ranks sharing the one card), each scoring
its block under ``make_global_mesh``, rank 0 holding the sharded result
against its own single pass.  Each row gives the pass's ms (the slowest
rank's ``scoring_ms``), the slots a rank (``parallel.mesh.shard_layout``'s
largest block), the all-gathers (one a pass beyond one rank), the receive
MB a rank (``3 x M x k x 4`` bytes from each of the other ranks a
gather), the gather ms, and the pass against one rank.  Rank 0's score
multiset equals this process's single pass.  Dropped from the JAX probe:
the 8-device virtual CPU mesh (the ranks are processes here) and the
chunked dispatch (relay only), so a pass has one gather, not one a chunk.

    python -m linkpred_tpu_torch.experiments.mesh_overhead [--mo-scale 15]
        [--mo-deg 16] [--mo-cap-log2 16] [--mo-k 2048] [--repeat 3]
        [--ranks 1,2,4,8] [--device cpu]
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile

import numpy as np

from ..utils.device import resolve_device
from ._probe import JACCARD, Rows, parser

__all__ = ["SIZES", "sharded", "main"]

SIZES = {"MO_SCALE": (15, int, True), "MO_DEG": (16, int, True),
         "MO_CAP_LOG2": (16, int, True), "MO_K": (2048, int, True),
         "REPEAT": (3, int, True)}


def sharded(graph_path: str, ranks: int, deg: int, cap: int, k: int,
            repeat: int, device, tmp: str, timeout: float = 600.0):
    """Score the graph at ``graph_path`` on ``ranks`` rank processes
    (``parallel.sim``); returns (their SIM records, rank 0's scores)."""
    from ..parallel import sim

    spec = os.path.join(tmp, f"spec{ranks}.json")
    out = os.path.join(tmp, f"res{ranks}.npz")
    with open(spec, "w") as f:
        json.dump([dict(name="mo", graph=graph_path, metrics=[JACCARD],
                        min_degree1=deg, cap=cap, slot_budget=None,
                        max_edges=k, sources=None, repeat=repeat)], f)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = sim.launch(ranks, ["--device", device.type, "--timeout",
                                str(timeout), "--spec", spec, "--out", out],
                        timeout)
    if rc:
        raise RuntimeError(f"mesh_overhead: {ranks} ranks failed:\n"
                           + buf.getvalue()[-3000:])
    records = [json.loads(line.split("SIM ", 1)[1])
               for line in buf.getvalue().splitlines() if "SIM {" in line]
    with np.load(out) as d:
        scores = d[f"mo/{JACCARD}/score"]
    return records, scores


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    ap = parser(__doc__, SIZES)
    ap.add_argument("--ranks", default="1,2,4,8",
                    help="rank counts to run")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    from ..bench.synth import rmat_graph
    from ..io.npz import save_graph
    from ..parallel.mesh import shard_layout
    from ..predict import api
    from ..predict.api import PredictOptions, predict_links
    from ..predict.plan import build_plan

    cap = 1 << args.mo_cap_log2
    rows = Rows("mesh_overhead", device, scale=args.mo_scale,
                deg=args.mo_deg, cap=cap, k=args.mo_k)
    g = rmat_graph(args.mo_scale)
    plan = build_plan(g, args.mo_deg, cap=cap, device=device)
    if not plan.packed:
        raise RuntimeError("mesh_overhead: the plan is not packed")
    n_pass = 1 + len(api._sub_plans(plan))
    kk = api._exact_k(plan, args.mo_k)
    single = predict_links(g, JACCARD, min_degree1=args.mo_deg,
                           options=PredictOptions(max_edges=args.mo_k,
                                                  repeat=args.repeat),
                           plan=plan, device=device)
    want = np.sort(single.score)
    rows.emit(row="single", pass_ms=single.scoring_ms,
              slots=plan.total_slots, tiles=plan.num_tiles, passes=n_pass)
    base = None
    with tempfile.TemporaryDirectory(prefix="mesh_overhead_") as tmp:
        path = os.path.join(tmp, "graph.npz")
        save_graph(g, path)
        for d in map(int, args.ranks.split(",")):
            recs, scores = sharded(path, d, args.mo_deg, cap, args.mo_k,
                                   args.repeat, device, tmp)
            if not np.array_equal(np.sort(scores), want):
                raise AssertionError(f"mesh_overhead: {d} ranks' scores "
                                     "differ from the single pass")
            pass_ms = max(r["pass_ms"] for r in recs)
            base = base or pass_ms
            gathers = n_pass if d > 1 else 0
            rows.emit(row="ranks", ranks=d, backend=recs[0]["backend"],
                      pass_ms=pass_ms,
                      slots_rank=int(shard_layout(plan, d).span.max()),
                      gathers=gathers,
                      recv_mb_rank=gathers * 3 * kk * 4 * (d - 1) / 1e6,
                      gather_ms=max(r["gather_ms"] for r in recs),
                      vs_one_rank=pass_ms / base)
    return rows.rows


if __name__ == "__main__":
    main()
