"""Command-line experiment driver (counterpart of ``linkpred_tpu/cli.py``).

    python -m linkpred_tpu_torch <graph.mtx> [symmetric] [weighted] [options]

Loads an MTX graph, symmetrizes it unless marked symmetric, removes
self-loops, and runs the reference's batch experiment, printing
reference-grammar log lines that the reference's ``process.js`` (or
``python -m linkpred_tpu_torch.bench.process``) parses unchanged.

The reference's compile-time macros are runtime flags here.  Scoring runs
on the CUDA card; ``--device cpu`` runs the kernels' plain versions on the
CPU, and without it a machine with no card raises.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

from .bench.harness import ALL_DEGREES, ExperimentConfig, run_experiment
from .io.mtx import read_mtx
from .ops.transform import remove_self_loops, symmetrize
from .predict.metrics import METRICS, get_metric
from .utils.debug import install_fault_handler
from .utils.device import device_count
from .utils.logging import graph_line, log

__all__ = ["main", "build_parser"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="linkpred_tpu_torch",
        description="IHub/LHub neighbourhood link prediction experiment on "
                    "a CUDA card",
    )
    p.add_argument("file", help="input graph in MatrixMarket (.mtx) format")
    p.add_argument("symmetric", nargs="?", default="0",
                   help="1 if the file already stores both edge directions")
    p.add_argument("weighted", nargs="?", default="0",
                   help="1 to read edge weights")
    p.add_argument("--metrics", default=",".join(METRICS),
                   help="comma-separated metric names or aliases")
    p.add_argument("--degrees", default=",".join(map(str, ALL_DEGREES)),
                   help="comma-separated MINDEGREE1 sweep (0 = IHub)")
    p.add_argument("--repeat-batch", type=int, default=5)
    p.add_argument("--repeat-method", type=int, default=5)
    p.add_argument("--batch-length", type=int, default=1)
    p.add_argument("--deletions-begin", type=float, default=1e-4)
    p.add_argument("--deletions-end", type=float, default=1e-1)
    p.add_argument("--deletions-step", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed (default: OS entropy, like the reference)")
    p.add_argument("--cap", type=int, default=1 << 20,
                   help="scoring tile slot budget; 0 = adaptive per graph")
    p.add_argument("--min-score", type=float, default=0.0)
    p.add_argument("--jsonl", action="store_true",
                   help="emit JSON-lines result rows instead of the printf "
                        "grammar")
    p.add_argument("--unfused", action="store_true",
                   help="score each metric as its own full pass (honest "
                        "per-technique times, like the reference's per-metric "
                        "scans; default shares one pass, amortizes the time, "
                        "and tags those rows ...CudaFused<deg> in the log)")
    p.add_argument("--device", default="cuda",
                   help="where scoring runs: cuda (default; raises without a "
                        "card) or cpu (the kernels' plain versions)")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    symmetric = bool(int(args.symmetric))
    weighted = bool(int(args.weighted))

    install_fault_handler()  # the reference driver's install_sigsegv

    num_threads = device_count(args.device)
    # Keep the literal OMP_NUM_THREADS key: process.js keys on it.
    log(f"OMP_NUM_THREADS={num_threads}")
    log(f"Loading graph {args.file} ...")
    g = read_mtx(args.file, weighted=weighted)
    log(graph_line(g.order, g.size))
    if not symmetric:
        g = symmetrize(g)
        log(graph_line(g.order, g.size) + " (symmetrize)")
    g = remove_self_loops(g)
    log(graph_line(g.order, g.size) + " (removeSelfLoops)")

    cfg = ExperimentConfig(
        repeat_batch=args.repeat_batch,
        repeat_method=args.repeat_method,
        batch_length=args.batch_length,
        deletions_begin=args.deletions_begin,
        deletions_end=args.deletions_end,
        deletions_step=args.deletions_step,
        metrics=tuple(get_metric(m).name for m in args.metrics.split(",") if m),
        degrees=tuple(int(d) for d in args.degrees.split(",") if d),
        num_threads=num_threads,
        seed=args.seed,
        cap=args.cap or None,
        min_score=args.min_score,
        jsonl=args.jsonl,
        fused_metrics=not args.unfused,
        device=args.device,
    )
    run_experiment(g, cfg)
    print()
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
