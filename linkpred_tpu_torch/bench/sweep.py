"""Multi-graph sweep runner — the reference's ``main.sh`` as a Python module
(counterpart of ``linkpred_tpu/bench/sweep.py``).

The reference batch script sets env-var config, compiles, loops 17
SuiteSparse graphs, and appends logs (its ``main.sh:29-65``).  Here:

    python -m linkpred_tpu_torch.bench.sweep --graphs a.mtx,b.mtx --out-dir results \
        [--synthetic rmat:18:16,ppart:64:64] [experiment flags...]

Each graph runs the full experiment (:mod:`linkpred_tpu_torch.bench.harness`),
logs stream to ``<out-dir>/sweep.log`` in the reference grammar, and
per-graph CSVs come from the bundled post-processor.  Synthetic
``rmat:<scale>:<edge_factor>`` and ``ppart:<communities>:<size>`` specs stand
in for SuiteSparse downloads on a host without them.

Scoring runs on the CUDA card; ``--device cpu`` runs the kernels' plain
versions on the CPU, and without it a machine with no card raises.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from ..io.mtx import read_mtx
from ..ops.transform import remove_self_loops, symmetrize
from ..utils.device import device_count, resolve_device
from ..utils.logging import graph_line, log
from .harness import ExperimentConfig, run_experiment
from .process import process_csv, read_log, write_csv
from .synth import rmat_graph

__all__ = ["main", "run_sweep"]


class _Tee:
    def __init__(self, *streams):
        self.streams = streams

    def write(self, data):
        for s in self.streams:
            s.write(data)

    def flush(self):
        for s in self.streams:
            s.flush()


def run_sweep(graphs, cfg: ExperimentConfig, out_dir: str,
              symmetric: bool = False, weighted: bool = False,
              resume: bool = False) -> str:
    """Run the experiment over ``graphs`` on ``cfg.device``; returns the
    log path.

    Each item is a path, a ``("name", CSRGraph)`` pair (synthetic), or a
    ``(path, symmetric_bool)`` pair — the per-graph symmetric flag of the
    reference's run list (``main.sh:46-62`` passes it per graph), overriding
    the sweep-wide ``symmetric``.

    ``resume=True`` makes the run restartable: graphs whose results already
    appear in ``<out_dir>/sweep.log`` are skipped (the log doubles as the
    checkpoint, like the reference's append-only ``tee -a`` protocol, but
    with skip-on-restart semantics).
    """
    # raises here, before any work, when the card is asked for and missing
    num_threads = device_count(cfg.device)
    os.makedirs(out_dir, exist_ok=True)
    log_path = os.path.join(out_dir, "sweep.log")
    done = set()
    if resume and os.path.exists(log_path):
        done = {name for name, rows in read_log(log_path).items() if rows}

    with open(log_path, "a") as logf:
        out = _Tee(sys.stdout, logf)
        for item in graphs:
            g_symmetric = symmetric
            if isinstance(item, tuple) and isinstance(item[1], bool):
                item, g_symmetric = item  # (path, per-graph symmetric flag)
            stem = (item[0] if isinstance(item, tuple)
                    else os.path.splitext(os.path.basename(str(item)))[0])
            if stem in done:
                log(f"skipping {stem} (already in {log_path})")
                continue
            if isinstance(item, tuple):
                name, g = item
                path = f"/synthetic/{name}.mtx"
                print(f"{_ts()} OMP_NUM_THREADS={num_threads}", file=out)
                print(f"{_ts()} Loading graph {path} ...", file=out)
                print(f"{_ts()} {graph_line(g.order, g.size)}", file=out)
            else:
                path = str(item)
                print(f"{_ts()} OMP_NUM_THREADS={num_threads}", file=out)
                print(f"{_ts()} Loading graph {path} ...", file=out)
                g = read_mtx(path, weighted=weighted)
                print(f"{_ts()} {graph_line(g.order, g.size)}", file=out)
                if not g_symmetric:
                    g = symmetrize(g)
                    print(f"{_ts()} {graph_line(g.order, g.size)} (symmetrize)",
                          file=out)
                g = remove_self_loops(g)
                print(f"{_ts()} {graph_line(g.order, g.size)} (removeSelfLoops)",
                      file=out)
            run_experiment(g, cfg, emit=lambda line: print(line, file=out))
            print("", file=out)
    return log_path


def _ts() -> str:
    import datetime

    return datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")


def _parse_synthetic(spec: str):
    kind, *params = spec.split(":")
    if kind == "rmat":
        scale = int(params[0]) if params else 16
        ef = int(params[1]) if len(params) > 1 else 16
        return f"rmat_s{scale}_e{ef}", rmat_graph(scale, edge_factor=ef)
    if kind == "ppart":
        from .synth import planted_partition_graph

        nc = int(params[0]) if params else 64
        sz = int(params[1]) if len(params) > 1 else 64
        return f"ppart_c{nc}_s{sz}", planted_partition_graph(nc, sz)
    raise ValueError(
        f"unknown synthetic spec {spec!r} (want rmat:scale:ef or ppart:nc:size)")


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="linkpred_tpu_torch.bench.sweep")
    p.add_argument("--graphs", default="", help="comma-separated .mtx paths")
    p.add_argument("--synthetic", default="",
                   help="comma-separated rmat:<scale>:<edge_factor> specs")
    p.add_argument("--suite", choices=("reference", "reference-headline"),
                   default=None,
                   help="run the reference's 17-graph SuiteSparse protocol "
                        "(main.sh:46-62), with ITS per-graph symmetric flags; "
                        "'reference-headline' appends sk-2005")
    p.add_argument("--data-dir", default=os.path.expanduser("~/Data"),
                   help="directory holding the suite's .mtx files "
                        "(the reference uses ~/Data)")
    p.add_argument("--allow-missing", action="store_true",
                   help="run the suite graphs that ARE present instead of "
                        "erroring on the first missing one")
    p.add_argument("--out-dir", default="results")
    p.add_argument("--symmetric", action="store_true")
    p.add_argument("--weighted", action="store_true")
    p.add_argument("--metrics", default=None)
    p.add_argument("--degrees", default=None)
    p.add_argument("--repeat-batch", type=int, default=5)
    p.add_argument("--repeat-method", type=int, default=5)
    p.add_argument("--deletions-begin", type=float, default=1e-4)
    p.add_argument("--deletions-end", type=float, default=1e-1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cap", type=int, default=1 << 20)  # 0 = adaptive
    p.add_argument("--resume", action="store_true",
                   help="skip graphs already present in the sweep log")
    p.add_argument("--device", default="cuda",
                   help="where scoring runs: cuda (default; raises without a "
                        "card) or cpu (the kernels' plain versions)")
    args = p.parse_args(argv)
    # raises here, before any graph is built, when the card is missing
    resolve_device(args.device)

    graphs = [g for g in args.graphs.split(",") if g]
    graphs += [_parse_synthetic(s) for s in args.synthetic.split(",") if s]
    if args.suite:
        from .suite import missing_report, resolve_suite

        present, missing = resolve_suite(
            args.data_dir, include_headline=args.suite == "reference-headline")
        if missing:
            print(missing_report(missing), file=sys.stderr)
            if not args.allow_missing:
                p.error(f"{len(missing)} suite graphs missing from "
                        f"{args.data_dir} (use --allow-missing to run the "
                        "present subset)")
        graphs += [(path, rg.symmetric) for path, rg in present]
    if not graphs:
        p.error("no graphs: pass --graphs, --synthetic and/or --suite")

    cfg = ExperimentConfig(
        repeat_batch=args.repeat_batch, repeat_method=args.repeat_method,
        deletions_begin=args.deletions_begin, deletions_end=args.deletions_end,
        seed=args.seed, cap=args.cap or None, device=args.device,
        **({"metrics": tuple(args.metrics.split(","))} if args.metrics else {}),
        **({"degrees": tuple(int(d) for d in args.degrees.split(","))}
           if args.degrees else {}),
    )
    log_path = run_sweep(graphs, cfg, args.out_dir,
                         symmetric=args.symmetric, weighted=args.weighted,
                         resume=args.resume)
    data = read_log(log_path)
    write_csv(os.path.join(args.out_dir, "sweep.csv"), process_csv(data))
    for name, rows in data.items():
        write_csv(os.path.join(args.out_dir, f"{name}.csv"), rows)
    if args.suite:
        # compare the measured suite-average F1 against the published
        # brackets (the reference's README.md:21) with tie tolerance
        import json as _json

        from .suite import f1_report

        rep = f1_report(row for rows in data.values() for row in rows)
        rp = os.path.join(args.out_dir, "f1_report.json")
        with open(rp, "w") as f:
            _json.dump({f"{a}@{frac:g}": v for (a, frac), v in rep.items()},
                       f, indent=2)
        log(f"F1 vs published brackets written to {rp}")
    log(f"sweep complete: {log_path}")
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
