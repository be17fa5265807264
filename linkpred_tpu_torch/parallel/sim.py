"""N coordinated rank processes on one host: the sharded pass held against
the single-process pass (the port's counterpart of
``examples/multihost_sim/run.py`` and of ``__graft_entry__.dryrun_multichip``).

    python -m linkpred_tpu_torch.parallel.sim N [--device cpu|cuda]
        [--spec SPEC.json] [--out RESULT.npz] [--dryrun]
        [--timeout SECONDS]

The launcher starts N rank processes that meet through a ``file://`` store
in a fresh temporary directory (no port, so parallel runs cannot collide),
waits for them with a deadline, stops every rank as soon as one fails or
the deadline passes, prints every rank's output, and exits non-zero unless
every rank exited 0.

Each rank builds the same graph and plan and runs ``predict_links_multi``
under ``make_global_mesh()``; rank 0 also runs the single-process pass on
its device and fails on any difference (the same score multiset, the same
pairs above the k-th score).  Each rank prints one ``SIM {json}`` line per
case: its stream bytes beside the padded total, the priced device bytes
beside the free memory, its K1 and K2 launches, the pass and gather
times.  Rank 0 writes its results to ``--out``.

``--spec`` is a JSON list of cases, each ``{"name", "graph" (an .npz
path; default: a 300-vertex random graph), "metrics", "min_degree1",
"cap", "slot_budget", "max_edges", "sources", "repeat"}``.  ``--dryrun``
runs one experiment step instead: deletions on a planted-partition graph,
``apply_batch``, the sharded pass, and the recall of the removed edges.
``--device cuda`` puts rank r on ``cuda:{r % device_count}``; the backend
is ``distributed.default_backend``'s: ``nccl`` when each rank owns a card,
else ``gloo``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

TOY_CASE = dict(name="toy", graph=None, metrics=["jaccard_coefficient"],
                min_degree1=8, cap=2048, slot_budget=None, max_edges=200,
                sources=None, repeat=1)


def _toy_graph():
    """The reference simulation's graph: 300 vertices, 1,800 random
    edges, symmetrized, seed 7."""
    from ..graph import from_edges
    from ..ops.transform import remove_self_loops, symmetrize

    rng = np.random.default_rng(7)
    n, m = 300, 1800
    return remove_self_loops(symmetrize(from_edges(
        rng.integers(0, n, m), rng.integers(0, n, m), n=n)))


def same_result(got, want, where: str) -> None:
    """Raise unless ``got`` has ``want``'s length and score multiset and
    the same pairs above the k-th score (ties there may pick others)."""
    if len(got) != len(want):
        raise AssertionError(f"{where}: {len(got)} results, want {len(want)}")
    if not np.array_equal(np.sort(got.score), np.sort(want.score)):
        raise AssertionError(f"{where}: score multisets differ")
    if len(want):
        cut = want.score.min()
        above = [{(int(u), int(v)) for u, v, s in zip(r.u, r.v, r.score)
                  if s > cut} for r in (got, want)]
        if above[0] != above[1]:
            raise AssertionError(f"{where}: pairs above the k-th score "
                                 "differ")


def _stream_totals(passes, weighted: bool):
    """(padded total bytes of the full streams, bytes of one cap-lane
    window tail of every array) over the passes."""
    total = tail = 0
    for p in passes:
        for a in p.host_stream(weighted):
            if a is not None and a.shape[0] > 1:
                total += a.nbytes
                tail += p.cap * a.itemsize
            elif a is not None:
                total += a.nbytes
    return total, tail


def _launches():
    from ..ops import compact
    from ..ops import fused_tail as ft

    return ft.LAUNCHES, compact.LAUNCHES


def run_case(case: dict, mesh) -> tuple:
    """One case on this rank; returns (its JSON record, the results)."""
    import torch

    from ..io.npz import load_graph
    from ..ops.topk import TopK
    from ..predict import api
    from ..predict.api import PredictOptions, predict_links_multi
    from ..predict.metrics import get_metric
    from ..predict.plan import build_plan
    from ..utils.device import free_bytes
    from .mesh import gather_topk

    case = {**TOY_CASE, **case}
    g = _toy_graph() if case["graph"] is None else load_graph(case["graph"])
    names = [get_metric(m).name for m in case["metrics"]]
    sources = (None if case["sources"] is None
               else np.asarray(case["sources"], dtype=np.int64))
    t0 = time.perf_counter()
    plan = build_plan(g, case["min_degree1"], case["cap"],
                      slot_budget=case["slot_budget"], sources=sources,
                      device=mesh.device)
    plan_ms = (time.perf_counter() - t0) * 1e3
    opts = PredictOptions(max_edges=case["max_edges"], repeat=case["repeat"])
    passes = [plan, *api._sub_plans(plan)]
    k = api._exact_k(plan, opts.max_edges)
    weighted = any(get_metric(m).needs_weight for m in names)
    priced = api.device_bytes(g, passes, len(names), k, weighted,
                              mesh.device, mesh)
    free = free_bytes(mesh.device)
    padded_total, cap_tail = _stream_totals(passes, weighted)

    k1, k2 = _launches()
    res = predict_links_multi(g, names, plan=plan, options=opts, mesh=mesh,
                              sources=sources)
    k1, k2 = _launches()[0] - k1, _launches()[1] - k2

    # the merge's collective alone, on a [M, k] buffer of this pass's size
    buf = TopK(*(torch.zeros((len(names), k), dtype=dt, device=mesh.device)
                 for dt in (torch.float32, torch.int32, torch.int32)))
    gather_topk(buf, mesh, k)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    gather_topk(buf, mesh, k)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    gather_ms = (time.perf_counter() - t0) * 1e3

    if mesh.rank == 0:
        single = predict_links_multi(g, names, plan=plan, options=opts,
                                     sources=sources, device=mesh.device)
        for name in names:
            same_result(res[name], single[name], f"{case['name']}/{name}")
    record = dict(
        case=case["name"], rank=mesh.rank, world=mesh.size,
        backend=mesh.backend, device=str(mesh.device), n=g.n, edges=g.m,
        packed=plan.packed, tiles=plan.num_tiles, cap=plan.cap,
        passes=len(passes), k=k, stream_bytes=priced["stream"]
        + priced["middeg"], padded_total_bytes=padded_total,
        cap_tail_bytes=cap_tail, priced_bytes=priced["total"],
        free_bytes=free, k1_launches=k1, k2_launches=k2, plan_ms=plan_ms,
        pass_ms=res[names[0]].scoring_ms * len(names), gather_ms=gather_ms,
        results=len(res[names[0]]))
    return record, res


def dryrun(mesh) -> dict:
    """One experiment step on the mesh: deletions on a planted-partition
    graph, ``apply_batch``, the sharded pass; rank 0 holds it against the
    single-process pass and reports the recall of the removed edges."""
    from ..bench.harness import common_pair_count, directed_pairs
    from ..bench.synth import planted_partition_graph
    from ..ops.batch import apply_batch, generate_edge_deletions, tidy_batch
    from ..predict.api import PredictOptions, predict_links

    g = planted_partition_graph(8, 32, p_in=0.4, p_out=0.002, seed=1)
    rng = np.random.default_rng(0)
    deletions = generate_edge_deletions(rng, g, g.size // 20, undirected=True)
    deletions, insertions = tidy_batch(deletions, np.empty((0, 2), np.int64),
                                       g)
    y = apply_batch(g, deletions, insertions)
    opts = PredictOptions(max_edges=max(deletions.shape[0] // 2, 1))
    res = predict_links(y, "jaccard_coefficient", min_degree1=0,
                        options=opts, cap=4096, mesh=mesh)
    record = dict(case="dryrun", rank=mesh.rank, world=mesh.size,
                  backend=mesh.backend, device=str(mesh.device),
                  results=len(res))
    if mesh.rank == 0:
        ref = predict_links(y, "jaccard_coefficient", min_degree1=0,
                            options=opts, cap=4096, device=mesh.device)
        if not len(ref):
            raise AssertionError("dryrun: no predictions")
        same_result(res, ref, "dryrun")
        predicted = directed_pairs(np.stack([res.u, res.v], axis=1),
                                   undirected=True)
        record["recall"] = common_pair_count(deletions, predicted) / max(
            deletions.shape[0], 1)
    return record


def _write(path: str, results: dict) -> None:
    arrays = {}
    for case, res in results.items():
        for name, r in res.items():
            for field in ("u", "v", "score"):
                arrays[f"{case}/{name}/{field}"] = getattr(r, field)
    np.savez(path, **arrays)


def rank_main(args) -> int:
    import torch

    from .distributed import (default_backend, init_distributed,
                              make_global_mesh)

    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.world))
    init_distributed(args.init_method, args.world, args.rank,
                     backend=default_backend(args.world, args.device),
                     timeout=datetime.timedelta(seconds=args.timeout))
    try:
        mesh = make_global_mesh(device="cpu" if args.device == "cpu"
                                else None)
        if args.dryrun:
            print("SIM " + json.dumps(dryrun(mesh)), flush=True)
        else:
            cases = [TOY_CASE]
            if args.spec:
                with open(args.spec) as f:
                    cases = json.load(f)
            results = {}
            for case in cases:
                record, results[case["name"]] = run_case(case, mesh)
                print("SIM " + json.dumps(record), flush=True)
            if args.out and mesh.rank == 0:
                _write(args.out, results)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    bad = sorted(m for m, mod in sys.modules.items() if mod is not None
                 and m.split(".")[0] in ("jax", "jaxlib", "linkpred_tpu"))
    if bad:
        raise AssertionError(f"rank {args.rank} imported {bad[:5]}")
    return 0


def launch(n: int, rank_args: list, timeout: float, command=None) -> int:
    """Start ``n`` rank processes, wait for them (stopping all when one
    fails or the deadline passes), print their output; 0 iff all exited 0.
    Rank r runs ``command`` (default: this module) with ``--rank r --world
    n --init-method file://...`` and ``rank_args``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    command = command or [sys.executable, "-m",
                          "linkpred_tpu_torch.parallel.sim"]
    with tempfile.TemporaryDirectory(prefix="lp_sim_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        logs, procs = [], []
        for r in range(n):
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [*command, "--rank", str(r), "--world", str(n),
                 "--init-method", init, *rank_args],
                env=dict(env, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n)),
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.monotonic() > deadline:
                    failed = f"deadline of {timeout} s passed"
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait(timeout=60)
        rcs = [p.returncode for p in procs]
        for r, log in enumerate(logs):
            log.seek(0)
            for line in log.read().splitlines():
                print(f"[rank {r}] {line}")
            log.close()
    if failed or any(rcs):
        print(f"sim: FAILED ({failed or 'a rank failed'}); exit codes {rcs}",
              flush=True)
        return 1
    print(f"sim: OK, {n} ranks", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m linkpred_tpu_torch."
                                 "parallel.sim", description=__doc__.split(
                                     "\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=2,
                    help="rank processes to start")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--spec", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        return rank_main(args)
    rank_args = ["--device", args.device, "--timeout", str(args.timeout)]
    for flag, value in (("--spec", args.spec), ("--out", args.out)):
        if value:
            rank_args += [flag, os.path.abspath(value)]
    if args.dryrun:
        rank_args.append("--dryrun")
    return launch(args.n, rank_args, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
