"""Readings that the limits of ``correct`` are set from, at a cell's own
size, outside the benchmark's runs::

    python3 -m lpbench.control --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--requests 70]

For each seed of ``--seeds``, the program: a whole-graph cell builds the
plan and makes one call as the window does; a serving cell answers
``--requests`` requests of the seed's stream.  For each seed of
``--control-seeds``, the control: the plain reference put in the
program's place and computed in bfloat16, the precision below the
float32 the configuration states.  Each is judged as a run is, a traffic
that names several metrics metric by metric; one JSON line a reading on
standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from . import graph500, judge
from .reference import served_topk, whole_graph_topks
from .run import ROOT, _load_json, cell_of

__all__ = ["program_readings", "control_readings", "main"]


def _users(g_deg: np.ndarray, seed: int, count: int, n_users: int):
    active = np.nonzero(g_deg > 0)[0]
    rng = np.random.default_rng([int(seed), 0])
    return [np.sort(rng.choice(active, size=n_users, replace=False))
            for _ in range(count)]


def program_readings(cfg, traffic, seed: int, device, requests: int = 0):
    """The judge's numbers of the program's answers on one seed."""
    from linkpred_tpu_torch.predict.api import (PredictOptions,
                                                predict_links,
                                                predict_links_multi,
                                                top_per_source)
    from linkpred_tpu_torch.predict.plan import build_plan

    from .drive import _program_graph

    g, k = graph500.make_graph(cfg, seed, device)
    y = _program_graph(g)
    d1 = int(cfg["min_degree1"])
    if traffic["kind"] == "whole_graph":
        plan = build_plan(y, d1, device=device)
        res = predict_links_multi(y, judge.metric_names(traffic), d1,
                                  options=PredictOptions(max_edges=k),
                                  plan=plan, device=device)
        answer = {m: (r.u, r.v, r.score) for m, r in res.items()}
        del plan, res
        return judge.judge_whole_graph(g, traffic, d1, k, [answer])
    metric = traffic["metric"]
    n_users = int(traffic["users"])
    max_edges = n_users * int(traffic["edges_per_user"])
    answers = []
    for users in _users(y.degrees, seed, requests, n_users):
        res = predict_links(y, metric, d1,
                            options=PredictOptions(max_edges=max_edges),
                            sources=users, device=device)
        top = top_per_source(res, int(traffic["per_user"]))
        answers.append((users, (top.u, top.v, top.score)))
    return judge.judge_served(g, metric, d1, answers, max_edges=max_edges,
                              per_user=int(traffic["per_user"]),
                              band=float(traffic["limits"]["rank_gap"]))


def control_readings(cfg, traffic, seed: int, device, requests: int = 0,
                     dtype=torch.bfloat16):
    """The judge's numbers of the reference computed in ``dtype`` in the
    program's place."""
    g, k = graph500.make_graph(cfg, seed, device)
    d1 = int(cfg["min_degree1"])

    def host(t):
        return t.float().cpu().numpy()

    if traffic["kind"] == "whole_graph":
        tops = whole_graph_topks(g, judge.metric_names(traffic), d1, k,
                                 dtype=dtype)
        answer = {m: (host(u), host(v), host(s))
                  for m, (u, v, s) in tops.items()}
        del tops
        return judge.judge_whole_graph(g, traffic, d1, k, [answer])
    metric = traffic["metric"]
    n_users = int(traffic["users"])
    max_edges = n_users * int(traffic["edges_per_user"])
    deg = g.degrees.cpu().numpy()
    answers = []
    for users in _users(deg, seed, requests, n_users):
        u, v, s = served_topk(g, metric, d1,
                              torch.as_tensor(users, device=g.indices.device),
                              max_edges, int(traffic["per_user"]),
                              dtype=dtype)
        answers.append((users, (host(u).astype(np.int64),
                                host(v).astype(np.int64), host(s))))
    return judge.judge_served(g, metric, d1, answers, max_edges=max_edges,
                              per_user=int(traffic["per_user"]),
                              band=float(traffic["limits"]["rank_gap"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--requests", type=int, default=70)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = _load_json(ROOT, "BENCHMARK.json")
    _, cfg, traffic = cell_of(bench, args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("lpbench.control: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device(args.device)

    def seeds(s):
        return [int(x) for x in s.split(",") if x]

    for side, fn, ss in (("program", program_readings, seeds(args.seeds)),
                         ("control", control_readings,
                          seeds(args.control_seeds))):
        for seed in ss:
            t = time.perf_counter()
            numbers = fn(cfg, traffic, seed, device, args.requests)
            print(json.dumps({"workload": args.workload, "side": side,
                              "seed": seed, "numbers": numbers,
                              "seconds": time.perf_counter() - t}),
                  flush=True)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
