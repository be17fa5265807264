"""Serving mode on the PyTorch port: "top links for THESE vertices" — the
request-shaped API (the port of ``examples/serving/run.py``).

The reference is an offline experiment driver; a production link-prediction
service answers per-user requests instead.  This example shows the serving
path the port exposes for that (``linkpred_tpu_torch/predict/api.py``
sources=..., PlanCache, ``top_per_source``):

  * source-restricted plans: only the requested vertices expand (directed
    candidates (s, w), not just the upper triangle);
  * ``PlanCache`` reuses the host-built plan across requests with the same
    (graph, threshold, sources) — request latency is scoring-only;
  * ``top_per_source`` turns the engine's global top-k into a per-user top-k.

Run: python examples/serving/run_torch.py [--device cpu]   (default: the
CUDA card; seconds)
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))
from linkpred_tpu_torch import (PlanCache, PredictOptions,  # noqa: E402
                                from_edges, predict_links, top_per_source)
from linkpred_tpu_torch.ops.transform import (  # noqa: E402
    remove_self_loops, symmetrize)
from linkpred_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(n=5000, m=60_000, users=64, *, device="cuda"):
    """Three requests for the same ``users`` through one ``PlanCache``;
    returns their results."""
    device = resolve_device(device)
    rng = np.random.default_rng(7)
    g = remove_self_loops(symmetrize(from_edges(
        rng.integers(0, n, m), rng.integers(0, n, m), n=n)))
    print(f"graph: n={g.n} |E|={g.size} (directed); device {device}")

    cache = PlanCache()
    users = np.sort(rng.choice(n, size=users, replace=False)).astype(np.int64)

    results = []
    for request in range(3):
        t0 = time.perf_counter()
        res = predict_links(
            g, metric="adamic_adar", min_degree1=64, sources=users,
            options=PredictOptions(max_edges=64 * 50), plan_cache=cache,
            device=device)
        wall = (time.perf_counter() - t0) * 1e3
        results.append(res)
        top5 = top_per_source(res, 5)
        served = len(set(top5.u.tolist()))
        # request 0 builds the plan and, on the card, the kernels at their
        # first use: its wall is set-up, not a request's latency
        print(f"request {request}: {len(res)} candidates -> top-5 for "
              f"{served} users, wall {wall:.0f} ms "
              f"(scoring {res.scoring_ms:.1f} ms)"
              + ("  [set-up, not a latency: plan built; on the card also "
                 "the kernels' first-use build]" if request == 0
                 else "  [plan cached]"))

    # per-user sanity: every served row's source is a requested user and
    # scores within a user are descending
    u_set = set(users.tolist())
    if not all(int(u) in u_set for u in top5.u):
        raise AssertionError("a served row's source is not a requested user")
    order = np.argsort(top5.u, kind="stable")
    u_s, s_s = top5.u[order], top5.score[order]
    for i in range(1, len(u_s)):
        if u_s[i] == u_s[i - 1] and s_s[i] > s_s[i - 1] + 1e-6:
            raise AssertionError(f"user {u_s[i]}: scores not descending")
    print("OK: per-user top-5 lists are user-restricted and score-ordered")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    main(device=ap.parse_args().device)
