"""Headline benchmark: LHub link-prediction rate (edges scored per second)
on the card (counterpart of the repository's ``bench.py``).

    python -m linkpred_tpu_torch.bench.run

The reference's headline metric is the link-prediction rate in |E|/s on a
skewed web-scale graph (38.1M edges/s, LHub, sk-2005, 0.1|E| removed, hub
threshold 64).  Here, as in ``bench.py``, an R-MAT graph with power-law skew
stands in for it: rate = |E_directed| / scoring time.

Prints ONE JSON line with exactly ``bench.py``'s keys: ``metric``, ``value``
(the MEDIAN of ``BENCH_SAMPLES`` in-process samples, each the mean of
``BENCH_REPEAT`` timed passes after an untimed one), ``unit``,
``vs_baseline``, ``engine``, ``samples``, ``rate_min``, ``rate_max`` and, for
a packed plan, the roofline fields of
:func:`linkpred_tpu_torch.utils.roofline.roofline_report`.

Env knobs (``bench.py``'s, with its defaults): ``BENCH_SCALE`` (19),
``BENCH_METRIC`` (jaccard_coefficient), ``BENCH_DEG`` (64),
``BENCH_REPEAT`` (5), ``BENCH_SAMPLES`` (3), ``BENCH_CAP`` (0 = adaptive),
``BENCH_CACHE_DIR`` (``linkpred_bench_cache`` in the temporary directory).
The run is on the CUDA card; ``BENCH_DEVICE=cpu`` runs the kernels' plain
versions on the CPU, and without it a machine with no card raises.  The
port has one engine, the int64 key: ``BENCH_KEY64=0`` (``bench.py``'s u32
engine) raises.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

__all__ = ["main", "cache_path", "bench_graph", "write_cache"]

# The OpenMP reference's headline rate (LHub, sk-2005, 32 threads).
BASELINE_EDGES_PER_S = 38.1e6


def cache_path(cache_dir: str, scale: int) -> str:
    """The graph cache file of ``scale``: ``bench.py``'s name and format."""
    return os.path.join(cache_dir, f"rmat{scale}_e16_s42_f0.1.npz")


def bench_graph(scale: int, cache_dir: str):
    """R-MAT-``scale`` at the bench protocol (edge factor 16, seed 42,
    0.1|E| undirected edges removed), read from the cache in ``cache_dir``
    when it holds the graph, else made and written there.  Returns (the
    graph after removal, the tidied deletions)."""
    from ..graph import CSRGraph

    # Host setup is deterministic in (scale, seed); the post-batch graph is
    # cached so repeat invocations skip straight to scoring.
    cache = cache_path(cache_dir, scale)
    y = deletions = None
    if os.path.exists(cache):
        try:
            with np.load(cache) as d:
                y = CSRGraph(offsets=d["offsets"], indices=d["indices"],
                             degrees=d["degrees"], weights=None,
                             n=int(d["n"]), m=int(d["m"]))
                deletions = d["deletions"]
        except Exception:       # an unreadable cache file: make the graph
            y = deletions = None
    if y is None:
        from ..ops.batch import (apply_batch, generate_edge_deletions,
                                 tidy_batch)
        from .synth import rmat_graph

        g = rmat_graph(scale, edge_factor=16, seed=42)
        # Reference protocol: remove 0.1|E| edges, predict that many back.
        rng = np.random.default_rng(0)
        deletions = generate_edge_deletions(rng, g, int(0.1 * g.size / 2),
                                            undirected=True)
        deletions, insertions = tidy_batch(
            deletions, np.empty((0, 2), np.int64), g)
        y = apply_batch(g, deletions, insertions)
        try:
            write_cache(cache_dir, scale, y, deletions)
        except Exception:       # an unwritable cache: run without one
            pass
    return y, deletions


def write_cache(cache_dir: str, scale: int, y, deletions) -> None:
    """Write the bench graph ``y`` and its ``deletions`` as the cache file
    of ``scale`` in ``cache_dir``."""
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(cache_path(cache_dir, scale), offsets=np.asarray(y.offsets),
             indices=np.asarray(y.indices), degrees=np.asarray(y.degrees),
             n=np.int64(y.n), m=np.int64(y.m), deletions=deletions)


def main() -> int:
    if os.environ.get("BENCH_KEY64", "1") != "1":
        raise NotImplementedError(
            "BENCH_KEY64=0 asks for the u32 engine, which the port does not "
            "have; its one engine is the int64 key (key64)")
    from ..utils.device import resolve_device

    # raises here, before any work, when the card is asked for and missing
    device = resolve_device(os.environ.get("BENCH_DEVICE", "cuda"))
    scale = int(os.environ.get("BENCH_SCALE", "19"))
    metric = os.environ.get("BENCH_METRIC", "jaccard_coefficient")
    deg = int(os.environ.get("BENCH_DEG", "64"))
    # repeat=5 matches the reference's REPEAT_METHOD=5
    repeat = int(os.environ.get("BENCH_REPEAT", "5"))
    # cap: unset/0 => adaptive (the plan targets ~32 full tiles)
    cap = int(os.environ.get("BENCH_CAP", "0")) or None
    cache_dir = os.environ.get(
        "BENCH_CACHE_DIR",
        os.path.join(tempfile.gettempdir(), "linkpred_bench_cache"))

    from ..predict.api import PredictOptions, predict_links
    from ..predict.metrics import get_metric
    from ..predict.plan import build_plan
    from ..utils.roofline import (device_peak_gbps, packed_pass_min_bytes,
                                  roofline_report)

    y, deletions = bench_graph(scale, cache_dir)
    plan = build_plan(y, deg, cap=cap, device=device)
    # One process takes BENCH_SAMPLES timed samples (each the mean of
    # BENCH_REPEAT passes, the reference's REPEAT_METHOD protocol) and
    # reports the MEDIAN with min/max.
    samples = max(int(os.environ.get("BENCH_SAMPLES", "3")), 1)
    opts = PredictOptions(repeat=repeat,
                          max_edges=max(deletions.shape[0] // 2, 1))
    rates = []
    for _ in range(samples):
        res = predict_links(y, metric=metric, min_degree1=deg,
                            options=opts, cap=cap, plan=plan, device=device)
        rates.append(y.size / max(res.scoring_ms / 1e3, 1e-9))
    rates.sort()
    rate = rates[len(rates) // 2] if samples % 2 else \
        (rates[samples // 2 - 1] + rates[samples // 2]) / 2
    row = {
        "metric": f"lhub_{metric}_deg{deg}_rmat{scale}_rate",
        "value": round(rate, 1),
        "unit": "edges/s",
        "vs_baseline": round(rate / BASELINE_EDGES_PER_S, 4),
        "engine": "key64",
        "samples": samples,
        "rate_min": round(rates[0], 1),
        "rate_max": round(rates[-1], 1),
    }
    # The pass priced at its MINIMUM memory traffic against the median
    # sample's time per pass and the card's peak.  The port always runs the
    # fused tail (K1) and the pack-capable selection (K2).
    if plan.packed:
        total_slots = int(plan.tile_slot_start[-1])
        mb = packed_pass_min_bytes(
            total_slots, num_metrics=1,
            weighted=int(get_metric(metric).needs_weight),
            key64=True, deg16=plan.deg16, fused=True, sel_pack=True)
        median_ms = y.size / rate * 1e3
        # 0.0, not None, where the run's device has no known peak (the CPU,
        # a card not in the table): None would look up the default device
        row.update(roofline_report(mb, median_ms,
                                   peak_gbps=device_peak_gbps(device) or 0.0))
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
