"""IHub vs LHub on the PyTorch port: the headline speedup experiment of the
reference (the port of ``examples/ihub_vs_lhub/run.py``).

The reference's central claim is that LHub — skipping hub intermediates with
degree > threshold — beats the exhaustive IHub scan by 415x (0.1|E| removed)
to 1622x (10^-2|E| removed) on average while matching its F1 score.  This
example runs that comparison on R-MAT graphs:

    for each scale, for each removal fraction:
        IHub  = predict_links(..., min_degree1=0)    # scan everything
        LHub  = predict_links(..., min_degree1=64)   # skip hubs (best-F1 regime)

and reports scoring time, the LHub/IHub speedup, and both F1 scores.  The
host plan is built outside the scoring time (it shows in each leg's wall).

Usage:  python examples/ihub_vs_lhub/run_torch.py [scales...] [--device cpu]
            [--out-dir DIR]       (default scales 14 15 16; the CUDA card)
Writes speedup_cuda.csv + speedup_cuda.md into DIR (default: next to this
file), merging only with the rows of a speedup_cuda.csv already there.
"""
from __future__ import annotations

import argparse
import csv
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))

from linkpred_tpu_torch import PredictOptions, predict_links  # noqa: E402
from linkpred_tpu_torch.bench.harness import (  # noqa: E402
    common_pair_count, directed_pairs)
from linkpred_tpu_torch.bench.synth import rmat_graph  # noqa: E402
from linkpred_tpu_torch.ops.batch import (  # noqa: E402
    apply_batch, generate_edge_deletions, tidy_batch)
from linkpred_tpu_torch.utils.device import resolve_device  # noqa: E402

METRIC = "jaccard_coefficient"   # the reference sweeps 9 and plots the best;
#                                  jaccard is its best-F1 measure on most graphs
HUB_DEG = 64                     # LHub threshold of the reference headline
CSV_NAME, MD_NAME = "speedup_cuda.csv", "speedup_cuda.md"


def removal_batch(g, frac: float):
    """``g`` with ``frac`` of its undirected edges removed (seed 0): the
    graph after the batch and the tidied deletions."""
    rng = np.random.default_rng(0)
    dels = generate_edge_deletions(
        rng, g, int(frac * g.size / 2), undirected=True)
    dels, ins = tidy_batch(dels, np.empty((0, 2), np.int64), g)
    return apply_batch(g, dels, ins), dels


def run_one(y, deletions0, min_degree1: int, repeat: int, *,
            device="cuda"):
    max_edges = max(deletions0.shape[0] // 2, 1)
    res = predict_links(
        y, metric=METRIC, min_degree1=min_degree1,
        options=PredictOptions(repeat=repeat, max_edges=max_edges),
        device=device)
    predicted = np.stack([res.u, res.v], axis=1).astype(np.int64)
    insertions1 = directed_pairs(predicted, undirected=True)
    common = common_pair_count(deletions0, insertions1)
    precision = common / max(insertions1.shape[0], 1)
    recall = common / max(deletions0.shape[0], 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    return res.scoring_ms, f1


def device_name(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "CPU, plain kernels"."""
    if device.type == "cpu":
        return "CPU, plain kernels"
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    lines = r.stdout.strip().splitlines()
    return lines[device.index or 0]


def main(scales=(14, 15, 16), fractions=(0.01, 0.1), repeat=3, *,
         device="cuda", out_dir=HERE):
    device = resolve_device(device)
    card = device_name(device)
    rows = []
    for scale in scales:
        print(f"s{scale}: building R-MAT graph...", flush=True)
        g = rmat_graph(scale, edge_factor=16, seed=42)
        for frac in fractions:
            y, dels = removal_batch(g, frac)
            print(f"s{scale} frac={frac}: batch applied "
                  f"(|E|={y.size}); scoring IHub on {device}...", flush=True)
            t0 = time.time()
            ihub_ms, ihub_f1 = run_one(y, dels, 0, repeat, device=device)
            print(f"s{scale} frac={frac}: IHub {ihub_ms:.1f} ms f1={ihub_f1:.4f}"
                  f" (wall {time.time() - t0:.0f}s)", flush=True)
            t0 = time.time()
            lhub_ms, lhub_f1 = run_one(y, dels, HUB_DEG, repeat, device=device)
            print(f"s{scale} frac={frac}: LHub {lhub_ms:.1f} ms f1={lhub_f1:.4f}"
                  f" (wall {time.time() - t0:.0f}s)", flush=True)
            rows.append(dict(
                scale=scale, n=g.n, m_directed=y.size, fraction=frac,
                ihub_ms=round(ihub_ms, 2), lhub_ms=round(lhub_ms, 2),
                speedup=round(ihub_ms / max(lhub_ms, 1e-9), 1),
                ihub_f1=round(ihub_f1, 4), lhub_f1=round(lhub_f1, 4),
                device=card,
            ))
    # merge with rows of scales NOT re-measured this run (partial reruns like
    # `run_torch.py 16` must not clobber the rest of the table)
    os.makedirs(out_dir, exist_ok=True)
    csv_path = os.path.join(out_dir, CSV_NAME)
    if os.path.exists(csv_path):
        with open(csv_path, newline="") as f:
            rows += [r for r in csv.DictReader(f)
                     if int(r["scale"]) not in set(scales)]
    rows.sort(key=lambda r: (int(r["scale"]), float(r["fraction"])))
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    devices = ", ".join(sorted({r["device"] for r in rows}))
    with open(os.path.join(out_dir, MD_NAME), "w") as f:
        f.write(
            "# LHub vs IHub speedup (R-MAT, jaccard, hub threshold 64, "
            f"PyTorch port on {devices})\n\n"
            "The reference's headline comparison (LHub against IHub, 13"
            " SuiteSparse graphs),\non R-MAT graphs;"
            " `python examples/ihub_vs_lhub/run_torch.py` regenerates.\n\n"
            "| scale | \\|E\\| dir | removed | IHub ms | LHub ms | speedup |"
            " IHub F1 | LHub F1 |\n|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['scale']} | {int(r['m_directed']):,} |"
                    f" {r['fraction']} | {float(r['ihub_ms']):,.1f} |"
                    f" {float(r['lhub_ms']):.1f} |"
                    f" **{float(r['speedup']):,.1f}x** |"
                    f" {r['ihub_f1']} | {r['lhub_f1']} |\n")
        f.write("""
Notes:

- IHub and LHub ms are `scoring_ms`: the mean of `repeat` passes after an
  untimed one, on the device named above.  The host plan is outside it;
  it shows in each leg's wall in the run's output.
- F1 is near 0 for BOTH approaches on R-MAT: synthetic R-MAT graphs have
  far weaker triadic closure than the reference's web/social graphs.  The
  claim these columns support is the reference's equivalence claim —
  LHub's F1 matches IHub's — not absolute accuracy; for F1-meaningful
  recovery see `examples/ppart_sweep` (planted partitions).
""")
    print("wrote", csv_path)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scales", nargs="*", type=int, default=[14, 15, 16])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out-dir", default=HERE)
    args = ap.parse_args()
    main(tuple(args.scales), device=args.device, out_dir=args.out_dir)
