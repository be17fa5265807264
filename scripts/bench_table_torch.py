"""The PyTorch port's scale table: one bench row per scale, each in a fresh
process (the port of ``scripts/bench_table.py``).

    python scripts/bench_table_torch.py [scales...] [--device cpu]
                                         # default 18 19 20 21 22, the card

Each row runs ``python -m linkpred_tpu_torch.bench.run`` (``bench.py``'s
protocol: LHub jaccard, deg 64, 0.1|E| removed, adaptive cap, repeat 5) in
a process of its own, so no row inherits another's allocator, caches or
warm-up, and reuses its graph cache (``BENCH_CACHE_DIR``); rows print as
they finish.  A row that fails prints FAILED and the exit code is 1.
``--device`` defaults to ``BENCH_DEVICE``, else the card.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("scales", nargs="*", type=int,
                    default=[18, 19, 20, 21, 22])
    ap.add_argument("--device",
                    default=os.environ.get("BENCH_DEVICE", "cuda"),
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from linkpred_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)      # raises here without a card
    path = os.pathsep.join(
        [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    rows = []
    for s in args.scales:
        env = dict(os.environ, BENCH_SCALE=str(s), BENCH_DEVICE=args.device,
                   PYTHONPATH=path)
        r = subprocess.run(
            [sys.executable, "-m", "linkpred_tpu_torch.bench.run"], env=env,
            cwd=ROOT, capture_output=True, text=True)
        line = (r.stdout.strip().splitlines() or [""])[-1]
        if r.returncode != 0 or not line.startswith("{"):
            print(f"s{s}: FAILED rc={r.returncode} {r.stderr.strip()[-200:]}",
                  flush=True)
            continue
        d = json.loads(line)
        rows.append((s, d))
        print(f"s{s}: {d['value']/1e6:.1f}M edges/s "
              f"(vs_baseline {d['vs_baseline']:.2f})", flush=True)
    if rows:
        print("\n| graph | rate | vs reference headline |")
        print("|---|---|---|")
        for s, d in rows:
            print(f"| RMAT-{s} | {d['value']/1e6:.1f}M edges/s | "
                  f"{d['vs_baseline']:.2f}x |")
    return 0 if len(rows) == len(args.scales) else 1


if __name__ == "__main__":
    sys.exit(main())
