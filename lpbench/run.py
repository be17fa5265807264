"""Run one cell of ``BENCHMARK.json`` once, from the root of a checkout::

    python3 -m lpbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell names its configuration (``lpbench/configs/<config>.json``) and
its traffic mix (``lpbench/traffic/<traffic>.json``); the metrics it
reports are the ``BENCHMARK.json`` entries that apply to it, each read by
``lpbench/end_to_end/<name>.py`` (``--trace 0``) or
``lpbench/layer_metrics/<name>.py`` (``--trace 1``).  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each number compared beside its limit (also the last
lines of standard error).

Exits non-zero and prints no result without a CUDA card (or with fewer
cards than the cell asks for), and when the JAX package, ``jax``,
``jaxlib`` or ``flax`` is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "lpbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "linkpred_tpu")

__all__ = ["main", "cell_of", "load_reader", "metrics_for", "forbidden"]


def _load_json(*parts):
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def cell_of(bench: dict, name: str, base: str = HERE):
    """``(cell, config, traffic)`` of the cell ``name``: its entry and the
    files ``<base>/configs/<config>.json`` and
    ``<base>/traffic/<traffic>.json``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; one of "
                         f"{sorted(cells)}")
    cell = cells[name]
    return (cell, _load_json(base, "configs", cell["config"] + ".json"),
            _load_json(base, "traffic", cell["traffic"] + ".json"))


def load_reader(folder: str, name: str, base: str = HERE):
    """The ``read(rec)`` of ``<base>/<folder>/<name>.py``."""
    path = os.path.join(base, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"lpbench.{folder}.m_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries the cell reports: end-to-end ones without a
    trace, per-layer ones with (every per-layer entry lists its cells)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


def forbidden() -> list:
    """Top-level names in ``sys.modules`` that the run may not hold."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _power_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "?"
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not found"


def main(argv=None, *, device: str = "cuda", shrink=None) -> int:
    """The command.  ``device="cpu"`` (the tests') skips the look for a
    card and runs the program's plain twins; ``shrink`` maps ``config``
    and ``traffic`` to values that replace the files' (tests' sizes)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = _load_json(ROOT, "BENCHMARK.json")
    cell, cfg, traffic = cell_of(bench, args.workload)
    for part, values in (("config", cfg), ("traffic", traffic)):
        values.update((shrink or {}).get(part, {}))

    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            print("lpbench: no CUDA card; nothing was measured",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < int(cell["chips"]):
            print(f"lpbench: the cell asks for {cell['chips']} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        print(f"card: {_power_line()}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", file=sys.stderr, flush=True)

    from . import drive, judge, trace as tr

    rec = drive.run(cfg, traffic, args.seed, args.seconds, bool(args.trace),
                    device=device)
    ok, checks = judge.verdict(rec.numbers, judge.flat_limits(traffic))
    correct = ok and rec.failed == 0 and rec.attempted > 0
    folder = "layer_metrics" if args.trace else "end_to_end"
    metrics = {}
    for m in metrics_for(bench, args.workload, bool(args.trace)):
        v = load_reader(folder, m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    card = {"platform": "gpu", "kind": rec.kind_of_card,
              "count": int(cell["chips"]),
              "memory_peak_bytes": rec.memory_peak_bytes}
    out = {"correct": correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": card}
    if args.trace:
        t0, t1 = tr.window_of(rec.events)
        card["busy_s"] = tr.busy_us(rec.events, t0, t1) / 1e6
        card["window_s"] = (t1 - t0) / 1e6
        out["breakdown"] = tr.breakdown(rec.events, t0, t1)
    out["checks"] = checks
    bad = forbidden()
    if bad:
        print(f"lpbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
