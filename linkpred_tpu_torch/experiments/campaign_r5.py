"""The serial measurement campaign: the scale table, the pack's decision
at two scales, and the radix probe, each in a fresh process.

Counterpart of ``experiments/campaign_r5.py``.  One process at a time:

* ``s19`` ... ``s23``: ``python -m linkpred_tpu_torch.bench.run`` at
  ``BENCH_SCALE`` 19-23 (``--scales``), ``BENCH_SAMPLES=3``;
* ``diag_pack_s19``, ``diag_pack_s21``: ``python -m
  linkpred_tpu_torch.experiments.diag_pack`` at 19 and 21
  (``--diag-scales``), reading the graphs the bench rows cached;
* ``radix_probe``: ``python -m linkpred_tpu_torch.experiments.radix_probe``
  (the card only).

Each step appends one JSON row to ``OUT/results.jsonl`` (its command's
environment, wall seconds, exit code, and the bench row or the tail of its
output) and writes its output to ``OUT/logs/STEP.log``; ``OUT`` defaults to
``experiments/cuda``.  A step that fails (a bench row the memory check
refuses, C3, or a probe without a card) is written with its exit code and
the reason its process gave, never dropped.  The JAX campaign's on/off A/Bs
have no switch here, and a row says so for each: ``LINKPRED_FUSED_TAIL``
is ``fused_tail_enabled``, not ported (a switch to a plain tail would hide
K1), and ``LINKPRED_SEL_PACK``'s question is ``ab_pack_sel``'s, the pack
arm against the sort arm.

    python -m linkpred_tpu_torch.experiments.campaign_r5 [STEP ...]
        [--out experiments/cuda] [--scales 19,20,21,22,23]
        [--diag-scales 19,21] [--timeout 1800] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from ..utils.device import resolve_device
from ._probe import card_line

__all__ = ["NOT_RUN", "steps", "run_step", "main"]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The JAX campaign's on/off steps, each with why the port has no switch.
_FUSED = ("LINKPRED_FUSED_TAIL is fused_tail_enabled, not ported: a switch "
          "to a plain tail would hide K1")
_PACK = ("LINKPRED_SEL_PACK's question, the pack arm against the sort arm, "
         "is ab_pack_sel's")
NOT_RUN = {"s19_fused0": _FUSED, "s19_pack0": _PACK, "s21_fused0": _FUSED,
           "s21_pack0": _PACK, "s22_pack0": _PACK, "s23_pack0": _PACK}


def steps(scales, diag_scales, device) -> list:
    """``[(name, argv, env)]``: the bench rows, the pack's decisions, the
    radix probe."""
    py = sys.executable
    out = [(f"s{s}", [py, "-m", "linkpred_tpu_torch.bench.run"],
            {"BENCH_SCALE": str(s), "BENCH_SAMPLES": "3",
             "BENCH_DEVICE": device}) for s in scales]
    out += [(f"diag_pack_s{s}",
             [py, "-m", "linkpred_tpu_torch.experiments.diag_pack",
              "--bench-scale", str(s), "--device", device], {})
            for s in diag_scales]
    out.append(("radix_probe",
                [py, "-m", "linkpred_tpu_torch.experiments.radix_probe"],
                {}))
    return out


def _reason(stderr: str) -> str:
    lines = [line for line in stderr.strip().splitlines() if line.strip()]
    return lines[-1] if lines else ""


def run_step(name: str, argv, env_over: dict, out: str,
             timeout: float) -> dict:
    """Run one step in a fresh process from the repository's root; append
    its row to ``out/results.jsonl``, its output to ``out/logs``."""
    env = dict(os.environ, **env_over)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.time()
    try:
        r = subprocess.run(argv, env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=timeout)
        rc, stdout, stderr = r.returncode, r.stdout, r.stderr
    except subprocess.TimeoutExpired as e:
        rc = "timeout"
        stdout = e.stdout.decode() if isinstance(e.stdout, bytes) \
            else (e.stdout or "")
        stderr = f"timed out after {timeout} s"
    wall = time.time() - t0
    os.makedirs(os.path.join(out, "logs"), exist_ok=True)
    with open(os.path.join(out, "logs", f"{name}.log"), "w") as f:
        f.write(f"# cmd: {' '.join(argv[1:])} env: {env_over} rc={rc} "
                f"wall={wall:.1f}s\n")
        f.write(stdout)
        if rc != 0:
            f.write("\n# --- stderr ---\n" + stderr[-3000:])
    row = {"step": name, "env": env_over, "wall_s": round(wall, 1),
           "rc": rc}
    last = (stdout.strip().splitlines() or [""])[-1]
    if rc == 0 and name.startswith("s") and name[1:].isdigit():
        row["bench"] = json.loads(last)
    elif rc == 0:
        row["stdout_tail"] = stdout.strip()[-400:]
    else:
        row["reason"] = _reason(stderr)
        row["refused_by_memory_check"] = "MemoryError" in stderr
    with open(os.path.join(out, "results.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> list:
    """The campaign, or the steps named, on ``--device`` (the card by
    default; raises without one).  Returns its rows, the card's first."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="*", help="steps to run (default all)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "experiments",
                                                  "cuda"))
    ap.add_argument("--scales", default="19,20,21,22,23")
    ap.add_argument("--diag-scales", default="19,21")
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    head = {"step": "card", "card": card_line(device), "device": str(device)}
    rows = [head]
    print(json.dumps(head), flush=True)
    with open(os.path.join(args.out, "results.jsonl"), "a") as f:
        f.write(json.dumps(head) + "\n")
        for name, why in NOT_RUN.items():
            row = {"step": name, "not_run": why}
            f.write(json.dumps(row) + "\n")
            print(json.dumps(row), flush=True)
            rows.append(row)
    want = set(args.steps)
    for name, cmd, env in steps([int(s) for s in args.scales.split(",")],
                                [int(s) for s in
                                 args.diag_scales.split(",")],
                                device.type):
        if not want or name in want:
            rows.append(run_step(name, cmd, env, args.out, args.timeout))
    return rows


if __name__ == "__main__":
    main()
