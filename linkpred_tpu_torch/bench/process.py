"""Log → CSV post-processor (counterpart of ``linkpred_tpu/bench/process.py``).

Does what the reference's ``process.js`` does: parses experiment logs (the
port's, the JAX package's or the reference's; the grammar is one) into
per-run rows and writes CSV, one file or one file per graph, byte for byte
as ``process.js`` writes it.

    python -m linkpred_tpu_torch.bench.process csv <log> <out.csv | out_dir>
"""
from __future__ import annotations

import os
import re
import sys
from typing import Optional

__all__ = ["read_log", "write_csv", "process_csv", "main"]

# process.js's line grammars; the timestamp prefix is stripped first.
R_TIMESTAMP = re.compile(r"^\d+-\d+-\d+ \d+:\d+:\d+ ")
R_OMP_THREADS = re.compile(r"^OMP_NUM_THREADS=(\d+)")
R_GRAPH = re.compile(r"^Loading graph .*/(.*?)\.mtx \.\.\.")
R_ORDER = re.compile(r"^order: (\d+) size: (\d+) (?:\[\w+\] )?\{\}")
R_PREDICT = re.compile(
    r"^\{-(.+?)/\+(.+?) batchf, (.+?) threads\} -> "
    r"\{(.+?)ms, (.+?) scoring, (.+?) precision, (.+?) recall\} (.+)")


def _num(s: str) -> float:
    """parseFloat semantics: ignore a trailing non-numeric suffix (e.g. 'ms')."""
    m = re.match(r"^\s*[-+]?(\d+\.?\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?)", s)
    return float(m.group(0)) if m else float("nan")


def read_log(path: str) -> dict[str, list[dict]]:
    """Parse a log file into {graph_name: [row, ...]}."""
    data: dict[str, list[dict]] = {}
    state: dict = {}
    with open(path, "r") as f:
        for ln in f:
            ln = R_TIMESTAMP.sub("", ln.rstrip("\n"))
            if m := R_OMP_THREADS.match(ln):
                state["omp_num_threads"] = _num(m.group(1))
            elif m := R_GRAPH.match(ln):
                graph = m.group(1)
                data.setdefault(graph, [])
                state["graph"] = graph
            elif m := R_ORDER.match(ln):
                state["order"] = _num(m.group(1))
                state["size"] = _num(m.group(2))
            elif m := R_PREDICT.match(ln):
                row = dict(state)
                row.update(
                    batch_deletions_fraction=_num(m.group(1)),
                    batch_insertions_fraction=_num(m.group(2)),
                    num_threads=_num(m.group(3)),
                    total_time=_num(m.group(4)),
                    scoring_time=_num(m.group(5)),
                    precision=_num(m.group(6)),
                    recall=_num(m.group(7)),
                    technique=m.group(8),
                )
                data.setdefault(state.get("graph", ""), []).append(row)
    return data


def _js_repr(v) -> str:
    """JS ``${v}`` stringification (ECMA-262 Number::toString) for parity
    with process.js's template-literal CSV cells: integer-valued floats print
    bare ("4", not "4.0"), decimal notation spans [1e-6, 1e21), exponents
    drop zero padding ("1.5e-7", not "1.5e-07")."""
    if not isinstance(v, float):
        return str(v)
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "Infinity" if v > 0 else "-Infinity"
    if v.is_integer() and abs(v) < 1e21:
        return str(int(v))
    r = repr(v)  # shortest round-trip digits (same contract as JS)
    if "e" not in r:
        return r
    mant, exp = r.split("e")
    e = int(exp)
    if -6 <= e <= 20:
        # JS prints this range positionally; expand preserving digits
        from decimal import Decimal

        s = format(Decimal(r), "f")
        return s.rstrip("0").rstrip(".") if "." in s else s
    mant = mant.rstrip("0").rstrip(".") if "." in mant else mant
    return f"{mant}e{'+' if e >= 0 else '-'}{abs(e)}"


def write_csv(path: str, rows: list[dict]) -> None:
    """All-quoted cells under an unquoted header, columns in the first
    row's order; cells stringify by JS number rules, as process.js writes
    them."""
    if not rows:
        return
    cols = list(rows[0])
    with open(path, "w", newline="") as f:
        f.write(",".join(cols) + "\n")
        for row in rows:
            f.write(",".join(f'"{_js_repr(v)}"' for v in row.values()) + "\n")


def process_csv(data: dict[str, list[dict]]) -> list[dict]:
    return [row for rows in data.values() for row in rows]


def main(argv: Optional[list[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) != 3:
        print("usage: python -m linkpred_tpu_torch.bench.process csv <log> <out>",
              file=sys.stderr)
        return 2
    cmd, log_path, out = argv
    data = read_log(log_path)
    if os.path.splitext(out)[1] == "":
        cmd += "-dir"
    if cmd == "csv":
        write_csv(out, process_csv(data))
    elif cmd == "csv-dir":
        os.makedirs(out, exist_ok=True)
        for graph, rows in data.items():
            write_csv(os.path.join(out, f"{graph}.csv"), rows)
    else:
        print(f'error: "{cmd}"?', file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
