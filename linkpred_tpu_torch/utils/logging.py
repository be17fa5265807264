"""Reference-grammar logging (counterpart of ``linkpred_tpu/utils/logging.py``).

Timestamp-prefixed lines and one result line per technique run, in the
exact printf grammar of the reference driver, so its ``process.js`` and
:mod:`linkpred_tpu_torch.bench.process` parse the port's logs unchanged.
"""
from __future__ import annotations

import datetime
import sys

__all__ = ["log", "result_line", "graph_line"]


def log(msg: str = "", end: str = "\n", file=None) -> None:
    """``LOG(...)``-style timestamped print: ``YYYY-MM-DD HH:MM:SS <msg>``."""
    ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
    print(f"{ts} {msg}", end=end, file=file or sys.stdout, flush=True)


def graph_line(n: int, m: int, directed: bool = True) -> str:
    """Graph echo line: ``order: N size: M [directed] {}``."""
    kind = "directed" if directed else "undirected"
    return f"order: {n} size: {m} [{kind}] {{}}"


def result_line(
    deletions_fraction: float,
    insertions_fraction: float,
    num_threads: int,
    time_ms: float,
    scoring_ms: float,
    precision: float,
    recall: float,
    technique: str,
) -> str:
    """The reference's result printf:
    ``{-%.3e/+%.3e batchf, %03d threads} -> {%09.1fms, %09.1fms scoring,
    %.3e precision, %.3e recall} %s``"""
    return (
        f"{{-{deletions_fraction:.3e}/+{insertions_fraction:.3e} batchf, "
        f"{num_threads:03d} threads}} -> "
        f"{{{time_ms:09.1f}ms, {scoring_ms:09.1f}ms scoring, "
        f"{precision:.3e} precision, {recall:.3e} recall}} {technique}"
    )
