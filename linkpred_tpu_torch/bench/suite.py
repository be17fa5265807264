"""The reference's SuiteSparse experiment protocol as a runnable manifest
(counterpart of ``linkpred_tpu/bench/suite.py``).

The reference's batch runner hard-codes 17 SuiteSparse graphs with
per-graph symmetric flags (its ``main.sh:46-62``, invocation
``./a.out <path> <symmetric> <weighted>``) and publishes average F1
brackets for the full sweep (its ``README.md:21``).  This module encodes
both, so a host holding the graphs reproduces the reference run with one
command:

    python -m linkpred_tpu_torch.bench.sweep --suite reference --data-dir ~/Data

Graphs missing from ``--data-dir`` are reported with their SuiteSparse
download URLs; nothing is fetched.  After a sweep, :func:`f1_report`
compares measured F1 against the published brackets with tie tolerance.
"""
from __future__ import annotations

import dataclasses
import os

__all__ = ["ReferenceGraph", "REFERENCE_SUITE", "HEADLINE_GRAPH",
           "PUBLISHED_F1", "resolve_suite", "missing_report", "f1_report"]


@dataclasses.dataclass(frozen=True)
class ReferenceGraph:
    """One row of the reference's run list (``main.sh:46-62``)."""

    name: str           # SuiteSparse matrix name (file stem)
    group: str          # SuiteSparse group (download URL component)
    symmetric: bool     # the script's 2nd positional arg (1 = already symmetric)
    weighted: bool = False  # 3rd positional arg (always 0 in the reference run)

    @property
    def url(self) -> str:
        """MatrixMarket tarball URL on the SuiteSparse collection."""
        return f"https://suitesparse-collection-website.herokuapp.com/MM/{self.group}/{self.name}.tar.gz"

    def path(self, data_dir: str) -> str:
        return os.path.join(data_dir, f"{self.name}.mtx")


# The 17 graphs, in the reference's run order, with ITS symmetric flags
# (``main.sh:46-62``): web/soc/indochina rows pass 0 (the MTX is a directed
# general matrix; the driver symmetrizes), coAuthors/coPapers/_osm rows
# pass 1 (the MTX is already a symmetric matrix).
REFERENCE_SUITE: tuple = (
    ReferenceGraph("web-Stanford", "SNAP", False),
    ReferenceGraph("web-BerkStan", "SNAP", False),
    ReferenceGraph("web-Google", "SNAP", False),
    ReferenceGraph("web-NotreDame", "SNAP", False),
    ReferenceGraph("soc-Slashdot0811", "SNAP", False),
    ReferenceGraph("soc-Slashdot0902", "SNAP", False),
    ReferenceGraph("soc-Epinions1", "SNAP", False),
    ReferenceGraph("coAuthorsDBLP", "DIMACS10", True),
    ReferenceGraph("coAuthorsCiteseer", "DIMACS10", True),
    ReferenceGraph("soc-LiveJournal1", "SNAP", False),
    ReferenceGraph("coPapersCiteseer", "DIMACS10", True),
    ReferenceGraph("coPapersDBLP", "DIMACS10", True),
    ReferenceGraph("indochina-2004", "LAW", False),
    ReferenceGraph("italy_osm", "DIMACS10", True),
    ReferenceGraph("great-britain_osm", "DIMACS10", True),
    ReferenceGraph("germany_osm", "DIMACS10", True),
    ReferenceGraph("asia_osm", "DIMACS10", True),
)

# The headline-rate graph (38.1M edges/s at 0.1|E| removed, the reference's
# ``README.md:17``) is NOT in main.sh's 17-graph list; it is benchmarked
# separately in the paper.  ``--suite reference-headline`` appends it.
HEADLINE_GRAPH = ReferenceGraph("sk-2005", "LAW", False)

# Published all-suite AVERAGE F1 (the reference's ``README.md:21``), keyed by
# (approach, deletion fraction).  These are averages over the sweep's graphs
# and similarity measures as plotted in the reference's sheets — per-graph
# figures are not published, so the report compares suite-level averages.
PUBLISHED_F1 = {
    ("ihub", 1e-2): 1.8e-2,
    ("ihub", 1e-1): 1.1e-1,
    ("lhub", 1e-2): 3.2e-2,
    ("lhub", 1e-1): 9.8e-2,
}


def resolve_suite(data_dir: str, include_headline: bool = False):
    """Split the manifest into (present, missing) against ``data_dir``.

    ``present`` is a list of ``(path, ReferenceGraph)`` in run order."""
    rows = list(REFERENCE_SUITE) + ([HEADLINE_GRAPH] if include_headline else [])
    present, missing = [], []
    for g in rows:
        p = g.path(data_dir)
        (present if os.path.exists(p) else missing).append((p, g))
    return present, missing


def missing_report(missing) -> str:
    """Human-readable download manifest for absent graphs."""
    lines = ["missing reference-suite graphs (download + extract the .mtx "
             "into --data-dir):"]
    for path, g in missing:
        lines.append(f"  {g.name:24s} symmetric={int(g.symmetric)}  {g.url}")
    return "\n".join(lines)


def f1_score(precision: float, recall: float) -> float:
    """F1 from the harness's precision/recall row (the reference logs P/R
    and computes F1 in its postprocessing sheets)."""
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def f1_report(rows, rel_tolerance: float = 0.5) -> dict:
    """Compare a sweep's measured F1 against the published suite averages.

    ``rows``: iterables of dicts with keys ``technique``,
    ``batch_insertions_fraction``, ``precision``, ``recall`` (the shape
    ``bench.process.read_log`` returns per graph).  A reference grammar
    quirk kept for byte parity: the reference logs the swept fraction in the
    "+insertions" slot and a literal 0.0 in "-deletions" (removed edges are
    the links to re-predict, i.e. the "insertions"), so the fraction lives
    in ``batch_insertions_fraction``.  IHub rows are techniques ending in
    ``0`` (MINDEGREE1 = 0), whatever the implementation's tag before it
    (``...Cuda0``, ``...CudaFused0``); LHub aggregates every nonzero
    threshold, matching the reference's best-measure averaging loosely —
    hence the wide default ``rel_tolerance`` (the published numbers average
    a different graph population; this report flags ORDER-OF-MAGNITUDE
    disagreement, not noise).

    Returns ``{(approach, fraction): {"measured": .., "published": ..,
    "ok": bool}}`` for the fractions with published bounds."""
    from collections import defaultdict

    acc = defaultdict(list)
    for row in rows:
        frac = float(row["batch_insertions_fraction"])
        tech = str(row["technique"])
        deg = ""
        while tech and tech[-1].isdigit():
            deg = tech[-1] + deg
            tech = tech[:-1]
        approach = "ihub" if deg == "0" else "lhub"
        acc[(approach, frac)].append(
            f1_score(float(row["precision"]), float(row["recall"])))

    out = {}
    for key, published in PUBLISHED_F1.items():
        approach, frac = key
        # tolerate float-formatted fractions (1e-2 vs 0.01)
        vals = [v for (a, f), fs in acc.items() if a == approach
                and abs(f - frac) < frac * 1e-6 for v in fs]
        if not vals:
            continue
        measured = sum(vals) / len(vals)
        out[key] = {
            "measured": measured,
            "published": published,
            "ok": abs(measured - published) <= rel_tolerance * published,
        }
    return out
