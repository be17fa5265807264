"""Experiment harness (counterpart of ``linkpred_tpu/bench/harness.py``):
remove random edges, predict them back, measure precision and recall.

The reference driver's semantics:

* ``run_batches`` sweeps the batch fractions ``deletions_begin →
  deletions_end`` with a multiplicative step, repeating each fraction
  ``repeat_batch`` times over ``batch_length``-step sequences.  Per batch it
  samples deletions and insertions, tidies and applies them, then calls the
  per-batch callback with the updated graph.
* ``run_experiment`` runs every (metric × min_degree1) combination per
  batch, with ``max_edges`` = the number of removed undirected edges, and
  emits one reference-grammar result line per run.
* precision = |common| / max(|predicted directed|, 1); recall = |common| /
  max(|removed directed|, 1).

The sweep takes an explicit seed, so runs are reproducible, and draws from
its generator exactly as the JAX package's harness does: the same seed
removes the same edges in both.  Scoring runs on ``ExperimentConfig.device``
(the card unless the caller names the CPU).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Optional, Sequence

import numpy as np

from ..graph import CSRGraph
from ..ops.batch import (
    apply_batch,
    generate_edge_deletions,
    generate_edge_insertions,
    tidy_batch,
)
from ..predict.api import (
    PlanCache, PredictOptions, predict_links, predict_links_multi)
from ..predict.metrics import METRICS, TECHNIQUE_NAMES, get_metric
from ..utils.device import device_count
from ..utils.logging import result_line

__all__ = [
    "ALL_DEGREES",
    "ExperimentConfig",
    "directed_pairs",
    "common_pair_count",
    "run_batches",
    "run_experiment",
]

# The reference's MINDEGREE1 sweep.
ALL_DEGREES = (0, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


@dataclasses.dataclass
class ExperimentConfig:
    """Sweep configuration; the defaults are the reference driver's."""

    repeat_batch: int = 5         # REPEAT_BATCH
    repeat_method: int = 5        # REPEAT_METHOD
    batch_length: int = 1         # BATCH_LENGTH
    deletions_begin: float = 1e-4  # BATCH_DELETIONS_BEGIN
    deletions_end: float = 1e-1    # BATCH_DELETIONS_END
    deletions_step: float = 10.0   # BATCH_DELETIONS_STEP (*=)
    insertions_begin: float = 0.0
    insertions_end: float = 0.0
    insertions_step: float = 10.0
    metrics: Sequence[str] = tuple(METRICS)
    degrees: Sequence[int] = ALL_DEGREES
    num_threads: int = 0          # label only; 0 => devices of `device`'s type
    seed: Optional[int] = 0       # None => OS entropy (reference behavior)
    cap: Optional[int] = 1 << 20  # tile slot budget; None = adaptive
    min_score: float = 0.0
    fused_metrics: bool = True    # one expansion+sort pass scores all metrics
    jsonl: bool = False           # emit JSON-lines instead of the printf grammar
    device: str = "cuda"          # where scoring runs; "cpu" must be asked for


def directed_pairs(pairs: np.ndarray, undirected: bool = False) -> np.ndarray:
    """Expand undirected (u, v) rows into directed rows, sorted and
    deduplicated."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 2)
    if undirected and pairs.shape[0]:
        pairs = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
    if pairs.shape[0] == 0:
        return pairs
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    pairs = pairs[order]
    keep = np.empty(pairs.shape[0], dtype=bool)
    keep[0] = True
    keep[1:] = (pairs[1:] != pairs[:-1]).any(axis=1)
    return pairs[keep]


def common_pair_count(a: np.ndarray, b: np.ndarray) -> int:
    """|a ∩ b| for directed pair arrays."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return 0
    hi = int(max(a[:, 1].max(), b[:, 1].max())) + 1
    ka = a[:, 0] * hi + a[:, 1]
    kb = b[:, 0] * hi + b[:, 1]
    return int(np.intersect1d(ka, kb, assume_unique=False).size)


def run_batches(
    g: CSRGraph,
    rng: np.random.Generator,
    fn: Callable,
    config: Optional[ExperimentConfig] = None,
) -> None:
    """Sweep batch updates over the fraction schedule and invoke
    ``fn(y, deletions_fraction, deletions, insertions_fraction, insertions,
    sequence, epoch)`` per batch."""
    cfg = config or ExperimentConfig()
    d = cfg.deletions_begin
    i = cfg.insertions_begin
    epoch = 0
    while True:
        for _ in range(cfg.repeat_batch):
            y = g
            for sequence in range(cfg.batch_length):
                deletions = generate_edge_deletions(
                    rng, y, int(d * g.size / 2), undirected=True)
                insertions = generate_edge_insertions(
                    rng, y, int(i * g.size / 2), undirected=True)
                deletions, insertions = tidy_batch(deletions, insertions, y)
                y = apply_batch(y, deletions, insertions)
                fn(y, d, deletions, i, insertions, sequence, epoch)
        if d >= cfg.deletions_end and i >= cfg.insertions_end:
            break
        d = min(d * cfg.deletions_step, cfg.deletions_end)
        i = min(i * cfg.insertions_step, cfg.insertions_end)
        epoch += 1


def run_experiment(
    g: CSRGraph,
    config: Optional[ExperimentConfig] = None,
    emit: Callable[[str], None] = print,
) -> list[dict]:
    """Full sweep: per batch, per metric, per hub threshold, predict the
    removed edges back on ``config.device`` and log precision/recall in the
    reference grammar.  Returns the result rows as dicts as well."""
    cfg = config or ExperimentConfig()
    cfg = dataclasses.replace(
        cfg, metrics=tuple(get_metric(m).name for m in cfg.metrics))
    # raises here, before any batch work, when the card is asked for and
    # missing
    devices = device_count(cfg.device)
    num_threads = cfg.num_threads or devices
    rng = np.random.default_rng(cfg.seed)
    plan_cache = PlanCache()
    rows: list[dict] = []

    def per_batch(y, df, deletions, inf, insertions, sequence, epoch):
        if deletions.shape[0] == 0:
            return
        # tidy_batch returns the deletions directed (both orientations),
        # sorted and unique: the reference's `deletions0`
        deletions0 = deletions
        max_edges = deletions0.shape[0] // 2
        options = PredictOptions(repeat=cfg.repeat_method,
                                 max_edges=max_edges, min_score=cfg.min_score)
        for deg in cfg.degrees:
            if cfg.fused_metrics:
                # One expansion+sort pass scores every metric (the reference
                # scans once per metric); reported times are amortized per
                # technique.
                multi = predict_links_multi(
                    y, cfg.metrics, min_degree1=deg, options=options,
                    cap=cfg.cap, plan_cache=plan_cache, device=cfg.device)
            else:
                multi = {
                    metric: predict_links(
                        y, metric=metric, min_degree1=deg, options=options,
                        cap=cfg.cap, plan_cache=plan_cache,
                        device=cfg.device)
                    for metric in cfg.metrics
                }
            for metric in cfg.metrics:
                res = multi[metric]
                predicted = np.stack([res.u, res.v], axis=1).astype(np.int64)
                insertions1 = directed_pairs(predicted, undirected=True)
                common = common_pair_count(deletions0, insertions1)
                precision = common / max(insertions1.shape[0], 1)
                recall = common / max(deletions0.shape[0], 1)
                # A fused multi-metric pass divides ONE shared expansion+sort
                # evenly across the metrics, so its per-row times are not
                # comparable to the reference's per-technique scans: such
                # rows are tagged `...CudaFused<deg>`.  `--unfused`, or a
                # single metric, where nothing is amortized, keeps the plain
                # `...Cuda<deg>` label.  The tag names the implementation,
                # as the reference's `Omp` names its OpenMP one.
                amortized = cfg.fused_metrics and len(cfg.metrics) > 1
                tag = "CudaFused" if amortized else "Cuda"
                technique = f"{TECHNIQUE_NAMES[metric]}{tag}{deg}"
                # The reference prints the deletion fraction in the "+" slot
                # and 0.0 in the "-" slot; kept verbatim for process.js's
                # columns.
                row = dict(
                    batch_deletions_fraction=0.0,
                    batch_insertions_fraction=df,
                    num_threads=num_threads,
                    total_time=res.time_ms,
                    scoring_time=res.scoring_ms,
                    precision=precision,
                    recall=recall,
                    technique=technique,
                )
                if cfg.jsonl:
                    emit(json.dumps(row))
                else:
                    emit(result_line(0.0, df, num_threads, res.time_ms,
                                     res.scoring_ms, precision, recall,
                                     technique))
                rows.append(row)
        # drops the batch's plans, their device streams and the device CSR
        plan_cache.clear()

    run_batches(g, rng, per_batch, cfg)
    return rows
