"""Public link-prediction API (counterpart of ``linkpred_tpu/predict/api.py``).

Same options, results and exact-k rule as the reference; every call names
the ``device`` it scores on.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..graph import CSRGraph
from ..utils.timing import measure_duration
from .metrics import get_metric
from .plan import TilePlan, build_plan
from .scoring import score_tiles

__all__ = ["PredictOptions", "PredictResult", "predict_links",
           "predict_links_multi", "top_per_source", "PlanCache"]

_DEFAULT_MAX_EDGES = 1 << 20


@dataclasses.dataclass
class PredictOptions:
    """``max_edges=None`` maps the reference's unbounded default to 2**20."""
    repeat: int = 1
    max_edges: Optional[int] = None
    min_score: float = 0.0


@dataclasses.dataclass
class PredictResult:
    u: np.ndarray          # int32[E] predicted source
    v: np.ndarray          # int32[E] predicted target
    score: np.ndarray      # float32[E], descending
    time_ms: float         # scoring + ordering on the host
    scoring_ms: float      # the device pass only
    transfer_ms: float = 0.0  # device->host copy of the top k, not in time_ms

    @property
    def edges(self):
        """[(u, v, score)] list view."""
        return list(zip(self.u.tolist(), self.v.tolist(), self.score.tolist()))

    def __len__(self) -> int:
        return int(self.u.shape[0])


class PlanCache:
    """Memoizes tile plans per (graph identity, min_degree1, cap, sources,
    device).  Each entry pins the graph's arrays so an ``id()`` is never
    reused while its entry lives."""

    def __init__(self) -> None:
        self._cache: dict = {}

    def get(self, g: CSRGraph, min_degree1: int, cap: Optional[int],
            sources=None, *, device) -> TilePlan:
        skey = None if sources is None else hash(np.asarray(sources).tobytes())
        key = (id(g.offsets), id(g.indices), g.n, g.m, min_degree1, cap, skey,
               str(torch.device(device)))
        hit = self._cache.get(key)
        if hit is None:
            hit = (g.offsets, g.indices, build_plan(
                g, min_degree1, cap, sources=sources, device=device))
            self._cache[key] = hit
        return hit[2]

    def clear(self) -> None:
        self._cache.clear()


def _sub_plans(p: TilePlan):
    """Sub-plan passes in scoring order: the side stream and the hub
    sub-plan (which may carry its own side stream)."""
    out = []
    for q in (p.side_plan, p.huge_plan):
        if q is not None:
            out.append(q)
            out.extend(_sub_plans(q))
    return out


def predict_links_multi(
    g: CSRGraph,
    metrics,
    min_degree1: int = 4,
    max_factor2: int = 0,
    options: Optional[PredictOptions] = None,
    cap: Optional[int] = None,
    plan: Optional[TilePlan] = None,
    plan_cache: Optional[PlanCache] = None,
    mesh=None,
    sources=None,
    key64: Optional[bool] = None,
    *,
    device,
) -> dict:
    """Predict links for several metrics in one pass on ``device``: the
    expansion, sort and run reduction are shared and only the formulas and
    the selections fan out.  Returns ``{metric_name: PredictResult}``;
    ``scoring_ms``/``time_ms`` are the pass time split evenly across the
    metrics.

    ``min_degree1`` = 0 is IHub, > 0 LHub.  ``sources``: serving mode (score
    only pairs whose source is in the subset, directed candidates).
    ``mesh`` and ``key64=False`` are not ported and raise."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= is not ported yet (ROADMAP A10, torch.distributed)")
    if key64 is False:
        raise NotImplementedError(
            "the port keeps one engine, the int64 key; key64=False (the "
            "u32 engine) is not ported (ROADMAP rules)")
    device = torch.device(device)
    specs = tuple(get_metric(m) for m in metrics)
    names = tuple(s.name for s in specs)
    o = options or PredictOptions()
    max_edges = _DEFAULT_MAX_EDGES if o.max_edges is None else int(o.max_edges)
    if max_edges <= 0 or not specs:
        empty = np.empty(0)
        return {name: PredictResult(
            empty.astype(np.int32), empty.astype(np.int32),
            empty.astype(np.float32), 0.0, 0.0) for name in names}

    if plan is None:
        if plan_cache is not None:
            plan = plan_cache.get(g, min_degree1, cap, sources=sources,
                                  device=device)
        else:
            plan = build_plan(g, min_degree1, cap, sources=sources,
                              device=device)
    passes = [plan, *_sub_plans(plan)]
    for p in passes:
        if not p.packed:
            raise NotImplementedError(
                "edge-stream plans (packed=False) are not ported yet "
                "(ROADMAP A8)")
        if p.host_src.size:
            raise NotImplementedError(
                "mega-hub sources past HUGE_DEVICE_MAX (plan.host_src) need "
                "the host scorer, not ported yet (ROADMAP A13)")

    # huge_slots covers the hub sub-plan; the top-level side stream adds
    all_slots = (plan.total_slots + plan.huge_slots
                 + (plan.side_plan.total_slots if plan.side_plan else 0))
    # exact k, rounded to a 1024 multiple
    k = min(-(-min(max_edges, max(all_slots, 1)) // 1024) * 1024,
            max(all_slots, 1))
    weighted = any(s.needs_weight for s in specs)
    streams = [p.device_stream(device, weighted) for p in passes]

    def run_scoring():
        return [score_tiles(s, p.tile_start, o.min_score, metric_names=names,
                            cap=p.cap, k=k, n=g.n, maxf2=max_factor2,
                            w_bits=p.w_bits, deg16=p.deg16, device=device)
                for p, s in zip(passes, streams)]

    ts, tops = measure_duration(run_scoring, device, repeat=o.repeat)

    results = {}
    for i, name in enumerate(names):
        t0 = time.perf_counter()
        parts = [(t.scores[i].cpu().numpy(), t.u[i].cpu().numpy(),
                  t.v[i].cpu().numpy()) for t in tops]
        t1 = time.perf_counter()
        scores, us, vs = (np.concatenate(x) for x in zip(*parts))
        valid = np.isfinite(scores)
        scores, us, vs = scores[valid], us[valid], vs[valid]
        order = np.argsort(-scores, kind="stable")[:max_edges]
        t2 = time.perf_counter()
        results[name] = PredictResult(
            u=us[order].astype(np.int32), v=vs[order].astype(np.int32),
            score=scores[order].astype(np.float32),
            time_ms=ts / len(names) + (t2 - t1) * 1e3,
            scoring_ms=ts / len(names),
            transfer_ms=(t1 - t0) * 1e3,
        )
    return results


def predict_links(
    g: CSRGraph,
    metric: str = "common_neighbors",
    min_degree1: int = 4,
    max_factor2: int = 0,
    options: Optional[PredictOptions] = None,
    cap: Optional[int] = None,
    plan: Optional[TilePlan] = None,
    plan_cache: Optional[PlanCache] = None,
    mesh=None,
    sources=None,
    key64: Optional[bool] = None,
    *,
    device,
) -> PredictResult:
    """Predict the top-``max_edges`` unobserved links of an undirected graph
    on ``device``.  ``min_degree1`` = 0 is IHub (scan all intermediates);
    > 0 is LHub (skip intermediates of higher degree).  A single-metric
    :func:`predict_links_multi`."""
    spec = get_metric(metric)
    return predict_links_multi(
        g, (spec.name,), min_degree1=min_degree1, max_factor2=max_factor2,
        options=options, cap=cap, plan=plan, plan_cache=plan_cache, mesh=mesh,
        sources=sources, key64=key64, device=device,
    )[spec.name]


def top_per_source(result: PredictResult, k: int) -> PredictResult:
    """Keep the best ``k`` predictions per source vertex (serving helper)."""
    if len(result) == 0 or k <= 0:
        empty = np.empty(0)
        return PredictResult(empty.astype(np.int32), empty.astype(np.int32),
                             empty.astype(np.float32),
                             result.time_ms, result.scoring_ms,
                             result.transfer_ms)
    # result.score is descending; a stable sort by u keeps per-source order
    order = np.argsort(result.u, kind="stable")
    u, v, s = result.u[order], result.v[order], result.score[order]
    is_first = np.empty(u.shape[0], dtype=bool)
    is_first[0] = True
    is_first[1:] = u[1:] != u[:-1]
    group_start = np.maximum.accumulate(
        np.where(is_first, np.arange(u.shape[0]), 0))
    rank = np.arange(u.shape[0]) - group_start
    keep = rank < k
    back = np.argsort(-s[keep], kind="stable")
    return PredictResult(u=u[keep][back], v=v[keep][back], score=s[keep][back],
                         time_ms=result.time_ms, scoring_ms=result.scoring_ms,
                         transfer_ms=result.transfer_ms)
