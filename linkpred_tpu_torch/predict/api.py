"""Public link-prediction API (counterpart of ``linkpred_tpu/predict/api.py``).

Same options, results and exact-k rule as the reference.  Every entry point
scores on the CUDA card unless the caller passes ``device="cpu"`` (which
runs the kernels' plain versions); without a card, a call that names no
device raises.  Under a ``mesh`` (``parallel.mesh``) each rank scores its
block of tiles on ``mesh.device`` and every rank returns the same result.

Before anything is uploaded, :func:`device_bytes` prices what the pass will
allocate on the device and the call raises ``MemoryError`` when that
exceeds the device's free memory.  The plan itself is the reference's,
budgets and all.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..graph import CSRGraph
from ..utils.device import free_bytes, resolve_device
from ..utils.timing import measure_duration
from .metrics import get_metric
from .plan import TilePlan, build_plan
from .scoring import _segments, score_huge_sources_host_multi, score_tiles

__all__ = ["PredictOptions", "PredictResult", "predict_links",
           "predict_links_multi", "top_per_source", "PlanCache",
           "device_bytes"]

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


def _upload_csr(g: CSRGraph, device):
    """``(indices, degrees)`` of ``g`` as tensors on ``device``: what the
    edge stream gathers from."""
    h = g.host()
    return (torch.as_tensor(h.indices, device=device),
            torch.as_tensor(h.degrees, device=device))


class PlanCache:
    """Memoizes tile plans per (graph identity, min_degree1, cap, sources,
    device), and the device CSR per (graph identity, device).  Each entry
    pins the graph's arrays so an ``id()`` is never reused while its entry
    lives."""

    def __init__(self) -> None:
        self._cache: dict = {}

    def _entry(self, key, g: CSRGraph, build):
        hit = self._cache.get(key)
        if hit is None:
            hit = (g.offsets, g.indices, build())
            self._cache[key] = hit
        return hit[2]

    def get(self, g: CSRGraph, min_degree1: int, cap: Optional[int],
            sources=None, *, device="cuda") -> TilePlan:
        device = resolve_device(device)
        skey = None if sources is None else hash(np.asarray(sources).tobytes())
        key = (id(g.offsets), id(g.indices), g.n, g.m, min_degree1, cap, skey,
               str(device))
        return self._entry(key, g, lambda: build_plan(
            g, min_degree1, cap, sources=sources, device=device))

    def _csr_key(self, g: CSRGraph, device):
        return ("csr", id(g.offsets), id(g.indices), g.n, g.m, str(device))

    def device_graph(self, g: CSRGraph, device="cuda"):
        """``(indices, degrees)`` of ``g`` on ``device``, uploaded once per
        graph and device (only edge-stream passes read them)."""
        device = resolve_device(device)
        return self._entry(self._csr_key(g, device), g,
                           lambda: _upload_csr(g, device))

    def has_device_graph(self, g: CSRGraph, device) -> bool:
        return self._csr_key(g, torch.device(device)) in self._cache

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


def _exact_k(plan: TilePlan, max_edges: int) -> int:
    """The k every pass selects: ``max_edges`` rounded up to a 1024
    multiple, capped by the plan's slots (the reference's exact-k rule)."""
    # huge_slots covers the hub sub-plan; the top-level side stream adds
    all_slots = max(plan.total_slots + plan.huge_slots
                    + (plan.side_plan.total_slots if plan.side_plan else 0),
                    1)
    return min(-(-min(max_edges, all_slots) // 1024) * 1024, all_slots)


def _pass_kwargs(p: TilePlan) -> dict:
    """What one pass ``p`` gives :func:`scoring.tile_scorer` besides the
    stream, the metrics and the device CSR."""
    # w_bits 0 (ids too wide for the w key) takes the sentinel branch
    return dict(cap=p.cap, w_bits=p.w_bits if p.keyed else 0, deg16=p.deg16,
                packed=p.packed, upper_only=p.upper_only)


def device_bytes(g: CSRGraph, passes, num_metrics: int, k: int,
                 weighted: bool, device, mesh=None,
                 csr_resident: bool = False) -> dict:
    """What scoring ``passes`` will allocate on ``device`` beyond what is
    already there, in bytes, by item:

    * ``stream``: each pass's stream not yet uploaded (under a ``mesh``,
      this rank's block at its padded width);
    * ``middeg``: the deg(mid) arrays, when a weighted metric is asked for;
    * ``csr``: ``indices`` and ``degrees`` for an edge plan, unless
      ``csr_resident``;
    * ``selection``: the largest selection buffer of one pass, ``lanes x
      (4 M + 8)`` B for one segment of ``scoring._segments``;
    * ``gather``: under a mesh of several ranks, the gathered ``[D, M, k]``
      buffers and their stack;

    and ``total``.  A tile's own temporaries (its sort of ``cap`` lanes) are
    not priced."""
    from ..parallel.mesh import pending_bytes

    need = dict(stream=0, middeg=0, csr=0, selection=0, gather=0)
    for p in passes:
        if mesh is None:
            memo = p._device.get(str(device), {})
            *arrays, middeg = p.host_stream(weighted)
            if "stream" not in memo:
                need["stream"] += sum(a.nbytes for a in arrays)
            if middeg is not None and "middeg" not in memo:
                need["middeg"] += middeg.nbytes
            tiles = p.num_tiles_padded
        else:
            stream, middeg, tiles = pending_bytes(p, mesh, weighted)
            need["stream"] += stream
            need["middeg"] += middeg
        if tiles:
            _, seg = _segments(tiles, p.cap, num_metrics, device)
            need["selection"] = max(need["selection"],
                                    seg * p.cap * (4 * num_metrics + 8))
    if not csr_resident and not all(p.packed for p in passes):
        h = g.host()
        need["csr"] = h.indices.nbytes + h.degrees.nbytes
    if mesh is not None and mesh.size > 1:
        need["gather"] = 2 * mesh.size * 3 * num_metrics * k * 4
    need["total"] = sum(need.values())
    return need


def _check_device_memory(need: dict, device) -> None:
    free = free_bytes(device)
    if need["total"] > free:
        parts = ", ".join(f"{name} {b}" for name, b in need.items()
                          if name != "total")
        raise MemoryError(
            f"predict_links: the pass needs {need['total']} B on {device} "
            f"({parts}) but {free} B are free; nothing was uploaded. Use a "
            "smaller cap, fewer metrics, or a mesh of more devices")


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
    device="cuda",
) -> dict:
    """Predict links for several metrics in one pass on ``device``: the
    expansion, sort and run reduction are shared and only the formulas and
    the selections fan out.  Returns ``{metric_name: PredictResult}``;
    ``scoring_ms``/``time_ms`` are the pass time split evenly across the
    metrics.

    ``min_degree1`` = 0 is IHub, > 0 LHub.  ``sources``: serving mode (score
    only pairs whose source is in the subset, directed candidates).
    Packed and edge-stream plans both run; hub sources past
    ``HUGE_DEVICE_MAX`` (``plan.host_src``) are scored on the host and
    their wall time counts in the pass time.

    ``mesh``: a ``parallel.mesh.Mesh``; the main plan and every sub-plan
    take the sharded pass (each rank uploads only its block and scans its
    tiles, one all-gather merges), scoring runs on ``mesh.device`` in
    place of ``device``, and every rank returns the same result.
    ``key64=False`` is not ported and raises.  A pass whose device bytes
    (:func:`device_bytes`) exceed the free memory raises ``MemoryError``
    before anything is uploaded."""
    if key64 is False:
        raise NotImplementedError(
            "the port keeps one engine, the int64 key; key64=False (the "
            "u32 engine) is not ported (ROADMAP rules)")
    if mesh is not None:
        from ..parallel.mesh import Mesh, score_tiles_sharded, shard_stream

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh (from "
                            f"make_mesh), not {type(mesh).__name__}")
        device = mesh.device
    device = resolve_device(device)
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
    k = _exact_k(plan, max_edges)
    weighted = any(s.needs_weight for s in specs)
    _check_device_memory(device_bytes(
        g, passes, len(names), k, weighted, device, mesh,
        csr_resident=plan_cache is not None
        and plan_cache.has_device_graph(g, device)), device)
    if mesh is None:
        streams = [(p.device_stream(device, weighted), p.tile_start)
                   for p in passes]
    else:
        # each rank uploads only its block; the full stream is never made
        streams = [shard_stream(p, mesh, weighted) for p in passes]
    indices = degrees = None
    if not all(p.packed for p in passes):
        indices, degrees = (plan_cache.device_graph(g, device)
                            if plan_cache is not None
                            else _upload_csr(g, device))

    def run_scoring():
        out = []
        for p, (stream, tile_start) in zip(passes, streams):
            kw = dict(metric_names=names, k=k, n=g.n, maxf2=max_factor2,
                      indices=indices, degrees=degrees, **_pass_kwargs(p))
            out.append(
                score_tiles(stream, tile_start, o.min_score, device=device,
                            **kw) if mesh is None else
                score_tiles_sharded(stream, tile_start, o.min_score,
                                    mesh=mesh, **kw))
        return out

    # Mega-hub sources are scored on the host, once, sharing one expansion
    # across the metrics (on every rank under a mesh); their wall time
    # counts in the pass time, as the reference keeps every source in its
    # timed loop.
    host_rows, host_ms = {}, 0.0
    if plan.host_src.size:
        t0 = time.perf_counter()
        host_rows = score_huge_sources_host_multi(
            g, plan.host_src, specs, min_degree1, max_factor2, o.min_score,
            k=max_edges, upper_only=plan.upper_only)
        host_ms = (time.perf_counter() - t0) * 1e3

    ts, tops = measure_duration(run_scoring, device, repeat=o.repeat)
    ts += host_ms

    results = {}
    for i, name in enumerate(names):
        t0 = time.perf_counter()
        parts = [(t.scores[i].cpu().numpy(), t.u[i].cpu().numpy(),
                  t.v[i].cpu().numpy()) for t in tops]
        t1 = time.perf_counter()
        if name in host_rows:
            parts.append(host_rows[name])
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
    device="cuda",
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
