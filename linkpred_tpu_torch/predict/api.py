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
from ..ops.topk import desc_score_key, spread_invalid
from ..utils.device import free_bytes, resolve_device
from ..utils.profiling import count, span
from ..utils.timing import measure_duration
from .metrics import get_metric
from .plan import TilePlan, build_plan
from .scoring import pass_bytes, score_huge_sources_host_multi, score_tiles

__all__ = ["PredictOptions", "PredictResult", "predict_links",
           "predict_links_multi", "top_per_source", "PlanCache",
           "device_bytes"]

_DEFAULT_MAX_EDGES = 1 << 20

# Device bytes a row that one metric's merge of the passes' winners
# allocates while it runs (:func:`_merge_winners`): the concatenated score,
# u and v, the selection key and its temporaries, the stable sort's keys,
# permutation and scratch.  The merged rows of every metric are priced
# apart.  Measured as max_memory_allocated over the merge, less what was
# allocated before it and the merged rows, over the rows of one metric:
# on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (torch
# 2.11.0+cu128), 17,573,888 rows a metric, 48.42 B at one metric and
# 52.21 at nine; this is the largest, rounded up.
MERGE_BYTES_PER_ROW = 53


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
    time_ms: float         # scoring + the merge of the passes' winners
    scoring_ms: float      # the device pass only
    transfer_ms: float = 0.0  # copy of the merged rows to the host

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


def _named_passes(p: TilePlan, name: str = "scan.pass"):
    """``p`` and its sub-plan passes in scoring order, each with the span
    of its scoring: ``scan.side`` for a wide-degree side stream,
    ``scan.pass`` for the others."""
    out = [(p, name)]
    for q, q_name in ((p.side_plan, "scan.side"), (p.huge_plan, "scan.pass")):
        if q is not None:
            out.extend(_named_passes(q, q_name))
    return out


def _sub_plans(p: TilePlan):
    """Sub-plan passes in scoring order: the side stream and the hub
    sub-plan (which may carry its own side stream)."""
    return [q for q, _ in _named_passes(p)[1:]]


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
    already there, in bytes, by item, each priced where it is allocated:
    ``stream`` and ``middeg`` (``TilePlan.upload_bytes``; under a ``mesh``,
    ``mesh.pending_bytes``), ``selection`` and ``tile``
    (``scoring.pass_bytes``, the largest pass's), ``gather``
    (``mesh.gather_bytes``), ``csr`` (:func:`_upload_csr`, unless
    ``csr_resident``), ``merge`` (:func:`_merge_winners`); and ``total``."""
    from ..parallel.mesh import gather_bytes, pending_bytes

    need = dict(stream=0, middeg=0, csr=0, selection=0, tile=0, gather=0,
                merge=0)
    rows = sum(p.host_src.size for p in passes) * min(k, g.n)
    for p in passes:
        if mesh is None:
            stream, middeg = p.upload_bytes(device, weighted)
            tiles = p.num_tiles_padded
        else:
            stream, middeg, tiles = pending_bytes(p, mesh, weighted)
        selection, tile = pass_bytes(tiles, p.cap, num_metrics, device)
        need["stream"] += stream
        need["middeg"] += middeg
        need["selection"] = max(need["selection"], selection)
        need["tile"] = max(need["tile"], tile)
        # a pass hands the merge k rows, and under a mesh of D > 1 ranks
        # D x k: every rank joins the gather, tiles or not
        if mesh is not None and mesh.size > 1:
            rows += mesh.size * k
        elif p.num_tiles_padded:
            rows += k
    if not csr_resident and not all(p.packed for p in passes):
        h = g.host()
        need["csr"] = h.indices.nbytes + h.degrees.nbytes
    if mesh is not None:
        need["gather"] = gather_bytes(mesh, num_metrics, k)
    # one metric's rows at a time, and every metric's merged rows twice
    need["merge"] = (rows * MERGE_BYTES_PER_ROW
                     + 2 * num_metrics * min(k, rows) * 12)
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


def _merge_winners(tops, host_rows: dict, names, max_edges: int, device):
    """Merge each metric's winners on ``device``: the passes' rows in
    scoring order (a sharded pass's ranks side by side: the ranks meet
    here), then the host scorer's, the non-finite scores dropped and the
    best ``max_edges`` kept, best first, the earlier row first among equal
    scores (``np.argsort(-scores, kind="stable")`` over the concatenation,
    which ties -0.0 with +0.0).  Returns ``(rows, lengths)``:
    every metric's kept rows stacked as int32 ``[3, sum(lengths)]`` (score
    bits, u, v) in ``names`` order, and each metric's count, read with one
    host sync."""
    base = sum(int(t.scores.shape[1]) for t in tops)
    total = [base + (host_rows[name][0].shape[0] if name in host_rows else 0)
             for name in names]
    take = [min(max_edges, t) for t in total]
    rows = torch.empty((3, sum(take)), dtype=torch.int32, device=device)
    finite, start = [], 0
    for i, name in enumerate(names):
        parts = [(t.scores[i], t.u[i], t.v[i]) for t in tops]
        if name in host_rows:
            parts.append(tuple(torch.from_numpy(a).to(device)
                               for a in host_rows[name]))
        scores, us, vs = (torch.cat(x) for x in zip(*parts))
        count("api.merge_rows", scores.shape[0])
        ok = torch.isfinite(scores)
        finite.append(ok.sum())
        # x + 0.0 maps -0.0 to +0.0; every non-finite row sorts last
        keyed = torch.where(ok, scores + 0.0, float("-inf"))
        lane = torch.arange(scores.shape[0], dtype=torch.int32, device=device)
        key = spread_invalid(desc_score_key(keyed), keyed, lane)
        del ok, keyed, lane
        top = torch.sort(key, stable=True).indices[:take[i]]
        del key
        dst = slice(start, start + take[i])
        start += take[i]
        for j, src in enumerate((scores.view(torch.int32), us, vs)):
            torch.index_select(src, 0, top, out=rows[j, dst])
        # one metric's buffers at a time: free them before the next's
        del scores, us, vs, top
    lengths = [min(int(c), t)
               for c, t in zip(torch.stack(finite).tolist(), take)]
    if lengths != take:
        # some metric took non-finite rows: keep only its finite ones
        starts = np.cumsum([0, *take[:-1]])
        rows = torch.cat([rows[:, s:s + n] for s, n in zip(starts, lengths)],
                         dim=1)
    return rows, lengths


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
    the selections fan out.  Each metric's winners of every pass (and of
    the host-scored hubs) are merged on the device, and the merged rows of
    every metric come back to the host in one copy.  Returns
    ``{metric_name: PredictResult}``; ``scoring_ms`` (the pass),
    ``time_ms`` (the pass and the merge) and ``transfer_ms`` (the copy) are
    split evenly across the metrics.

    ``min_degree1`` = 0 is IHub, > 0 LHub.  ``sources``: serving mode (score
    only pairs whose source is in the subset, directed candidates).
    Packed and edge-stream plans both run; hub sources past
    ``HUGE_DEVICE_MAX`` (``plan.host_src``) are scored on the host and
    their wall time counts in the pass time.

    ``mesh``: a ``parallel.mesh.Mesh``; the main plan and every sub-plan
    take the sharded pass (each rank uploads only its block and scans its
    tiles, one all-gather feeds the merge), scoring runs on ``mesh.device``
    in place of ``device``, and every rank returns the same result.
    ``key64=False`` is not ported and raises.  A pass whose device bytes
    (:func:`device_bytes`) exceed the free memory raises ``MemoryError``
    before anything is uploaded.

    The pass runs once untimed before the timed pass only on the plan's
    first scoring on ``device`` with these metrics, this ``k``,
    ``min_score`` and ``max_factor2`` and (under a mesh) this mesh size; a
    later call with the same plan and shape goes straight to the timed
    pass.

    The call is the span ``api.call``; inside it ``plan.build`` (where it
    builds the plan), ``api.memcheck``, ``api.upload``, ``api.host_hubs``,
    ``api.warmup`` (on a first scoring), ``api.score``, ``api.copy_back``
    and ``api.merge`` (``utils/profiling.py``), each pass's scoring in them
    the span ``scan.pass``, or ``scan.side`` for a wide-degree side plan;
    the counter ``api.merge_rows`` adds the rows that enter the merge, over
    metrics (every rank's under a mesh), ``api.rows_back`` the rows copied
    back, at most ``max_edges`` a metric, and ``api.warmup_skips`` the
    calls that skipped the warm-up."""
    with span("api.call"):
        return _predict_links_multi(
            g, metrics, min_degree1, max_factor2, options, cap, plan,
            plan_cache, mesh, sources, key64, device)


def _predict_links_multi(g, metrics, min_degree1, max_factor2, options, cap,
                         plan, plan_cache, mesh, sources, key64, device):
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
    passes, span_names = zip(*_named_passes(plan))
    k = _exact_k(plan, max_edges)
    weighted = any(s.needs_weight for s in specs)
    with span("api.memcheck"):
        _check_device_memory(device_bytes(
            g, passes, len(names), k, weighted, device, mesh,
            csr_resident=plan_cache is not None
            and plan_cache.has_device_graph(g, device)), device)
    with span("api.upload"):
        if mesh is None:
            streams = [(p.device_stream(device, weighted), p.tile_start)
                       for p in passes]
        else:
            # each rank uploads only its block; the full stream is never
            # made
            streams = [shard_stream(p, mesh, weighted) for p in passes]
        indices = degrees = None
        if not all(p.packed for p in passes):
            indices, degrees = (plan_cache.device_graph(g, device)
                                if plan_cache is not None
                                else _upload_csr(g, device))

    def run_scoring():
        out = []
        for p, name, (stream, tile_start) in zip(passes, span_names,
                                                 streams):
            kw = dict(metric_names=names, k=k, n=g.n, maxf2=max_factor2,
                      indices=indices, degrees=degrees, span_name=name,
                      **_pass_kwargs(p))
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
        with span("api.host_hubs"):
            host_rows = score_huge_sources_host_multi(
                g, plan.host_src, specs, min_degree1, max_factor2,
                o.min_score, k=max_edges, upper_only=plan.upper_only)
        host_ms = (time.perf_counter() - t0) * 1e3

    # The untimed warm-up keeps a plan's first-use costs (the kernels'
    # build and load, the allocator's first growth for these shapes) out
    # of the clock, so only a plan's first scoring of a shape warms up.
    # The names also fix whether a weighted input is read; min_score and
    # max_factor2 fix how many lanes survive into the selection, whose
    # buffers follow that count.  The allocator keeps what it grew until
    # ``torch.cuda.empty_cache()``: a repeat scoring after one may grow it
    # again inside ``time_ms``.  Every rank of a mesh makes the same calls
    # on the same plan and so the same decision.
    shape = (names, k, o.min_score, max_factor2,
             None if mesh is None else mesh.size)
    first = plan.first_scoring(device, shape)
    if not first:
        count("api.warmup_skips")
    ts, tops = measure_duration(run_scoring, o.repeat, warmup=first,
                                device=device)
    plan.note_scored(device, shape)
    ts += host_ms

    t0 = time.perf_counter()
    with span("api.merge"):
        rows, lengths = _merge_winners(tops, host_rows, names, max_edges,
                                       device)
    t1 = time.perf_counter()
    with span("api.copy_back"):
        # Page-locked memory from PyTorch's caching host allocator, which
        # hands a block out again only once every array viewing it is gone,
        # so no result aliases a later call's.  On an H100 it took the
        # rows at ~40 GB/s, where fresh pageable memory took ~2 GB/s.
        back = torch.empty(rows.shape, dtype=rows.dtype,
                           pin_memory=rows.is_cuda)
        back.copy_(rows)
        back = back.numpy()
    t2 = time.perf_counter()
    count("api.rows_back", back.shape[1])
    scoring_ms = ts / len(names)
    merge_ms, transfer_ms = ((b - a) * 1e3 / len(names)
                             for a, b in ((t0, t1), (t1, t2)))
    results, start = {}, 0
    for name, n in zip(names, lengths):
        cols = slice(start, start + n)
        start += n
        results[name] = PredictResult(
            u=back[1, cols], v=back[2, cols],
            score=back[0, cols].view(np.float32),
            time_ms=scoring_ms + merge_ms, scoring_ms=scoring_ms,
            transfer_ms=transfer_ms)
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
    """Keep the best ``k`` predictions per source vertex (serving helper);
    the span ``api.top_per_source``."""
    with span("api.top_per_source"):
        return _top_per_source(result, k)


def _top_per_source(result: PredictResult, k: int) -> PredictResult:
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
