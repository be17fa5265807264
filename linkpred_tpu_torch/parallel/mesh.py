"""Multi-device scaling: the tile-sharded pass over ``torch.distributed``
(counterpart of ``linkpred_tpu/parallel/mesh.py``).

The reference scales with one OpenMP ``parallel for`` over vertices and
per-thread top-k heaps merged serially.  Here each rank of a process group
is one worker:

* the plan's real tiles are cut into contiguous per-rank blocks, balanced
  by slot count (packed plans) or by the tiles' slot totals (edge plans,
  ``fe_work``), as the reference cuts them (:func:`shard_layout`);
* each rank uploads ONLY its block of the stream (its span plus the
  ``cap``-lane window tail, padded by ``plan._pad_bucket``; the reference
  pads to a power of two, which this port does not copy), so per-rank
  stream memory is ~total/D (:func:`shard_stream`);
* each rank scans its tiles with the single-device engine
  (``scoring.score_tiles``: the tile sort, K1, K2), pads its top k to
  ``[M, k]``, and one ``all_gather`` hands every rank's winners to every
  rank (:func:`score_tiles_sharded`); they meet in the API's merge
  (``predict.api._merge_winners``), so every rank has the same result.

A :class:`Mesh` is the port's stand-in for a 1-D ``jax.sharding.Mesh``: the
process group, this rank's device, its rank and the group's size.  Without
an initialized group, :func:`make_mesh` gives a one-rank mesh.

Not ported: ``score_tiles_sharded_chunked`` (chunked dispatch existed only
for the reference's device relay) and the round-robin replicated-stream
layout of ``pad_tiles_for_mesh``, which is kept as the NumPy helper it is.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.topk import TopK
from ..predict.plan import _pad_bucket
from ..utils.device import resolve_device

__all__ = ["Mesh", "ShardLayout", "make_mesh", "pad_tiles_for_mesh",
           "shard_layout", "block_arrays", "shard_stream", "pending_bytes",
           "score_tiles_sharded", "gather_topk", "gather_bytes"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh of the ranks of one process group: ``group`` is None for
    a one-rank mesh without a process group.  ``device`` is where this
    rank scores."""
    group: Optional[object]
    device: torch.device
    rank: int
    size: int
    axis: str = "workers"

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)


def make_mesh(n_devices: Optional[int] = None, axis: str = "workers",
              device=None) -> Mesh:
    """A 1-D mesh over every rank of the initialized process group (one
    rank when none is initialized).  ``n_devices`` names the ranks the
    caller expects: more than the group holds raises, as the reference's
    ``make_mesh`` does for devices, and so does fewer (a mesh spans the
    whole group).  ``device`` defaults to ``cuda:{local_rank %
    device_count}``; ``"cpu"`` puts the rank on the CPU.  A CUDA device
    without a card raises."""
    if dist.is_available() and dist.is_initialized():
        group, rank, size = dist.group.WORLD, dist.get_rank(), \
            dist.get_world_size()
    else:
        group, rank, size = None, 0, 1
    if n_devices is not None and n_devices > size:
        raise ValueError(f"need {n_devices} ranks, have {size}")
    if n_devices is not None and n_devices < size:
        raise ValueError(f"a mesh spans the whole process group: asked for "
                         f"{n_devices} ranks of {size}")
    if device is None:
        if not torch.cuda.is_available():
            resolve_device("cuda")      # raises: no card
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = f"cuda:{local % torch.cuda.device_count()}"
    return Mesh(group=group, device=resolve_device(device), rank=rank,
                size=size, axis=axis)


def pad_tiles_for_mesh(
    tile_edge_start: np.ndarray, n_devices: int,
    empty_at: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Split tile windows into per-device (starts, ends) of shape [T'], T' a
    multiple of ``n_devices``, laid out device-major (device d takes tiles
    d, d + D, ...).  Padding tiles are empty windows (start == end)."""
    starts = np.asarray(tile_edge_start[:-1], dtype=np.int32)
    ends = np.asarray(tile_edge_start[1:], dtype=np.int32)
    t = starts.shape[0]
    tp = ((t + n_devices - 1) // n_devices) * n_devices
    if tp != t:
        fill = np.int32(tile_edge_start[-1] if empty_at is None else empty_at)
        starts = np.concatenate([starts, np.full(tp - t, fill, np.int32)])
        ends = np.concatenate([ends, np.full(tp - t, fill, np.int32)])
    starts = starts.reshape(-1, n_devices).T.reshape(-1)
    ends = ends.reshape(-1, n_devices).T.reshape(-1)
    return starts, ends


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Per-rank contiguous tile blocks of one plan.

    ``cuts[d]:cuts[d + 1]`` are rank d's tiles; ``tile_s``/``tile_e`` [D,
    t_loc] their bounds local to the rank's block (zeros past its tiles,
    as the reference lays them out); ``span[d]`` the block's stream length
    without the window tail; ``l_pad`` the width every block is uploaded
    at: ``_pad_bucket(max(span) + cap)``."""
    cuts: np.ndarray       # int64[D + 1]
    tile_s: np.ndarray     # int32[D, t_loc]
    tile_e: np.ndarray     # int32[D, t_loc]
    base: np.ndarray       # int64[D] the block's first stream row
    span: np.ndarray       # int64[D]
    l_pad: int

    def tiles(self, d: int) -> int:
        return int(self.cuts[d + 1] - self.cuts[d])

    def tile_start(self, d: int) -> np.ndarray:
        """Rank d's block-local tile bounds as ``scoring.scan_tiles`` takes
        them: ``tiles(d) + 1`` entries (tiles are contiguous)."""
        nt = self.tiles(d)
        return np.concatenate([self.tile_s[d, :nt],
                               self.tile_e[d, nt - 1: nt]]).astype(np.int64)


def shard_layout(plan, d_count: int) -> ShardLayout:
    """Cut ``plan``'s real tiles into ``d_count`` contiguous blocks,
    balanced by slots: window units for a packed plan, the tiles' ``fe_work``
    slot totals for an edge plan (whose blocks stay ~edges/D since tiles
    are slot-capped).  The cuts and block-local bounds equal the
    reference's ``shard_stream_for_mesh``; the width is
    ``_pad_bucket(max(span) + cap)``, not the next power of two."""
    ts = np.asarray(plan.tile_start, dtype=np.int64)
    t = plan.num_tiles
    starts, ends = ts[:t], ts[1: t + 1]
    if plan.packed:
        sizes = ends - starts
    else:
        wsum = np.concatenate(
            [[0], np.cumsum(np.asarray(plan.fe_work, dtype=np.int64))])
        sizes = wsum[ends] - wsum[starts]
    csum = np.cumsum(sizes) if t else np.zeros(0, dtype=np.int64)
    total = int(csum[-1]) if t else 0
    cuts = [0] + [int(np.searchsorted(csum, total * d / d_count))
                  for d in range(1, d_count)] + [t]
    t_loc = max(max(cuts[d + 1] - cuts[d] for d in range(d_count)), 1)
    tile_s = np.zeros((d_count, t_loc), dtype=np.int32)
    tile_e = np.zeros((d_count, t_loc), dtype=np.int32)
    base = np.zeros(d_count, dtype=np.int64)
    span = np.zeros(d_count, dtype=np.int64)
    for d in range(d_count):
        lo, hi = cuts[d], cuts[d + 1]
        if hi <= lo:
            continue
        base[d] = starts[lo]
        span[d] = ends[hi - 1] - starts[lo]
        tile_s[d, : hi - lo] = starts[lo:hi] - base[d]
        tile_e[d, : hi - lo] = ends[lo:hi] - base[d]
    return ShardLayout(cuts=np.asarray(cuts, dtype=np.int64), tile_s=tile_s,
                       tile_e=tile_e, base=base, span=span,
                       l_pad=_pad_bucket(int(span.max()) + plan.cap))


def block_arrays(plan, layout: ShardLayout, d: int, weighted: bool = False):
    """Rank d's block of the plan's stream as host arrays of width
    ``layout.l_pad``: rows ``[base, base + span + cap)`` of each array
    (cut at the array's end), zeros after.  One-element dummies (the
    unused ``slot_wdeg`` of a deg16 plan) stay one element; deg(mid) is
    None unless ``weighted``."""
    s0 = int(layout.base[d])
    n_rows = int(layout.span[d]) + plan.cap

    def block(a):
        if a is None or a.shape[0] <= 1:
            return a
        out = np.zeros(layout.l_pad, dtype=a.dtype)
        part = a[s0: s0 + n_rows]
        out[: part.shape[0]] = part
        return out

    return tuple(block(a) for a in plan.host_stream(weighted))


def _entry(plan, mesh: Mesh):
    """The plan's memo entry for ``mesh``: ``(mesh, layout, uploads)``.
    The entry pins the mesh, so an ``id()`` hit is always this mesh."""
    key = ("sharded", id(mesh), str(mesh.device))
    hit = plan._device.get(key)
    if hit is None or hit[0] is not mesh:
        hit = (mesh, shard_layout(plan, mesh.size), {})
        plan._device[key] = hit
    return hit


def pending_bytes(plan, mesh: Mesh, weighted: bool = False):
    """``(stream, middeg, tiles)``: the bytes :func:`shard_stream` has yet
    to upload for this rank (its block, and deg(mid) when ``weighted``)
    and the rank's tile count."""
    _, layout, memo = _entry(plan, mesh)
    tiles = layout.tiles(mesh.rank)
    if tiles == 0:
        return 0, 0, 0

    def nbytes(a):
        return 0 if a is None else (
            a.nbytes if a.shape[0] <= 1 else layout.l_pad * a.itemsize)

    *arrays, middeg = plan.host_stream(weighted)
    stream = 0 if "stream" in memo else sum(nbytes(a) for a in arrays)
    return stream, 0 if "middeg" in memo else nbytes(middeg), tiles


def shard_stream(plan, mesh: Mesh, weighted: bool = False):
    """This rank's block of ``plan``'s stream on ``mesh.device`` and its
    block-local tile bounds: ``(stream, tile_start)``, or ``(None, None)``
    for a rank with no tiles (it uploads nothing).  Only this rank's block
    is built and uploaded; the full ``device_stream`` is never made.
    Memoized on the plan per mesh and device; deg(mid) is uploaded once a
    weighted metric asks for it."""
    _, layout, memo = _entry(plan, mesh)
    d = mesh.rank
    if layout.tiles(d) == 0:
        return None, None
    if "stream" not in memo or (weighted and "middeg" not in memo):
        *host, middeg = block_arrays(plan, layout, d, weighted)
        if "stream" not in memo:
            memo["stream"] = tuple(torch.as_tensor(a, device=mesh.device)
                                   for a in host)
        if weighted:
            memo["middeg"] = torch.as_tensor(middeg, device=mesh.device)
    return ((*memo["stream"], memo.get("middeg") if weighted else None),
            layout.tile_start(d))


def _invalid_topk(m: int, k: int, device) -> TopK:
    return TopK(torch.full((m, k), float("-inf"), dtype=torch.float32,
                           device=device),
                torch.zeros((m, k), dtype=torch.int32, device=device),
                torch.zeros((m, k), dtype=torch.int32, device=device))


def gather_topk(local: TopK, mesh: Mesh, k: int) -> TopK:
    """Pad this rank's ``[M, k']`` top k to ``[M, k]`` with empty slots
    (-inf), all-gather it over the mesh and return every rank's ``[M, k]``
    side by side in rank order, ``[M, D x k]``.  NCCL gathers on the card;
    gloo gathers host tensors, so under gloo the buffer goes through the
    host and comes back to the rank's device."""
    m, kk = local.scores.shape
    buf = _invalid_topk(m, k, local.scores.device)
    for dst, src in zip(buf, local):
        dst[:, :kk] = src
    if mesh.group is None:
        return buf
    # one collective: the scores' bits ride beside u and v as int32
    packed = torch.stack([buf.scores.view(torch.int32), buf.u, buf.v])
    host = mesh.backend == "gloo" and packed.device.type != "cpu"
    send = packed.cpu() if host else packed
    parts = [torch.empty_like(send) for _ in range(mesh.size)]
    dist.all_gather(parts, send, group=mesh.group)
    out = torch.stack(parts, dim=2).to(packed.device).reshape(3, m, -1)
    return TopK(out[0].view(torch.float32), out[1], out[2])


def gather_bytes(mesh: Mesh, num_metrics: int, k: int) -> int:
    """The device bytes :func:`gather_topk` allocates: the ranks' int32
    ``[3, M, k]`` parts and their side-by-side copy; 0 for one rank."""
    return 0 if mesh.size == 1 else 2 * mesh.size * 3 * num_metrics * k * 4


def score_tiles_sharded(stream, tile_start, min_score: float, *,
                        metric_names, k: int, mesh: Mesh, **kw) -> TopK:
    """One rank's part of a sharded pass.  ``stream`` and ``tile_start``
    are :func:`shard_stream`'s (None for a rank with no tiles, which still
    joins the gather with an empty buffer); the other keywords are
    ``scoring.tile_scorer``'s.  Returns every rank's winners, ``[M, D x
    k]``, the same on every rank; a one-rank mesh its own, not gathered."""
    from ..predict.scoring import score_tiles

    if stream is None:
        local = _invalid_topk(len(metric_names), k, mesh.device)
    else:
        local = score_tiles(stream, tile_start, min_score,
                            metric_names=metric_names, k=k,
                            device=mesh.device, **kw)
    return local if mesh.size == 1 else gather_topk(local, mesh, k)
