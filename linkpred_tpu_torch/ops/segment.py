"""Segmented reductions over sorted key runs (counterpart of
``linkpred_tpu/ops/segment.py``)."""
from __future__ import annotations

import torch

__all__ = ["run_boundaries", "cummax", "segment_run_totals"]


def cummax(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum along the last axis."""
    return torch.cummax(x, dim=-1).values


def run_boundaries(key_hi: torch.Tensor, key_lo: torch.Tensor):
    """(is_start, is_end) masks of equal-pair runs in a sorted pair stream."""
    neq = (key_hi[1:] != key_hi[:-1]) | (key_lo[1:] != key_lo[:-1])
    one = torch.ones(1, dtype=torch.bool, device=key_hi.device)
    return torch.cat([one, neq]), torch.cat([neq, one])


def segment_run_totals(is_start: torch.Tensor, *values: torch.Tensor):
    """Per-position within-run inclusive sums; a run's end holds its total.

    A log-step segmented scan (sums reset at run starts), not differences
    of a global cumsum, which cancel badly in float32 over large tiles.
    Returns one tensor per value (a tuple when there are several)."""
    f = is_start.clone()
    vs = list(values)
    s = 1
    cap = is_start.shape[-1]
    while s < cap:
        # lane i takes lane i-s's partial sum unless a run starts in (i-s, i]
        take = ~f[s:]
        vs = [torch.cat([v[:s], v[s:] + torch.where(take, v[:-s], 0.0)])
              for v in vs]
        f = torch.cat([f[:s], f[s:] | f[:-s]])
        s *= 2
    return tuple(vs) if len(vs) > 1 else vs[0]
