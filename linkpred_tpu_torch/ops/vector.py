"""Gather, scatter, fill and arithmetic over index sets (counterpart of
``linkpred_tpu/ops/vector.py``): plain functions on tensors, run on the
tensors' device; each returns a new tensor.  Scans and norms are in
:mod:`.scan`."""
from __future__ import annotations

import torch

__all__ = ["gather_values", "scatter_values", "scatter_or", "value_indices",
           "fill_value", "add_value", "copy_values", "multiply_value",
           "multiply_values"]


def gather_values(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``out[i] = x[ids[i]]``."""
    return x[ids]


def scatter_values(a: torch.Tensor, ids: torch.Tensor,
                   x: torch.Tensor) -> torch.Tensor:
    """``out[ids[i]] = x[i]``; of duplicate ids, an arbitrary writer
    wins."""
    out = a.clone()
    out[ids] = x
    return out


def scatter_or(a: torch.Tensor, ids: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """``out[ids[i]] |= x[i]``, every writer of a duplicate id
    contributing.  ``scatter_reduce`` has no OR: a bool is an amax of
    bytes, and an integer is OR-ed bit by bit, one amax of that bit's
    flags a bit."""
    ids = ids.to(torch.int64)
    if a.dtype == torch.bool:
        return a.to(torch.uint8).scatter_reduce(
            0, ids, x.to(torch.uint8), "amax").to(torch.bool)
    acc = torch.zeros_like(a)
    flags = torch.zeros(a.shape, dtype=torch.uint8, device=a.device)
    for b in range(a.element_size() * 8):
        hit = flags.scatter_reduce(0, ids, ((x >> b) & 1).to(torch.uint8),
                                   "amax", include_self=False)
        acc |= hit.to(a.dtype) << b
    return a | acc


def value_indices(x: torch.Tensor, n: int) -> torch.Tensor:
    """int32[n] holding, for each value ``v`` of ``x``, an index ``i`` with
    ``x[i] == v`` (of duplicate values, an arbitrary one); 0 elsewhere."""
    out = torch.zeros(n, dtype=torch.int32, device=x.device)
    out[x] = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    return out


def fill_value(a: torch.Tensor, v, ids=None) -> torch.Tensor:
    """``a[:] = v``, or ``a[ids] = v``."""
    if ids is None:
        return torch.full_like(a, v)
    out = a.clone()
    out[ids] = v
    return out


def add_value(a: torch.Tensor, v, ids=None) -> torch.Tensor:
    """``a += v``, or ``a[ids] += v`` once for every occurrence of an
    id."""
    if ids is None:
        return a + v
    return a.index_add(0, ids, torch.full(ids.shape, v, dtype=a.dtype,
                                          device=a.device))


def copy_values(x: torch.Tensor, ids=None) -> torch.Tensor:
    """A copy of ``x``, or of ``x`` at ``ids`` only (zero elsewhere)."""
    if ids is None:
        return x.clone()
    out = torch.zeros_like(x)
    out[ids] = x[ids]
    return out


def multiply_value(a: torch.Tensor, v, ids=None) -> torch.Tensor:
    """``a *= v``, or ``a[ids] *= v`` once for every occurrence of an
    id."""
    if ids is None:
        return a * v
    return a.scatter_reduce(0, ids.to(torch.int64), torch.full(
        ids.shape, v, dtype=a.dtype, device=a.device), "prod")


def multiply_values(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise product."""
    return x * y
