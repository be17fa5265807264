"""Scans and reductions (counterpart of ``linkpred_tpu/ops/scan.py``):
plain functions on tensors, run on the tensors' device.  A scan keeps its
input's dtype, as the reference's does."""
from __future__ import annotations

import torch

__all__ = ["inclusive_scan", "exclusive_scan", "sum_values", "count_value",
           "l1_norm", "l2_norm", "li_norm", "l1_norm_delta", "l2_norm_delta",
           "li_norm_delta"]


def inclusive_scan(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inclusive prefix sum along ``axis``."""
    return torch.cumsum(x, dim=axis, dtype=x.dtype)


def exclusive_scan(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Exclusive prefix sum along ``axis``."""
    return inclusive_scan(x, axis) - x


def sum_values(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x)


def count_value(x: torch.Tensor, v) -> torch.Tensor:
    """Occurrences of ``v``."""
    return torch.sum(x == v)


def l1_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x))


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def li_norm(x: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(x))


def l1_norm_delta(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(x - y))


def l2_norm_delta(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum((x - y) ** 2))


def li_norm_delta(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(x - y))
