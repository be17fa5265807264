"""Device memory budgets derived from the target device's memory.

Counterpart of ``linkpred_tpu/utils/device.py``.  The fractions below are the
reference's starting values; they have not been re-derived on a GPU yet.
"""
from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "device_count", "hbm_bytes", "free_bytes",
           "auto_slot_budget", "auto_seg_lanes"]

# Budget basis for a CPU device: the reference's 16 GiB default, so a plan
# built for the CPU equals the reference's CPU plan field for field.
_DEFAULT_BYTES = 16 << 30


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises, so a call that did not name the CPU never runs there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA card is available; pass "
            "device='cpu' to run on the CPU (the kernels' plain versions)")
    return device


def device_count(device) -> int:
    """The count of devices of ``device``'s type: the CUDA cards, or 1 for
    the CPU.  A CUDA device without a card raises."""
    device = resolve_device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 1


def hbm_bytes(device) -> int:
    """Memory of ``device`` in bytes: the card's total memory for a CUDA
    device, the reference's 16 GiB default for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    if device.type == "cpu":
        return _DEFAULT_BYTES
    raise ValueError(f"unsupported device {device}")


def free_bytes(device) -> int:
    """Memory a new allocation on ``device`` can take, in bytes: the card's
    free memory plus what PyTorch's caching allocator holds unused; for
    the CPU, the host's free physical pages."""
    device = torch.device(device)
    if device.type == "cuda":
        unused = (torch.cuda.memory_reserved(device)
                  - torch.cuda.memory_allocated(device))
        return int(torch.cuda.mem_get_info(device)[0]) + int(unused)
    if device.type == "cpu":
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    raise ValueError(f"unsupported device {device}")


def auto_slot_budget(device) -> int:
    """Packed-slot-stream ceiling: ~55% of device memory at 12 B/slot."""
    return min(int(hbm_bytes(device) * 0.55) // 12, (1 << 31) - (1 << 22))


def auto_seg_lanes(device) -> int:
    """Deferred-selection raw-buffer bound: ~20% of device memory at
    12 B/lane (one metric's key + u + v)."""
    return min(int(hbm_bytes(device) * 0.20) // 12, 1 << 29)
