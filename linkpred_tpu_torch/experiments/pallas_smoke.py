"""Probe P5: the toolchain smoke, ``2x + 1`` over int32.

Counterpart of ``experiments/pallas_smoke.py::f`` (the Pallas kernel that
showed Mosaic kernels compile and run on the TPU).  Here it shows that
``nvcc`` built the kernel library for the card and that a launch through
ctypes runs: :func:`affine_smoke` launches ``kernels/csrc/smoke.cu`` for
CUDA tensors (or raises) and runs :func:`affine_smoke_reference`, its plain
version, for CPU tensors.
"""
from __future__ import annotations

import torch

__all__ = ["affine_smoke", "affine_smoke_reference", "LAUNCHES"]

# Launches of the CUDA kernel (the wrapper adds one per launch).
LAUNCHES = 0


def affine_smoke_reference(x):
    """``2 * x + 1``, wrapping as int32 does."""
    return x * 2 + 1


def affine_smoke(x):
    """``2 * x + 1`` of a contiguous int32 tensor, in a new tensor."""
    if x.device.type == "cpu":
        return affine_smoke_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"affine_smoke: unsupported device {x.device}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("affine_smoke: x must be a contiguous int32 tensor")
    from ..kernels import _build

    lib = _build.load()
    out = torch.empty_like(x)
    err = lib.lp_affine_smoke(x.device.index, x.data_ptr(), out.data_ptr(),
                              x.numel(),
                              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, err, "affine_smoke")
    global LAUNCHES
    LAUNCHES += 1
    return out
