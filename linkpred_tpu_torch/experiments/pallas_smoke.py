"""Probe P5: the toolchain smoke, ``2x + 1`` over int32.

Counterpart of ``experiments/pallas_smoke.py::f`` (the Pallas kernel that
showed Mosaic kernels compile and run on the TPU).  Here it shows that
``nvcc`` built the kernel library for the card and that a launch through
ctypes runs: :func:`affine_smoke` launches ``kernels/csrc/smoke.cu`` for
CUDA tensors (or raises) and runs :func:`affine_smoke_reference`, its plain
version, for CPU tensors.  :func:`launch_floor_us` reads the card's launch
floor from the same library: empty kernels launched back to back from C.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["affine_smoke", "affine_smoke_reference", "launch_floor_us",
           "LAUNCHES"]

# Launches of the CUDA kernel (the wrapper adds one per launch).
LAUNCHES = 0

# The kernel's entry point, looked up on the first launch.
_launch = None


def affine_smoke_reference(x):
    """``2 * x + 1``, wrapping as int32 does."""
    return x * 2 + 1


def _library():
    from ..kernels import _build

    return _build, _build.load()


def affine_smoke(x):
    """``2 * x + 1`` of a contiguous int32 tensor, in a new tensor."""
    if x.device.type == "cpu":
        return affine_smoke_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"affine_smoke: unsupported device {x.device}")
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("affine_smoke: x must be a contiguous int32 tensor")
    global _launch, LAUNCHES
    if _launch is None:
        _launch = _library()[1].lp_affine_smoke
    out = torch.empty_like(x)
    index = x.device.index
    # the current stream's handle, as torch.cuda.current_stream(...)
    # .cuda_stream gives it, without making a Stream object
    err = _launch(index, x.data_ptr(), out.data_ptr(), x.numel(),
                  torch._C._cuda_getCurrentRawStream(index))
    if err:
        build, lib = _library()
        build.check(lib, err, "affine_smoke")
    LAUNCHES += 1
    return out


def launch_floor_us(device, n_launches: int = 1000) -> float:
    """Microseconds a launch of an empty kernel on CUDA ``device``, over
    ``n_launches`` launches issued back to back from C between two CUDA
    events on the current stream (``lp_launch_floor`` in ``smoke.cu``)."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"launch_floor_us: needs a CUDA device, not "
                         f"{device}")
    build, lib = _library()
    fn = lib.lp_launch_floor
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_double)]
    index = 0 if device.index is None else device.index
    us = ctypes.c_double()
    err = fn(index, n_launches,
             torch.cuda.current_stream(device).cuda_stream, ctypes.byref(us))
    build.check(lib, err, "launch_floor_us")
    return us.value
