"""Threshold compaction for the deferred selection: kernel K2 and its twin.

Counterpart of ``linkpred_tpu/ops/compact.py`` (the Pallas kernel
``_pack_kernel``, launched by ``pack_survivors``).  The selection needs the
kk smallest keys of a large buffer; instead of sorting every lane:

1. ``sample_threshold``: a strided sample of the keys is sorted, and its
   kk-quantile with a margin gives a threshold T with count(key <= T) >= kk
   with high probability.
2. ``pack_survivors``: exactly the lanes with key <= T, in lane order with
   their lane indices, go to the front of a buffer of ``total // ratio``
   lanes (``PACK_RATIO`` unless given); the global survivor count comes
   back.
3. The caller (``scoring._argselect_packed``) sorts only the survivors when
   ``kk <= count <= capacity``, and otherwise sorts everything: exact either
   way.

The reference packs per fixed chunk with shift routing, because the TPU has
no vector scatter, and checks a per-chunk budget.  A GPU scatters, so the
port compacts globally and its check is the global count alone.

``pack_survivors`` is the wrapper: for CPU tensors it runs
:func:`pack_survivors_reference`; for CUDA tensors it launches
``kernels/csrc/compact.cu`` or raises, and counts the launch in the
counter ``k2.launches`` (``utils/profiling.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import count
from .topk import DEAD_KEY

__all__ = ["pack_survivors", "pack_survivors_reference", "sample_threshold",
           "PACK_RATIO", "MAX_TOTAL"]

# Survivor capacity as a fraction of the buffer (the reference's value).
PACK_RATIO = 4

# Lanes the pack takes: its lane indices and count are int32.
MAX_TOTAL = 1 << 31


def pack_survivors_reference(key, threshold, ratio: int = None):
    """Plain PyTorch pack; same arguments and results as
    :func:`pack_survivors`."""
    capacity = key.shape[0] // (PACK_RATIO if ratio is None else ratio)
    keep = key <= threshold
    idx = torch.nonzero(keep).flatten()
    count = keep.sum(dtype=torch.int32)
    idx = idx[:capacity]
    pk = torch.full((capacity,), DEAD_KEY, dtype=torch.int32,
                    device=key.device)
    pidx = torch.zeros(capacity, dtype=torch.int32, device=key.device)
    pk[: idx.shape[0]] = key[idx]
    pidx[: idx.shape[0]] = idx.to(torch.int32)
    return pk, pidx, count


def pack_survivors(key, threshold, ratio: int = None):
    """Pack the lanes with ``key <= threshold`` to the front, in lane order.

    ``key``: int32[total] selection keys (``ops/topk.py`` form);
    ``threshold``: a 0-dim int32 tensor on ``key``'s device.  Returns
    ``(pk int32[capacity], pidx int32[capacity], count)``: the survivors'
    keys and lane indices, dead lanes holding ``DEAD_KEY`` and 0, and the
    0-dim int32 global survivor count (survivors past ``capacity`` =
    ``total // ratio`` are counted but dropped).  ``ratio`` defaults to
    ``PACK_RATIO``; at 1 every survivor fits (the radix probe's 1-bit
    split).  Raises ``ValueError`` for ``total >= 2^31``: lane indices and
    the count are int32."""
    ratio = PACK_RATIO if ratio is None else ratio
    if key.shape[0] >= MAX_TOTAL:
        raise ValueError(f"pack_survivors: {key.shape[0]} lanes, the int32 "
                         f"lane indices take fewer than {MAX_TOTAL}")
    if key.device.type == "cpu":
        return pack_survivors_reference(key, threshold, ratio)
    if key.device.type != "cuda":
        raise ValueError(f"pack_survivors: unsupported device {key.device}")
    if key.dtype != torch.int32 or key.dim() != 1 \
            or not key.is_contiguous():
        raise ValueError("pack_survivors: key must be contiguous int32[total]")
    if threshold.dtype != torch.int32 or threshold.numel() != 1 \
            or threshold.device != key.device:
        raise ValueError("pack_survivors: threshold must be one int32 on "
                         f"{key.device}")
    from ..kernels import _build

    lib = _build.load()
    dev = key.device
    total = key.shape[0]
    capacity = total // ratio
    threshold = threshold.contiguous()
    # one allocation (the host's cost per call is mostly allocations):
    # pk, pidx at 16-byte aligned offsets, the kernel's scratch (8-byte
    # words), the count
    span = -(-capacity // 4) * 4
    words = lib.lp_pack_scratch_bytes(total) // 4
    buf = torch.empty(2 * span + words + 1, dtype=torch.int32, device=dev)
    pk, pidx = buf[:capacity], buf[span: span + capacity]
    scratch, survivors = buf[2 * span:], buf[2 * span + words]
    err = lib.lp_pack_survivors(
        dev.index, key.data_ptr(), threshold.data_ptr(), total, capacity,
        pk.data_ptr(), pidx.data_ptr(), survivors.data_ptr(),
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "pack_survivors")
    count("k2.launches")
    return pk, pidx, survivors


def sample_threshold(key, kk: int, sample_log2: int = 20,
                     margin: float = 1.10):
    """Sampled kk-quantile threshold: T with count(key <= T) >= kk with high
    probability.  A strided sample is sorted; the quantile at kk/total is
    inflated by ``margin`` plus a 4-sigma binomial allowance.  Returns
    (T as a 0-dim tensor, its sample index) — the reference's T, in the
    port's key form, for equal keys."""
    total = key.shape[0]
    n_s = min(1 << sample_log2, total)
    stride = total // n_s
    sample = torch.sort(key[: n_s * stride: stride]).values
    frac = kk / total
    q = frac * margin + 4.0 * float(np.sqrt(max(frac * (1 - frac), 1e-12)
                                            / n_s))
    qi = min(int(q * n_s), n_s - 1)
    return sample[qi], qi
