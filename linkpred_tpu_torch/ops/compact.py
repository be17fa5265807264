"""Threshold compaction for the deferred selection: kernel K2 and its twin.

Counterpart of ``linkpred_tpu/ops/compact.py`` (the Pallas kernel
``_pack_kernel``, launched by ``pack_survivors``).  The selection needs the
kk smallest keys of a large buffer; instead of sorting every lane:

1. ``sample_threshold``: a strided sample of the keys is sorted, and its
   kk-quantile with a margin gives a threshold T with count(key <= T) >= kk
   with high probability.
2. ``pack_survivors``: exactly the lanes with key <= T, in lane order with
   their lane indices, go to the front of a buffer of
   ``total // PACK_RATIO`` lanes; the global survivor count comes back.
3. The caller (``scoring._argselect_packed``) sorts only the survivors when
   ``kk <= count <= capacity``, and otherwise sorts everything: exact either
   way.

The reference packs per fixed chunk with shift routing, because the TPU has
no vector scatter, and checks a per-chunk budget.  A GPU scatters, so the
port compacts globally and its check is the global count alone.

``pack_survivors`` is the wrapper: for CPU tensors it runs
:func:`pack_survivors_reference`; for CUDA tensors it launches
``kernels/csrc/compact.cu`` or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .topk import DEAD_KEY

__all__ = ["pack_survivors", "pack_survivors_reference", "sample_threshold",
           "PACK_RATIO", "LAUNCHES"]

# Survivor capacity as a fraction of the buffer (the reference's value).
PACK_RATIO = 4

# Launches of the CUDA kernel (the wrapper adds one per launch).
LAUNCHES = 0


def pack_survivors_reference(key, threshold):
    """Plain PyTorch pack; same arguments and results as
    :func:`pack_survivors`."""
    capacity = key.shape[0] // PACK_RATIO
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


def pack_survivors(key, threshold):
    """Pack the lanes with ``key <= threshold`` to the front, in lane order.

    ``key``: int32[total] selection keys (``ops/topk.py`` form);
    ``threshold``: a 0-dim int32 tensor on ``key``'s device.  Returns
    ``(pk int32[capacity], pidx int32[capacity], count)``: the survivors'
    keys and lane indices, dead lanes holding ``DEAD_KEY`` and 0, and the
    0-dim int32 global survivor count (survivors past ``capacity`` =
    ``total // PACK_RATIO`` are counted but dropped)."""
    if key.device.type == "cpu":
        return pack_survivors_reference(key, threshold)
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
    capacity = total // PACK_RATIO
    threshold = threshold.contiguous()
    pk = torch.empty(capacity, dtype=torch.int32, device=dev)
    pidx = torch.empty(capacity, dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    scratch = torch.empty(lib.lp_pack_scratch_bytes(total),
                          dtype=torch.uint8, device=dev)
    err = lib.lp_pack_survivors(
        dev.index, key.data_ptr(), threshold.data_ptr(), total, capacity,
        pk.data_ptr(), pidx.data_ptr(), count.data_ptr(), scratch.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "pack_survivors")
    global LAUNCHES
    LAUNCHES += 1
    return pk, pidx, count


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
