"""The reference's xorshift32 generator (counterpart of
``linkpred_tpu/utils/random.py``): a host engine, bit-exact with the
reference's sequence, and a vectorised step over tensors (one generator per
lane).  The port's own sampling takes an explicit ``numpy.random.Generator``
or ``torch.Generator``.

torch has no logical right shift on int32 and its uint32 shifts differ
between builds, so the device step works in int64 masked to 32 bits.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["Xorshift32", "xorshift32_step"]

_MASK32 = 0xFFFFFFFF


class Xorshift32:
    """``x ^= x << 13; x ^= x >> 17; x ^= x << 5`` on a uint32 state."""

    MIN = 0
    MAX = 0xFFFFFFFF

    def __init__(self, seed: int = 1):
        self.state = np.uint32(seed if seed else 1)

    def __call__(self) -> int:
        x = self.state
        x ^= np.uint32(x << np.uint32(13))
        x ^= np.uint32(x >> np.uint32(17))
        x ^= np.uint32(x << np.uint32(5))
        self.state = x
        return int(x)


def xorshift32_step(state, device="cuda") -> torch.Tensor:
    """One xorshift32 step of every lane.  ``state`` holds uint32 values
    (a tensor of any integer dtype, or an array); a tensor is stepped on
    its own device, anything else is put on ``device`` first.  Returns
    int64 values in [0, 2^32)."""
    if isinstance(state, torch.Tensor):
        x = state.to(torch.int64)
    else:
        x = torch.as_tensor(np.asarray(state, dtype=np.int64),
                            device=resolve_device(device))
    x = x & _MASK32
    x = x ^ ((x << 13) & _MASK32)
    x = x ^ (x >> 17)
    return x ^ ((x << 5) & _MASK32)
