"""Small numeric helpers (counterpart of ``linkpred_tpu/utils/numeric.py``)."""
from __future__ import annotations

__all__ = ["next_pow2"]


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()
