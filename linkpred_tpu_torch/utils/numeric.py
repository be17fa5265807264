"""Small numeric helpers (counterpart of ``linkpred_tpu/utils/numeric.py``),
with the reference's prime helpers: host utilities, as the sort-based
engine never sizes a hash table."""
from __future__ import annotations

__all__ = ["next_pow2", "is_prime", "next_prime", "random_prime"]


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 1)."""
    return 1 << max(int(x) - 1, 0).bit_length()


def is_prime(x: int) -> bool:
    """Trial division by 2, 3 and 6k ± 1."""
    x = int(x)
    if x <= 3:
        return x > 1
    if x % 2 == 0 or x % 3 == 0:
        return False
    i = 5
    while i * i <= x:
        if x % i == 0 or x % (i + 2) == 0:
            return False
        i += 6
    return True


def next_prime(x: int) -> int:
    """Smallest prime strictly greater than ``x``."""
    x = int(x)
    while True:
        x += 1
        if is_prime(x):
            return x


def random_prime(begin: int, end: int, rng) -> int:
    """A random prime in [begin, end], or ``end + 1`` when 128 draws find
    none.  ``rng`` is a ``numpy.random.Generator``."""
    for _ in range(128):
        a = int(rng.integers(begin, end + 1))
        if is_prime(a):
            return a
    return end + 1
