"""The deferred selection's pipeline and its parts, alone, at the s21 shape.

Counterpart of ``experiments/ab_pack_sel.py``: ``LANES`` (68 x 2^21 =
142.6M) int32 selection keys, a ``FINITE_FRAC`` (0.2) share of them finite
(uniform below the u32 key 0x44000000), the rest the spread -inf key
``0xFF800000 | (lane & 0x7FFFFE)`` (``scoring``'s dead keys), in the port's
int32 form (``ops/topk.py``); kk = ``KK`` (2,234,330).  The arms:

* ``sort_full``: the whole ``scoring._argselect_sort`` (one full sort);
* ``packed_full``: the whole ``scoring._argselect_packed`` (threshold, K2,
  a sort of the survivors, or the full sort when they miss);
* ``sample``: ``compact.sample_threshold`` alone;
* ``pack``: ``compact.pack_survivors`` (K2) alone, at the JAX probe's
  fixed threshold (``0x44000000 x FRAC x (KK / N / FRAC) x 1.3``);
* ``count``: the sampled threshold and the global count of the lanes at or
  under it, without the kernel.

The two whole arms select the same kk-th key and the same lanes above it.
Each arm is timed with CUDA events over ``ITERS`` (4) calls after a warm
one, ``REPEAT`` (2) times, the least kept.  The port compacts globally, so
the JAX probe's per-chunk budget and its ``blocked(N/4)`` model have no
arm.  Dropped from the JAX probe: the in-jit ``lax.scan`` over ``ITERS``
keys XOR-ed anew (the relay's amortization; the card's L2 holds no
meaningful share of a 2^24-lane buffer), and the ``(t_n - t_1) / (n - 1)``
difference.

    python -m linkpred_tpu_torch.experiments.ab_pack_sel [--lanes N]
        [--kk 2234330] [--iters 4] [--repeat 2] [--finite-frac 0.2]
        [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import Rows, ms, parser, same_keys

__all__ = ["SIZES", "make_keys", "fixed_threshold", "arms", "main"]

SIZES = {"LANES": (68 * (1 << 21), int, True), "KK": (2234330, int, True),
         "ITERS": (4, int, True), "REPEAT": (2, int, True),
         "FINITE_FRAC": (0.2, float, True)}


def make_keys(n: int, frac: float) -> np.ndarray:
    """The JAX probe's u32 keys from seed 0, in its draw order, as the
    port's int32 keys (``u ^ 0x80000000``)."""
    rng = np.random.default_rng(0)
    iota = np.arange(n, dtype=np.int64)
    finite = rng.random(n) < frac
    key = np.where(finite, rng.integers(0, 0x44000000, n, dtype=np.int64),
                   0xFF800000 | (iota & 0x7FFFFE)).astype(np.uint32)
    return (key ^ np.uint32(0x80000000)).view(np.int32)


def fixed_threshold(n: int, kk: int, frac: float) -> int:
    """The JAX probe's fixed pack threshold, in the port's int32 form."""
    u32 = int(np.uint32(0x44000000 * frac * (kk / n / frac) * 1.3))
    return u32 - (1 << 31)


def arms(key, kk: int, frac: float) -> dict:
    """``{name: thunk}`` of the five arms on ``key``."""
    from ..ops.compact import pack_survivors, sample_threshold
    from ..predict import scoring

    thr = torch.tensor(fixed_threshold(key.shape[0], kk, frac),
                       dtype=torch.int32, device=key.device)

    def count():
        t, _ = sample_threshold(key, kk)
        return (key <= t).sum()

    return {"sort_full": lambda: scoring._argselect_sort(key, kk),
            "packed_full": lambda: scoring._argselect_packed(key, kk),
            "sample": lambda: sample_threshold(key, kk)[0],
            "pack": lambda: pack_survivors(key, thr),
            "count": count}


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES).parse_args(argv)
    device = resolve_device(args.device)
    from ..ops import compact
    from ..predict import scoring

    n, kk = args.lanes, args.kk
    rows = Rows("ab_pack_sel", device, lanes=n, kk=kk,
                finite_frac=args.finite_frac)
    key = torch.as_tensor(make_keys(n, args.finite_frac), device=device)
    fns = arms(key, kk, args.finite_frac)
    packed = scoring.PACKED_ARM_RUNS
    kth = same_keys(key, {"sort_full": fns["sort_full"](),
                          "packed_full": fns["packed_full"]()}, kk,
                    "ab_pack_sel: the whole arms")
    took = "packed" if scoring.PACKED_ARM_RUNS > packed else "sort"
    _, _, cnt = fns["pack"]()
    times = {name: min(ms(fn, device, args.iters)
                       for _ in range(args.repeat))
             for name, fn in fns.items()}
    for name, t in times.items():
        rows.emit(row="arm", arm=name, ms=t)
    rows.emit(row="summary", kth_key=kth, packed_full_took=took,
              fixed_threshold_survivors=int(cnt),
              capacity=n // compact.PACK_RATIO,
              packed_over_sort=times["packed_full"] / times["sort_full"])
    return rows.rows


if __name__ == "__main__":
    main()
