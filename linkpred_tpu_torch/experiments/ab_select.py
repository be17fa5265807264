"""A/B: four ways to select the top k of a large buffer of tile scores.

Counterpart of ``experiments/ab_select.py``, on ``make_data(log2n)``: 2^25
lanes (``--log2n``), 35% valid, Jaccard-like ties (small rationals) and a
continuous tail, the rest -inf; k = 2^19 (``--k``).  The arms, on the
port's int32 descending key (``ops/topk.py``; the JAX probe's u32
``desc_key`` with its sign bit flipped, the same order):

* A ``sort``: one full sort of the key (the -inf lanes one duplicate key);
* B ``spread``: the same with the -inf lanes spread by lane
  (``topk.spread_invalid``);
* C ``topk``: ``torch.topk`` on the float32 scores;
* D ``twopass``: a 32-step binary search of the key space for the k-th
  key (one count a step), then a sort of the survivors alone.

The k-th key is equal in every arm, and so is the multiset of the top k
keys; lanes may differ only within the ties at the k-th key.  Each arm is
timed with CUDA events over ``--iters`` (4) calls after a warm one.
Dropped from the JAX probe: the in-jit ``lax.scan`` iteration with the
runtime zero ``(c >> 31)`` added to the data (the card has no relay to
amortize), and ``AB_SKIP``.

    python -m linkpred_tpu_torch.experiments.ab_select [--log2n 25]
        [--k 524288] [--iters 4] [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import Rows, ms, parser, same_keys

__all__ = ["SIZES", "make_data", "desc_key", "arm_sort", "arm_spread",
           "arm_topk", "arm_twopass", "ARMS", "main"]

SIZES = {"LOG2N": (25, int, False), "K": (1 << 19, int, False),
         "ITERS": (4, int, False)}


def make_data(log2n: int) -> np.ndarray:
    """The JAX probe's scores, drawn in its order from seed 0: float32
    ``[2^log2n]``, ~35% valid (half of them 1/1..1/63, repeated; the rest
    uniform), the others -inf."""
    n = 1 << log2n
    rng = np.random.default_rng(0)
    x = np.full(n, -np.inf, dtype=np.float32)
    valid = rng.random(n) < 0.35
    nv = int(valid.sum())
    half = np.repeat(np.float32(1.0) / np.arange(1, 64, dtype=np.float32),
                     nv // 64 + 1)[: nv // 2]
    pool = np.concatenate([half, rng.random(nv - half.shape[0],
                                            dtype=np.float32)])
    rng.shuffle(pool)
    x[valid] = pool
    return x


def desc_key(x):
    """The port's int32 key of float32 scores ``x``: ascending key order is
    descending score order, -inf last (``topk.desc_score_key``)."""
    from ..ops.topk import desc_score_key

    return desc_score_key(x)


def arm_sort(x, k: int):
    """A: one full sort of the key; ``(keys, lanes)`` of the top k."""
    sk, idx = torch.sort(desc_key(x))
    return sk[:k], idx[:k]


def arm_spread(x, k: int):
    """B: A with the -inf lanes spread by lane (they still sort last);
    the keys returned are the unspread ones, for comparison."""
    from ..ops.topk import spread_invalid

    key = desc_key(x)
    lane = torch.arange(x.shape[0], dtype=torch.int32, device=x.device)
    _, idx = torch.sort(spread_invalid(key, x, lane))
    return key[idx[:k]], idx[:k]


def arm_topk(x, k: int):
    """C: ``torch.topk`` on the scores; keys of its values."""
    vals, idx = torch.topk(x, k)
    return desc_key(vals), idx


def arm_twopass(x, k: int):
    """D: the k-th key by a binary search over the key's 32 bits (as an
    unsigned value: int32 key + 2^31), counting the lanes below each
    candidate; then the survivors (key <= the k-th) alone, sorted."""
    key = desc_key(x)
    u = key.to(torch.int64) - (-(1 << 31))
    lo = 0
    for shift in range(31, -1, -1):
        cand = lo | (1 << shift)
        if int((u < cand).sum()) < k:
            lo = cand
    tau = lo + (-(1 << 31))           # the k-th key, int32 form
    surv = torch.nonzero(key <= tau).flatten()
    sk, order = torch.sort(key[surv])
    return sk[:k], surv[order[:k]]


ARMS = (("A sort", arm_sort), ("B spread", arm_spread),
        ("C topk", arm_topk), ("D twopass", arm_twopass))


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES).parse_args(argv)
    device = resolve_device(args.device)
    rows = Rows("ab_select", device, lanes=1 << args.log2n, k=args.k)
    x = torch.as_tensor(make_data(args.log2n), device=device)
    key = desc_key(x)
    outs, times = {}, {}
    for name, arm in ARMS:
        times[name] = ms(lambda: arm(x, args.k), device, args.iters)
        outs[name] = arm(x, args.k)
    kth = same_keys(key, outs, args.k, "ab_select: the arms")
    for name, _ in ARMS:
        rows.emit(row="arm", arm=name, ms=times[name], kth_key=kth)
    return rows.rows


if __name__ == "__main__":
    main()
