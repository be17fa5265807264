"""A/B: merging a tile's scores into a top-k carry by a float sort against
an encoded-key sort.

Counterpart of ``experiments/ab_merge.py``: a cap-2^20 tile of Jaccard-like
scores (40% valid: ``num / den`` with ``den`` in [1, 60); the rest -inf)
with ``u = lane``, ``v = lane + 1``, merged ``ROUNDS`` (16) times into a
4096-slot carry (``K``), each round's winners the next round's carry:

* ``raw``: a stable sort of the negated float scores, the (u, v) payloads
  gathered through it;
* ``encoded``: a stable sort of the port's int32 descending key
  (``topk.desc_score_key``, the -inf lanes spread by lane), the payloads
  gathered through it.

Both arms keep the same winners (scores, u, v), round by round.  Timed with
CUDA events, the mean ms a round over ``--repeat`` (3) calls of all rounds
after a warm one.  Dropped from the JAX probe: the in-jit ``lax.scan`` over
the rounds with the runtime zero ``(c >> 31)`` (the relay's
amortization).

    python -m linkpred_tpu_torch.experiments.ab_merge [--cap 1048576]
        [--k 4096] [--rounds 16] [--repeat 3] [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import Rows, ms, parser

__all__ = ["SIZES", "make_tile", "merge_raw", "merge_encoded", "rounds",
           "main"]

SIZES = {"CAP": (1 << 20, int, False), "K": (4096, int, False),
         "ROUNDS": (16, int, False), "REPEAT": (3, int, False)}


def make_tile(cap: int) -> np.ndarray:
    """The JAX probe's scores from seed 0: 40% of the lanes ``num / den``
    (``den`` in [1, 60), ``num`` in [1, den]), the rest -inf."""
    rng = np.random.default_rng(0)
    nv = int(0.4 * cap)
    den = rng.integers(1, 60, nv)
    num = rng.integers(1, den + 1)
    scores = np.full(cap, -np.inf, np.float32)
    idx = rng.choice(cap, nv, replace=False)
    scores[idx] = (num / den).astype(np.float32)
    return scores


def merge_raw(cs, cu, cv, s, u, v, k: int):
    """The carry and the tile concatenated, sorted by the negated score
    (stable), the first ``k`` kept."""
    s2, u2, v2 = torch.cat([cs, s]), torch.cat([cu, u]), torch.cat([cv, v])
    _, perm = torch.sort(-s2, stable=True)
    top = perm[:k]
    return s2[top], u2[top], v2[top]


def merge_encoded(cs, cu, cv, s, u, v, k: int):
    """The same merge on the int32 descending key, -inf lanes spread."""
    from ..ops.topk import desc_score_key, spread_invalid

    s2, u2, v2 = torch.cat([cs, s]), torch.cat([cu, u]), torch.cat([cv, v])
    lane = torch.arange(s2.shape[0], dtype=torch.int32, device=s2.device)
    _, perm = torch.sort(spread_invalid(desc_score_key(s2), s2, lane),
                         stable=True)
    top = perm[:k]
    return s2[top], u2[top], v2[top]


def rounds(merge, tile, k: int, n_rounds: int) -> list:
    """``n_rounds`` merges of ``tile`` (s, u, v) into a carry that starts
    empty; returns each round's carry."""
    s, u, v = tile
    carry = (torch.full((k,), float("-inf"), device=s.device),
             torch.zeros(k, dtype=torch.int32, device=s.device),
             torch.zeros(k, dtype=torch.int32, device=s.device))
    out = []
    for _ in range(n_rounds):
        carry = merge(*carry, s, u, v, k)
        out.append(carry)
    return out


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES).parse_args(argv)
    device = resolve_device(args.device)
    rows = Rows("ab_merge", device, cap=args.cap, k=args.k,
                rounds=args.rounds)
    s = torch.as_tensor(make_tile(args.cap), device=device)
    u = torch.arange(args.cap, dtype=torch.int32, device=device)
    tile = (s, u, u + 1)
    got = {name: rounds(fn, tile, args.k, args.rounds)
           for name, fn in (("raw", merge_raw), ("encoded", merge_encoded))}
    for i, (a, b) in enumerate(zip(got["raw"], got["encoded"])):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"ab_merge: the winners differ in round {i}")
    best = float(s.max())
    if float(got["raw"][-1][0][0]) != best:
        raise AssertionError("ab_merge: the top winner is not the tile's "
                             "best score")
    for name, fn in (("raw", merge_raw), ("encoded", merge_encoded)):
        t = ms(lambda: rounds(fn, tile, args.k, args.rounds), device,
               args.repeat)
        rows.emit(row="arm", arm=name, ms_round=t / args.rounds)
    return rows.rows


if __name__ == "__main__":
    main()
