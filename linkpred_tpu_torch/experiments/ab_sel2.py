"""A/B: the final selection at the production shape, ``[T, 1, CAP]`` tile
scores.

Counterpart of ``experiments/ab_sel2.py``: ``[32, 1, 2^20]`` scores (35%
valid, Jaccard-like ties), random ``us``/``vs``, k = 2^19.  The arms:

* A ``sort2``: the key and its lane by one sort, then three gathers
  (``scoring._argselect_sort``, the engine's sort arm);
* B ``sort1``: the keys alone sorted for the k-th key, then the lanes above
  it and the first ties in lane order extracted by ``nonzero``, then the
  gathers;
* C ``topk``: ``torch.topk`` on the flat scores, then the gathers.

The scores are equal as multisets, and the ``(u, v)`` of the lanes above
the k-th score are the same.  Each arm is timed with CUDA events over
``--repeat`` (3) calls after a warm one.  Not ported: the JAX probe's arm D,
``lax.approx_max_k``, which has no PyTorch counterpart and is not exact.
Dropped from the JAX probe: ``sync`` (the relay's fetch).

    python -m linkpred_tpu_torch.experiments.ab_sel2 [--t 32]
        [--cap 1048576] [--k 524288] [--repeat 3] [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import Rows, ms, parser

__all__ = ["SIZES", "make_data", "arm_sort2", "arm_sort1", "arm_topk",
           "ARMS", "same_winners", "main"]

SIZES = {"T": (32, int, False), "CAP": (1 << 20, int, False),
         "K": (1 << 19, int, False), "REPEAT": (3, int, False)}


def make_data(t: int, cap: int):
    """The JAX probe's draw from seed 0: scores ``[t, 1, cap]`` (35%
    valid: half of them 1/1..1/63, repeated, the rest uniform; the others
    -inf), then ``us`` and ``vs`` ``[t, cap]`` below 2^18; numpy."""
    total = t * cap
    rng = np.random.default_rng(0)
    scores = np.full(total, -np.inf, np.float32)
    nv = int(total * 0.35)
    pos = rng.choice(total, nv, replace=False)
    half = np.repeat((1.0 / np.arange(1, 64)).astype(np.float32),
                     nv // 64 + 1)[: nv // 2]
    vals = np.concatenate([half, rng.random(nv - half.shape[0],
                                            dtype=np.float32)])
    rng.shuffle(vals)
    scores[pos] = vals
    us = rng.integers(0, 1 << 18, (t, cap), dtype=np.int32)
    vs = rng.integers(0, 1 << 18, (t, cap), dtype=np.int32)
    return scores.reshape(t, 1, cap), us, vs


def arm_sort2(scores, us, vs, k: int):
    """A: ``(scores, u, v, lanes)`` of the top k by one key sort."""
    from ..ops.topk import desc_score_key
    from ..predict.scoring import _argselect_sort

    flat = scores[:, 0, :].reshape(-1)
    _, top = _argselect_sort(desc_score_key(flat), k)
    return flat[top], us.reshape(-1)[top], vs.reshape(-1)[top], top


def arm_sort1(scores, us, vs, k: int):
    """B: the k-th key from a sort of the keys alone; the lanes strictly
    above it, then as many ties as fill k, in lane order."""
    from ..ops.topk import desc_score_key

    flat = scores[:, 0, :].reshape(-1)
    key = desc_score_key(flat)
    tau = torch.sort(key).values[k - 1]
    strict = key < tau
    ties = key == tau
    take = k - int(strict.sum())
    tie_rank = torch.cumsum(ties.to(torch.int32), 0) - 1
    top = torch.nonzero(strict | (ties & (tie_rank < take))).flatten()
    return flat[top], us.reshape(-1)[top], vs.reshape(-1)[top], top


def arm_topk(scores, us, vs, k: int):
    """C: ``torch.topk`` on the flat scores."""
    flat = scores[:, 0, :].reshape(-1)
    vals, top = torch.topk(flat, k)
    return vals, us.reshape(-1)[top], vs.reshape(-1)[top], top


ARMS = (("A sort2", arm_sort2), ("B sort1", arm_sort1),
        ("C topk", arm_topk))


def same_winners(outs: dict, where: str) -> None:
    """The arms' scores are one multiset; the lanes above the k-th score,
    and their (u, v), are the same."""
    first = None
    for name, (s, u, v, lanes) in outs.items():
        s, u, v, lanes = (a.cpu().numpy() for a in (s, u, v, lanes))
        cut = np.sort(s)[0]
        above = s > cut
        got = (np.sort(s), sorted(zip(lanes[above].tolist(),
                                      u[above].tolist(), v[above].tolist())))
        if first is None:
            first = (name, got)
        elif not (np.array_equal(got[0], first[1][0])
                  and got[1] == first[1][1]):
            raise AssertionError(f"{where}: arms {name} and {first[0]} "
                                 "disagree")


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES).parse_args(argv)
    device = resolve_device(args.device)
    rows = Rows("ab_sel2", device, shape=[args.t, 1, args.cap], k=args.k)
    data = [torch.as_tensor(a, device=device)
            for a in make_data(args.t, args.cap)]
    outs, times = {}, {}
    for name, arm in ARMS:
        times[name] = ms(lambda: arm(*data, args.k), device, args.repeat)
        outs[name] = arm(*data, args.k)
    same_winners(outs, "ab_sel2")
    for name, _ in ARMS:
        rows.emit(row="arm", arm=name, ms=times[name])
    rows.emit(row="left_out", arm="D approx",
              reason="lax.approx_max_k has no PyTorch counterpart and is "
              "not exact")
    return rows.rows


if __name__ == "__main__":
    main()
