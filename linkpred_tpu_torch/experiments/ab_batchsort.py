"""A/B: one batched ``[T, cap]`` sort against T sequential sorts, and the
single sort's scaling with its length.

Counterpart of ``experiments/ab_batchsort.py``: the w key (19 bits) with
the u (20 bits) and d (31 bits) payloads, stable, as tiles of ``[32,
2^20]``; the batched arm is one ``torch.sort(dim=-1)`` and two gathers
along the rows, the sequential arm a Python loop of 32 one-row sorts (the
engine's tile loop); then one row at 2^20, 2^21 and 2^22 lanes.  The
batched and sequential outputs are equal, and equal a stable numpy
argsort.  Timed with CUDA events over ``--repeat`` (3) calls after a warm
one.  Dropped from the JAX probe: ``sync`` (the relay's fetch) and the
``lax.scan`` of the sequential arm (the port's tile loop is Python).

    python -m linkpred_tpu_torch.experiments.ab_batchsort [--t 32]
        [--cap 1048576] [--singles 20,21,22] [--repeat 3] [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import Rows, ms, parser

__all__ = ["SIZES", "make_tiles", "batched", "sequential", "single",
           "check", "main"]

SIZES = {"T": (32, int, False), "CAP": (1 << 20, int, False),
         "REPEAT": (3, int, False)}


def make_tiles(rng, shape):
    """``(w, u, d)`` int32 arrays of ``shape``: w below 2^19, u below 2^20,
    d below 2^31, in the JAX probe's draw order."""
    w = rng.integers(0, 1 << 19, shape, dtype=np.int32)
    u = rng.integers(0, 1 << 20, shape, dtype=np.int32)
    d = rng.integers(0, 1 << 31, shape, dtype=np.int32)
    return w, u, d


def batched(w, u, d):
    """One stable sort of every row, the payloads gathered along it."""
    kw, perm = torch.sort(w, dim=-1, stable=True)
    return kw, torch.gather(u, -1, perm), torch.gather(d, -1, perm)


def sequential(w, u, d):
    """The rows one by one: a stable sort and two gathers each."""
    outs = [single(w[t], u[t], d[t]) for t in range(w.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def single(w, u, d):
    """One stable sort of a row and its two gathers."""
    kw, perm = torch.sort(w, stable=True)
    return kw, u[perm], d[perm]


def check(w, u, d, out, where: str) -> None:
    """``out`` is the stable sort of every row of ``(w, u, d)``."""
    w, u, d = (a.cpu().numpy() for a in (w, u, d))
    order = np.argsort(w, axis=-1, kind="stable")
    for a, got in zip((w, u, d), out):
        if not np.array_equal(got.cpu().numpy(),
                              np.take_along_axis(a, order, -1)):
            raise AssertionError(f"{where}: not the stable sort")


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    ap = parser(__doc__, SIZES)
    ap.add_argument("--singles", default="20,21,22",
                    help="log2 lengths of the single sorts")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = Rows("ab_batchsort", device, shape=[args.t, args.cap])
    rng = np.random.default_rng(0)
    tiles = [torch.as_tensor(a, device=device)
             for a in make_tiles(rng, (args.t, args.cap))]
    a, b = batched(*tiles), sequential(*tiles)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError("ab_batchsort: batched and sequential differ")
    check(*tiles, a, "ab_batchsort batched")
    del a, b
    rows.emit(row="arm", arm="batched", ms=ms(lambda: batched(*tiles),
                                              device, args.repeat))
    rows.emit(row="arm", arm="sequential",
              ms=ms(lambda: sequential(*tiles), device, args.repeat))
    del tiles
    for lg in map(int, args.singles.split(",")):
        one = [torch.as_tensor(a, device=device)
               for a in make_tiles(rng, 1 << lg)]
        check(*one, single(*one), f"ab_batchsort single 2^{lg}")
        rows.emit(row="single", log2n=lg,
                  ms=ms(lambda: single(*one), device, args.repeat))
    return rows.rows


if __name__ == "__main__":
    main()
