"""What a primitive costs on the card, in ms an op.

Counterpart of ``experiments/amort2.py``: each primitive at ``K`` (2^20)
lanes, the gathers over a ``TABLE`` (2^23)-entry table, through the port's
``ops/segment.py`` where the JAX probe used its ``ops/segment.py``:

``noop`` (a Python loop step), ``gather``, ``gather_sum``, ``dynslice`` (a
slice at a data-dependent start, summed), ``cumsum``, ``cummax``, ``sort1``
(one int32 key), ``sort2`` (the key and a payload through the
permutation), ``segscan`` (``run_boundaries`` + ``segment_run_totals``),
``topk`` (2^15 of the float32 lanes), ``sortmerge`` (a sort of the negated
float32 lanes with a payload).

Each op's result on the run's device equals the same op on the CPU.  Each
is timed with CUDA events over ``--iters`` (16) calls after a warm one.
Dropped from the JAX probe: the in-jit ``lax.scan`` over the calls with
the runtime zero ``D(c)`` added to the indices (the relay's amortization),
and its read of ``/tmp/bench18.npz``, which it never used.

    python -m linkpred_tpu_torch.experiments.amort2 [OP ...] [--k 1048576]
        [--table 8388608] [--iters 16] [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import Rows, ms, parser

__all__ = ["SIZES", "OPS", "inputs", "op", "main"]

SIZES = {"K": (1 << 20, int, False), "TABLE": (1 << 23, int, False),
         "ITERS": (16, int, False)}

OPS = ("noop", "gather", "gather_sum", "dynslice", "cumsum", "cummax",
       "sort1", "sort2", "segscan", "topk", "sortmerge")


def inputs(k: int, table: int, device) -> dict:
    """The probe's operands from seed 0 on ``device``: ``big`` (0..table-1),
    ``idx`` (k indices into it), ``pk`` (k keys below 2^30), ones."""
    rng = np.random.default_rng(0)
    host = dict(big=np.arange(table, dtype=np.int32),
                idx=rng.integers(0, table, k, dtype=np.int32),
                pk=rng.integers(0, 1 << 30, k, dtype=np.int32),
                ones=np.ones(k, dtype=np.int32))
    return {name: torch.as_tensor(a, device=device)
            for name, a in host.items()}


def op(name: str, x: dict):
    """One call of primitive ``name`` on the operands ``x``."""
    from ..ops.segment import cummax, run_boundaries, segment_run_totals

    big, idx, pk, ones = x["big"], x["idx"], x["pk"], x["ones"]
    if name == "noop":
        return None
    if name == "gather":
        return big[idx.to(torch.int64)]
    if name == "gather_sum":
        return big[idx.to(torch.int64)].sum()
    if name == "dynslice":
        start = int(idx[0]) % max(big.shape[0] - idx.shape[0], 1)
        return big[start: start + idx.shape[0]].sum()
    if name == "cumsum":
        return torch.cumsum(ones, 0)
    if name == "cummax":
        return cummax(idx)
    if name == "sort1":
        return torch.sort(pk).values
    if name == "sort2":
        sk, perm = torch.sort(pk)
        return sk, ones[perm]
    if name == "segscan":
        s, _ = run_boundaries(pk, pk)
        return segment_run_totals(s, ones)
    if name == "topk":
        return torch.topk(idx.to(torch.float32), min(1 << 15,
                                                     idx.shape[0])).values
    if name == "sortmerge":
        sk, perm = torch.sort(-idx.to(torch.float32))
        return sk, ones[perm]
    raise ValueError(f"amort2: no primitive {name}")


def same(a, b) -> bool:
    """Results equal, tensor by tensor (None for the noop)."""
    if a is None or b is None:
        return a is b
    if torch.is_tensor(a):
        return torch.equal(a.cpu(), b.cpu())
    return all(same(x, y) for x, y in zip(a, b))


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    ap = parser(__doc__, SIZES)
    ap.add_argument("ops", nargs="*", default=list(OPS),
                    help=f"primitives to time (default all: {OPS})")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rows = Rows("amort2", device, k=args.k, table=args.table)
    x = inputs(args.k, args.table, device)
    cpu = {name: t.cpu() for name, t in x.items()}
    for name in args.ops:
        if not same(op(name, x), op(name, cpu)):
            raise AssertionError(f"amort2: {name} on {device} differs from "
                                 "the CPU")
        rows.emit(row="op", op=name,
                  ms_op=ms(lambda: op(name, x), device, args.iters))
    return rows.rows


if __name__ == "__main__":
    main()
