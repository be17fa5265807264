"""A/B: what a ``torch.sort`` costs by key width, stability and payloads.

Counterpart of ``experiments/ab_width2.py`` at ``2^LANES_LOG2`` (2^21)
lanes, the JAX probe's operands drawn in its order (``mk``: a 21-bit key,
a 21-bit and two 31-bit int32 payloads, a float32 payload).  A payload
rides the sort as the engine's do: gathered through the sort's
permutation.  The rows:

* ``i32-stable`` / ``i32-unstable``: the 21-bit int32 key alone;
* ``i32+1``, ``i32+2``, ``i32+3``: stable, with one to three int32
  payloads (the JAX probe's scan-2x32, -3x32, -4x32);
* ``i32+2+f32``: stable, two int32 payloads and the float32 one
  (scan-3x32+f);
* ``i64``: the engine's composite key ``key << 32 | payload`` with one
  int32 payload (k64-2op), and ``i64-stable``, as the engine sorts it.

Each row is the mean ms a sort over ``ITERS`` (16) calls after a warm one,
``REPEAT`` (3) times, the least kept; the int64/int32 ratio is printed.
Every row's sorted keys are equal (the int64 key's high words), and each
payload follows its key.  Dropped from the JAX probe: the in-jit
``lax.scan`` of ``ITERS`` sorts with the key XOR-ed anew each iteration
and the ``(t_n - t_1) / (n - 1)`` difference (the relay's amortization);
the x64 switch (PyTorch has int64 natively).

    python -m linkpred_tpu_torch.experiments.ab_width2 [--lanes-log2 21]
        [--iters 16] [--repeat 3] [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import Rows, ms, parser

__all__ = ["SIZES", "operands", "sort_row", "ROWS", "check_rows", "main"]

SIZES = {"LANES_LOG2": (21, int, True), "ITERS": (16, int, True),
         "REPEAT": (3, int, True)}


def operands(n: int, seed: int = 0) -> dict:
    """The JAX probe's operands from seed 0, in its draw order (``k32``,
    ``a32``, ``b32``, ``c32``, ``f32``), numpy."""
    rng = np.random.default_rng(seed)

    def mk(dtype, bits):
        return rng.integers(0, 1 << bits, n, dtype=np.int64).astype(dtype)

    k32 = mk(np.int32, 21)
    a32 = mk(np.int32, 21)
    b32 = mk(np.int32, 31)
    c32 = mk(np.int32, 31)
    f32 = rng.random(n, dtype=np.float32)
    return dict(k32=k32, a32=a32, b32=b32, c32=c32, f32=f32)


def sort_row(key, payloads, stable: bool):
    """Sort ``key`` and gather each payload by the permutation."""
    sk, perm = torch.sort(key, stable=stable)
    return (sk, *(p[perm] for p in payloads))


def composite(k32, a32):
    """The engine's int64 key: ``k32 << 32 | a32`` (both non-negative)."""
    return (k32.to(torch.int64) << 32) | a32.to(torch.int64)


# (row, key, payload names, stable)
ROWS = (
    ("i32-stable", "k32", (), True),
    ("i32-unstable", "k32", (), False),
    ("i32+1", "k32", ("a32",), True),
    ("i32+2", "k32", ("a32", "b32"), True),
    ("i32+3", "k32", ("a32", "b32", "c32"), True),
    ("i32+2+f32", "k32", ("a32", "b32", "f32"), True),
    ("i64", "k64", ("b32",), False),
    ("i64-stable", "k64", ("b32",), True),
)


def run_row(ops: dict, row) -> tuple:
    """One row's sort on the tensors ``ops``."""
    _, key, pays, stable = row
    k = composite(ops["k32"], ops["a32"]) if key == "k64" else ops[key]
    return sort_row(k, [ops[p] for p in pays], stable)


def check_rows(ops: dict, outs: dict) -> None:
    """Every row's sorted key (an int64 key's high word) is the sorted
    21-bit key; each payload, looked up by its lane, follows its key: the
    stable rows equal a stable numpy argsort, and the unstable ones keep
    each (key, payload) pair."""
    host = {n: t.cpu().numpy() for n, t in ops.items()}
    order = np.argsort(host["k32"], kind="stable")
    want = host["k32"][order]
    for name, key, pays, stable in ROWS:
        out = [t.cpu().numpy() for t in outs[name]]
        sk = (out[0] >> 32).astype(np.int32) if key == "k64" else out[0]
        if not np.array_equal(sk, want):
            raise AssertionError(f"ab_width2 {name}: keys not sorted")
        for p, got in zip(pays, out[1:]):
            if stable and key == "k32":
                ok = np.array_equal(got, host[p][order])
            else:
                # an unstable sort of key alone may permute ties; the
                # composite key's order is unique up to equal (k, a) pairs
                w = np.lexsort((host[p], host["k32"]))
                ok = np.array_equal(got[np.lexsort((got, sk))], host[p][w])
            if not ok:
                raise AssertionError(f"ab_width2 {name}: payload {p} does "
                                     "not follow its key")


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES).parse_args(argv)
    device = resolve_device(args.device)
    n = 1 << args.lanes_log2
    rows = Rows("ab_width2", device, lanes=n)
    ops = {k: torch.as_tensor(v, device=device)
           for k, v in operands(n).items()}
    outs = {row[0]: run_row(ops, row) for row in ROWS}
    check_rows(ops, outs)
    del outs
    times = {}
    for row in ROWS:
        times[row[0]] = min(ms(lambda: run_row(ops, row), device, args.iters)
                            for _ in range(args.repeat))
        rows.emit(row="sort", sort=row[0], ms=times[row[0]],
                  payloads=len(row[2]), stable=row[3])
    rows.emit(row="ratio", i64_over_i32_unstable=times["i64"]
              / times["i32-unstable"], i64_over_i32_plus1=times["i64"]
              / times["i32+1"])
    return rows.rows


if __name__ == "__main__":
    main()
