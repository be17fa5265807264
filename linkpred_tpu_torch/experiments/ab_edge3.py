"""A/B: the edge tile's rebuild in three layouts of the plan's edge rows,
and the engine's own.

Counterpart of ``experiments/ab_edge3.py``: ``T`` (8) tiles of ``CAP``
(2^21) slots over random edge rows (average work ``AVG_WORK``, 32; 2%
killer rows) of a CSR over ``N`` (2^22) vertices with degrees in [1,
``DEG_MAX``).  Each tile maps its slots to rows, gathers each slot's
candidate w from ``indices``, its source and flag, the two degrees, then
sorts the engine's int64 key ``w << 32 | (u << 1 | real)`` and reduces the
runs to the JAX probe's checksum (run length + degrees + key).  The arms:

* A: the 5-array layout (``fe_src``, ``fe_mid``, ``fe_work``, ``fe_skip``,
  ``fe_cnt``), 8 gathers;
* B: the 3-array layout (``fe_adr = offsets[mid] + skip``, ``fe_upay = src
  << 1 | real``, ``fe_work``), 5 gathers;
* C: B with ``fe_adr - eprefix`` folded into one gather;
* D: the engine's own tile (``scoring._edge_slots``: B's rows with the
  killers stored as ``~src``, and PR 9's binary search of the tile's rows
  in place of the scatter-max and running max of A-C).

A, B and C take the JAX probe's slot map (a scatter-max of the rows' first
slots and a running max).  All four arms give the same lanes and checksums.
The slot maps alone are timed too.

The degree range is an argument: the default [1, 2^9) makes Σdeg ≈ 2^30, a
real ``indices`` table of that size (drawn on the device).  A draw whose sum
reaches 2^31 raises (the plan's own bound).  The JAX probe draws [1, 2^12)
over 2^22 vertices and takes ``np.cumsum`` into int32 ``offsets``: its
seed-0 sum, 8,588,792,722, wraps to -1,141,870, so its table holds one
entry, every candidate gather clips to it, and its v5e figures
(``experiments/ab_edge3.py:145-150``) gather from that one entry.
Each arm's pass over the T tiles is timed with CUDA events over
``--repeat`` (3) calls after a warm one.  Dropped from the JAX probe: the
jitted ``lax.scan`` over the tiles (the engine's tile loop is Python).

    python -m linkpred_tpu_torch.experiments.ab_edge3 [--cap 2097152]
        [--t 8] [--n 4194304] [--avg-work 32] [--deg-max 512] [--repeat 3]
        [--device cpu]
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device
from ._probe import Rows, ms, parser

__all__ = ["SIZES", "MAX_EDGES", "make_rows", "scatter_slot_map",
           "lanes_a", "lanes_b", "lanes_c", "lanes_d", "checksum", "ARMS",
           "main"]

SIZES = {"CAP": (1 << 21, int, False), "T": (8, int, False),
         "N": (1 << 22, int, False), "AVG_WORK": (32, int, False),
         "DEG_MAX": (1 << 9, int, False), "REPEAT": (3, int, False)}

# The plan's bound on the CSR's edges: offsets are int32.
MAX_EDGES = 1 << 31


def make_rows(cap: int, t: int, n: int, avg_work: int, deg_max: int,
              device) -> dict:
    """The JAX probe's rows from seed 0 in its draw order, every layout of
    them, ``indices`` and the tile bounds; raises ``ValueError`` when the
    degrees' sum reaches 2^31."""
    rng = np.random.default_rng(0)
    m1 = t * cap // avg_work
    fe_work = rng.integers(1, 2 * avg_work, m1).astype(np.int32)
    fe_src = rng.integers(0, n, m1, dtype=np.int32)
    fe_mid = rng.integers(0, n, m1, dtype=np.int32)
    fe_skip = rng.integers(0, 4, m1).astype(np.int32)
    fe_cnt = np.where(rng.random(m1) < 0.02, -(1 << 30), 1).astype(np.int32)
    degrees = rng.integers(1, deg_max, n, dtype=np.int32)
    m = int(degrees.sum(dtype=np.int64))
    if m >= MAX_EDGES:
        raise ValueError(f"ab_edge3: degrees in [1, {deg_max}) over {n} "
                         f"vertices sum to {m}, not under 2^31: the int32 "
                         "offsets would wrap")
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(degrees, out=offsets[1:])
    prefix = np.cumsum(fe_work) - fe_work
    ts = np.searchsorted(prefix, np.arange(t + 1) * cap).astype(np.int64)
    ts[-1] = m1
    real = fe_cnt > 0
    fe_adr = (offsets[fe_mid].astype(np.int64) + fe_skip).astype(np.int32)
    fe_upay = ((fe_src.astype(np.int64) << 1) | real).astype(np.int32)
    fe_usrc = np.where(real, fe_src, ~fe_src).astype(np.int32)
    rows = dict(fe_work=fe_work, fe_src=fe_src, fe_mid=fe_mid,
                fe_skip=fe_skip, fe_cnt=fe_cnt, fe_adr=fe_adr,
                fe_upay=fe_upay, fe_usrc=fe_usrc)
    # every tile's window reads cap rows (the plan pads the same way)
    out = {k: torch.as_tensor(np.concatenate([a, np.zeros(cap, a.dtype)]),
                              device=device) for k, a in rows.items()}
    gen = torch.Generator(device=device).manual_seed(0)
    out.update(offsets=torch.as_tensor(offsets, device=device),
               degrees=torch.as_tensor(degrees, device=device),
               indices=torch.randint(0, n, (max(m, 1),), generator=gen,
                                     dtype=torch.int32, device=device),
               bounds=[(int(ts[i]), int(ts[i + 1])) for i in range(t)])
    return out


def scatter_slot_map(fe_work, t0: int, t1: int, cap: int):
    """The JAX probe's slot map: each row with work writes its id at its
    first slot (a scatter-max), a running max fills the lanes; returns
    ``(win, eloc, eprefix, total)``."""
    iota = torch.arange(cap, dtype=torch.int32, device=fe_work.device)
    ework = torch.where(iota < (t1 - t0), fe_work[t0: t0 + cap], 0)
    incl = torch.cumsum(ework, 0, dtype=torch.int32)
    eprefix = incl - ework
    # rows past the cap lanes drop, as the JAX scatter's mode="drop"
    pos = torch.where((ework > 0) & (eprefix < cap), eprefix, cap) \
        .to(torch.int64)
    starts = torch.zeros(cap + 1, dtype=torch.int32, device=fe_work.device)
    starts.scatter_reduce_(0, pos, iota, reduce="amax")
    eloc = torch.cummax(starts[:cap], 0).values.to(torch.int64)
    return slice(t0, t0 + cap), eloc, eprefix, incl[-1:]


def _finish(s, iota, total, w, upay, u, w_bits):
    n = s["degrees"].shape[0]
    key = torch.where(iota < total, w, (1 << w_bits) | (iota & 1023))
    udeg = s["degrees"][u.clamp(0, n - 1).to(torch.int64)]
    wdeg = s["degrees"][w.clamp(0, n - 1).to(torch.int64)]
    return key, upay, udeg, wdeg


def _gather_w(s, adr):
    m = s["indices"].shape[0]
    return s["indices"][adr.clamp(0, m - 1).to(torch.int64)]


def lanes_a(s: dict, t0: int, t1: int, cap: int, w_bits: int):
    """A: the 5-array layout; ``(key, upay, udeg, wdeg)`` before the
    sort."""
    win, eloc, eprefix, total = scatter_slot_map(s["fe_work"], t0, t1, cap)
    iota = torch.arange(cap, dtype=torch.int32, device=eloc.device)
    u = s["fe_src"][win][eloc]
    mid = s["fe_mid"][win][eloc].to(torch.int64)
    j = iota - eprefix[eloc]
    w = _gather_w(s, s["offsets"][mid] + s["fe_skip"][win][eloc] + j)
    real = s["fe_cnt"][win][eloc] > 0
    return _finish(s, iota, total, w, (u << 1) | real.to(torch.int32), u,
                   w_bits)


def lanes_b(s: dict, t0: int, t1: int, cap: int, w_bits: int):
    """B: the 3-array layout."""
    win, eloc, eprefix, total = scatter_slot_map(s["fe_work"], t0, t1, cap)
    iota = torch.arange(cap, dtype=torch.int32, device=eloc.device)
    j = iota - eprefix[eloc]
    w = _gather_w(s, s["fe_adr"][win][eloc] + j)
    upay = s["fe_upay"][win][eloc]
    return _finish(s, iota, total, w, upay, upay >> 1, w_bits)


def lanes_c(s: dict, t0: int, t1: int, cap: int, w_bits: int):
    """C: B with the base ``fe_adr - eprefix`` folded into one gather."""
    win, eloc, eprefix, total = scatter_slot_map(s["fe_work"], t0, t1, cap)
    iota = torch.arange(cap, dtype=torch.int32, device=eloc.device)
    w = _gather_w(s, (s["fe_adr"][win] - eprefix)[eloc] + iota)
    upay = s["fe_upay"][win][eloc]
    return _finish(s, iota, total, w, upay, upay >> 1, w_bits)


def lanes_d(s: dict, t0: int, t1: int, cap: int, w_bits: int):
    """D: the engine's ``scoring._edge_slots`` on the plan's layout
    (``fe_work``, ``fe_adr``, ``fe_usrc``)."""
    from ..predict.scoring import _edge_slots

    iota, svalid, w, u, real, _ = _edge_slots(
        s["indices"], (s["fe_work"], s["fe_adr"], s["fe_usrc"], None), t0,
        t1, cap=cap, weighted=False)
    total = svalid.sum(dtype=torch.int32)
    return _finish(s, iota, total, w, (u << 1) | real.to(torch.int32), u,
                   w_bits)


def checksum(key, upay, udeg, wdeg):
    """The JAX probe's reduce: sort (the engine's int64 key, stable; the
    degrees through the permutation), run lengths over (w, u), and the sum
    of run length + degrees + key over the lanes (int64)."""
    from ..ops.segment import cummax, run_boundaries

    k64, perm = torch.sort((key.to(torch.int64) << 32)
                           | (upay.to(torch.int64) & 0xFFFFFFFF),
                           stable=True)
    key = (k64 >> 32).to(torch.int32)
    src = (k64 & 0xFFFFFFFF).to(torch.int32) >> 1
    iota = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    is_start, _ = run_boundaries(key, src)
    cnt = iota - cummax(torch.where(is_start, iota, 0)) + 1
    return (cnt.to(torch.int64) + udeg[perm] + wdeg[perm] + key).sum()


ARMS = (("A", lanes_a), ("B", lanes_b), ("C", lanes_c), ("D", lanes_d))


def main(argv=None) -> list:
    """The probe on ``--device`` (the card by default; raises without
    one).  Returns its JSON rows, the card's line first."""
    args = parser(__doc__, SIZES).parse_args(argv)
    device = resolve_device(args.device)
    from ..predict.scoring import _slot_map

    cap = args.cap
    w_bits = max(1, (args.n - 1).bit_length())
    rows = Rows("ab_edge3", device, cap=cap, tiles=args.t, n=args.n,
                avg_work=args.avg_work, deg_max=args.deg_max)
    s = make_rows(cap, args.t, args.n, args.avg_work, args.deg_max, device)
    rows.emit(row="table", edges=s["indices"].shape[0],
              rows=s["fe_work"].shape[0] - cap)
    for t0, t1 in s["bounds"]:
        outs = {name: lanes(s, t0, t1, cap, w_bits) for name, lanes in ARMS}
        sums = {name: int(checksum(*o)) for name, o in outs.items()}
        for name, o in outs.items():
            if not all(torch.equal(x, y) for x, y in zip(o, outs["A"])) \
                    or sums[name] != sums["A"]:
                raise AssertionError(f"ab_edge3: arm {name} differs from "
                                     f"A on tile [{t0}, {t1})")
    for name, lanes in ARMS:
        total = ms(lambda: [checksum(*lanes(s, t0, t1, cap, w_bits))
                            for t0, t1 in s["bounds"]], device, args.repeat)
        rows.emit(row="arm", arm=name, ms=total, ms_tile=total / args.t)
    iota = torch.arange(cap, dtype=torch.int32, device=device)
    for name, fn in (("scatter", lambda a, b: scatter_slot_map(
            s["fe_work"], a, b, cap)),
            ("search", lambda a, b: _slot_map(s["fe_work"], a, b, iota))):
        total = ms(lambda: [fn(t0, t1) for t0, t1 in s["bounds"]], device,
                   args.repeat)
        rows.emit(row="slot_map", map=name, ms_tile=total / args.t)
    return rows.rows


if __name__ == "__main__":
    main()
