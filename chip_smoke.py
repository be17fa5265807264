#!/usr/bin/env python3
"""Smoke run of linkpred_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels, checks each against its plain PyTorch twin, checks the port end to
end against the CPU and a dense oracle (packed and edge-stream plans,
serving mode, the mega-hub host scorer), and drives the two main paths at
the bench protocol:

* LHub (phase 5): ``predict_links`` Jaccard at deg 64 on RMAT-19, the
  packed slot stream;
* IHub (phase 6): ``predict_links`` Jaccard at ``min_degree1=0`` on
  RMAT-18 with the card's own budgets: the edge stream (K1's killer branch,
  selection by segment) plus the packed hub sub-plan.

Phase 7 drives the JAX package's sort-feasibility probes as ported: P2 and
P3 (the bitonic network, ``bitonic.cu``) bit for bit against their plain
version at every size its launch planner treats differently (2^7, one
tile, two tiles, 2^18-2^21, 2^23), timed at 2^18-2^23 against
``torch.sort``, and the radix probe (``torch.sort``, K2 at ``ratio=1`` as
a 1-bit split, P4's dynamic stores in ``dynstore.cu``).

    python3 chip_smoke.py [scale]
    python3 chip_smoke.py --k1-ab OTHER_TREE

``scale`` (default 19) sets the R-MAT scale of the LHub path.  With
``--k1-ab`` it only times K1 at the main paths' shapes, in this tree and in
another checkout of the repository (such as the parent commit unpacked by
``git archive``), in turns.  Run from the
root of the repository.  Every phase prints its lines and any
failure raises, so the run exits non-zero.  With no CUDA device, or without
the package beside the script, it exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record, and the line before that the card's name and
power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# (name, source, the TPU kernel's pallas_call it replaces)
KERNELS = [
    ("fused_tail", "linkpred_tpu_torch/kernels/csrc/fused_tail.cu",
     "linkpred_tpu/ops/fused_tail.py:303"),
    ("pack_survivors", "linkpred_tpu_torch/kernels/csrc/compact.cu",
     "linkpred_tpu/ops/compact.py:170"),
    ("pallas_tail", "linkpred_tpu_torch/kernels/csrc/fused_tail.cu",
     "experiments/pallas_tail.py:178"),
    ("affine_smoke", "linkpred_tpu_torch/kernels/csrc/smoke.cu",
     "experiments/pallas_smoke.py:14"),
    # P2's row covers both of its pallas_calls: make_pallas_sort (:115) and
    # make_pallas_sort_kv (:95)
    ("make_pallas_sort", "linkpred_tpu_torch/kernels/csrc/bitonic.cu",
     "experiments/pallas_bitonic.py:115"),
    ("make_sort", "linkpred_tpu_torch/kernels/csrc/bitonic.cu",
     "experiments/pallas_bitonic2.py:104"),
    ("dynstore_run", "linkpred_tpu_torch/kernels/csrc/dynstore.cu",
     "experiments/radix_probe.py:118"),
]
# The slice of the port that redesigned each kernel (`redesigned_in` in
# its row of the record; the earlier design's times are in PERF.md
# section 6).  P1 is K1 at the prototype's configuration.
REDESIGNED_IN = {"pack_survivors": 4, "make_pallas_sort": 4,
                 "make_sort": 4, "fused_tail": 5, "pallas_tail": 5}
# The card's memory rate and float32 rate outside the tensor cores
# (H100 SXM data sheet): the roofline of every kernel here.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
UNWEIGHTED = ["common_neighbors", "jaccard_coefficient", "sorensen_index",
              "salton_cosine_similarity", "hub_promoted", "hub_depressed",
              "leicht_holme_nerman"]


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float = 0.0):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over their peak rate.
    Returns ``dict(bound_ms=..., bound_by="bytes" or "operations")``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def tail_bytes(cap: int, wide: bool, n_metrics: int, n_wt: int) -> int:
    """K1's bytes: hi, lo, the degree payload and the weights read once;
    one key per metric, ku and kw written once."""
    return cap * (8 + (8 if wide else 4) + 4 * n_wt + 4 * n_metrics + 8)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls (CUDA events
    on the current stream, after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# A sleep kernel of this many cycles (~50 ms at the H100's clocks) holds the
# stream while the host issues the calls that queued_ms times.
SLEEP_CYCLES = 100_000_000


def queued_ms(fn, iters: int = 20) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` calls queued
    behind a sleep kernel (after one warm-up call): the host issues every
    call while the card sleeps, so the events time the device work back to
    back, not the host's issue rate.  Fails if the issue outlasted half
    the sleep's nominal time at 2 GHz."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    issue_ms = (time.perf_counter() - t0) * 1e3
    end.synchronize()
    check(issue_ms < SLEEP_CYCLES / 2e9 * 1e3 / 2,
          f"queued_ms: issuing {iters} calls took {issue_ms:.1f} ms, too "
          "long for the sleep")
    return start.elapsed_time(end) / iters


# ------------------------------------------------------ phase 1: P5 smoke

def phase_p5(device, rng):
    """The toolchain smoke right after the build: P5's probe path (its
    kernel on the probe's (8, 128) shape), then the kernel against its plain
    version and 2x + 1 in numpy."""
    import torch
    from linkpred_tpu_torch.experiments import pallas_smoke as p5

    x = torch.arange(1024, dtype=torch.int32, device=device).reshape(8, 128)
    p5.LAUNCHES = 0
    out = p5.affine_smoke(x)
    launches = p5.LAUNCHES
    torch.cuda.synchronize()
    check(torch.equal(out, p5.affine_smoke_reference(x)), "P5: kernel != plain")
    check(np.array_equal(out.cpu().numpy(),
                         np.arange(1024, dtype=np.int32).reshape(8, 128) * 2
                         + 1), "P5: kernel != 2x + 1")
    big = rng.integers(-(1 << 31), 1 << 31, 1 << 20).astype(np.int32)
    got = p5.affine_smoke(torch.as_tensor(big, device=device)).cpu().numpy()
    check(np.array_equal(got, (big.astype(np.int64) * 2 + 1).astype(np.int32)),
          "P5: kernel != 2x + 1 (wrapping) on 2^20 lanes")
    ms = cuda_ms(lambda: p5.affine_smoke(x), 200)
    plain = cuda_ms(lambda: p5.affine_smoke_reference(x), 200)
    print(f"  P5 affine_smoke (8, 128) int32: kernel == plain == 2x + 1; "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms")
    return dict(launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain,
                **bound(2 * x.numel() * 4, 2 * x.numel()), library_ms=None)


# --------------------------------------------------------------- phase 2: K1

def tail_stream(rng, cap, w_bits, fill, run_len, wide, n_wt, kill=0.0):
    """A sorted tile as the main path hands it to K1: (w, u) pairs with
    run_len lanes per pair on average, degrees constant per pair, pad lanes
    after the real ones.  With ``kill`` the source payload is the edge
    stream's ``u << 1 | real``: each run's first lane is a killer, or all
    its lanes are, with probability ``kill`` each (killers sort first in
    their run); killer lanes weigh 0."""
    n_real = int(cap * fill)
    nv = 1 << w_bits
    npair = max(n_real // run_len, 1)
    pid = rng.integers(0, npair, n_real)
    dmax = (1 << 20) if wide else (1 << 16)
    cols = [rng.integers(0, nv, npair)[pid], rng.integers(0, nv, npair)[pid],
            rng.integers(1, dmax, npair)[pid],
            rng.integers(1, dmax, npair)[pid]]
    order = np.lexsort((cols[1], cols[0]))
    w, u, du, dw = (c[order] for c in cols)
    pad = cap - n_real
    lane = np.arange(n_real, cap)
    real = np.ones(cap, bool)
    if kill:
        new = np.r_[True, (np.diff(w) != 0) | (np.diff(u) != 0)]
        rid = np.cumsum(new) - 1
        kind = rng.choice(3, int(new.sum()), p=[1 - 2 * kill, kill, kill])
        real[np.flatnonzero(new)[kind == 1]] = False
        real[:n_real][kind[rid] == 2] = False
        real[n_real:] = rng.random(pad) < 0.5
    w = np.concatenate([w, nv | (lane & 1023)]).astype(np.int32)
    u = np.concatenate([u, np.zeros(pad, np.int64)])
    u = ((u << 1) | real if kill else u).astype(np.int32)
    du = np.concatenate([du, np.ones(pad, np.int64)])
    dw = np.concatenate([dw, np.ones(pad, np.int64)])
    if wide:
        degs = [du.astype(np.int32), dw.astype(np.int32)]
    else:
        degs = [((du << 16) | dw).astype(np.uint32).view(np.int32)]
    wts = []
    for _ in range(n_wt):
        x = (rng.random(cap) + 0.01).astype(np.float32)
        x[n_real:] = 0.0
        x[~real] = 0.0
        wts.append(x)
    return w, u, degs, wts


def k1_vs_twin(name, mets, args, kw):
    """K1 against its twin on the same card tensors; returns the keys and
    the largest absolute score difference of the weighted metrics.  Two
    calls of K1 must give the same bits."""
    import torch
    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.ops.topk import desc_key_score

    kk, ku, kv = ft.fused_tail(*args, **kw)
    again = ft.fused_tail(*args, **kw)
    rk, ru, rv = ft.fused_tail_reference(*args, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip((kk, ku, kv), again)),
          f"K1 {name}: two calls differ")
    check(torch.equal(ku, ru) and torch.equal(kv, rv), f"K1 {name}: ku/kw")
    max_err = 0.0
    for i, m in enumerate(mets):
        if not m.needs_weight:
            check(torch.equal(kk[i], rk[i]),
                  f"K1 {name}: {m.name} keys not bit-equal")
            continue
        a, b = desc_key_score(kk[i]), desc_key_score(rk[i])
        check(torch.equal(torch.isinf(a), torch.isinf(b)),
              f"K1 {name}: {m.name} valid lanes differ")
        fin = torch.isfinite(b)
        err = (a[fin] - b[fin]).abs()
        check(bool((err <= 1e-5 * b[fin].abs()).all()),
              f"K1 {name}: {m.name} beyond rtol 1e-5")
        max_err = max(max_err, float(err.max()) if err.numel() else 0.0)
    return kk, max_err


def k1_tile() -> int:
    """K1's tile: the lanes one CTA takes (``lp_fused_tail_tile_lanes``)."""
    from linkpred_tpu_torch.kernels import _build

    return _build.load().lp_fused_tail_tile_lanes()


def killed_runs_cross_tiles(hi, lo, keys, tile):
    """Check the killer premise on the card's result: some killed runs
    cross a K1 tile with their killer in the earlier tile, and no killed
    run scored.  Returns the count of such runs."""
    from linkpred_tpu_torch.ops.topk import desc_key_score

    h, l_ = hi.cpu().numpy(), lo.cpu().numpy()
    start = np.flatnonzero(np.r_[True, (np.diff(h) != 0)
                                 | (np.diff(l_ >> 1) != 0)])
    end = np.r_[start[1:], h.shape[0]] - 1
    dead = (l_[start] & 1) == 0
    check(bool(np.all(desc_key_score(keys[0]).cpu().numpy()[end[dead]]
                      == -np.inf)), "K1 killers: a killed run scored")
    return int((dead & (start // tile != end // tile)).sum())


def runs_stream(rng, lengths, n_wt, dead=None):
    """A sorted tile made of runs of the given lengths (distinct ascending
    (w, u) pairs), random deg16 pairs and weights.  With ``dead`` (run
    numbers) the payload is the edge stream's ``u << 1 | real`` and those
    runs start with a killer lane of weight 0."""
    pid = np.repeat(np.arange(len(lengths)), lengths)
    w, u = pid // 7, pid % 7 + 1
    cap = pid.shape[0]
    dpack = ((rng.integers(1, 1 << 16, cap) << 16)
             | rng.integers(1, 1 << 16, cap)).astype(np.uint32).view(np.int32)
    wts = [(rng.random(cap) + 0.01).astype(np.float32) for _ in range(n_wt)]
    if dead is not None:
        real = np.ones(cap, np.int64)
        real[np.r_[0, np.cumsum(lengths)[:-1]][list(dead)]] = 0
        for x in wts:
            x[real == 0] = 0.0
        u = (u << 1) | real
    return w.astype(np.int32), u.astype(np.int32), [dpack], wts


def k1_shapes(device, rng):
    """K1's inputs at the main paths' shapes (deg16, Jaccard): LHub
    RMAT-19's packed tiles (cap 2^20, clean) and IHub RMAT-18's edge tiles
    (cap 2^21, killers).  Yields (label, cap, args, kwargs)."""
    import torch
    from linkpred_tpu_torch.predict.metrics import METRICS

    for label, c, w_bits, kill in (("clean", 1 << 20, 19, 0.0),
                                   ("killers", 1 << 21, 18, 0.1)):
        w, u, degs, _ = tail_stream(rng, c, w_bits, 0.97, 3, False, 0, kill)
        args = (torch.as_tensor(w, device=device),
                torch.as_tensor(u, device=device),
                [torch.as_tensor(degs[0], device=device)], [], 0.0)
        kw = dict(metrics=[METRICS["jaccard_coefficient"]], w_bits=w_bits,
                  n=1 << w_bits, maxf2=0, killers=bool(kill))
        yield label, c, args, kw


def k1_time(args, kw, calls: int = 20):
    """K1's device time per call on these inputs: the profiler's device ms
    over ``calls`` calls (every kernel and memset, by name: events and ms
    per call), and CUDA events around calls queued behind a sleep kernel.
    Uses the ``linkpred_tpu_torch`` that imports first, so it times another
    tree's K1 as well (``--k1-ab``)."""
    from linkpred_tpu_torch.ops import fused_tail as ft

    got = device_profile(lambda: [ft.fused_tail(*args, **kw)
                                  for _ in range(calls)])
    return dict(profiler_ms=sum(ms for _, ms in got.values()) / calls,
                queued_ms=queued_ms(lambda: ft.fused_tail(*args, **kw),
                                    calls),
                per_call={n: (k / calls, ms / calls)
                          for n, (k, ms) in got.items()})


def k1_times():
    """``k1_time`` at both main-path shapes, on inputs from seed 1."""
    import torch

    device = torch.device("cuda", 0)
    return {label: dict(cap=c, **k1_time(args, kw)) for label, c, args, kw
            in k1_shapes(device, np.random.default_rng(1))}


def phase_k1(device, rng):
    import torch
    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.ops.topk import desc_key_score
    from linkpred_tpu_torch.predict.metrics import METRICS

    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    tile = k1_tile()
    cap = 1 << 20
    cases = [
        # name, metrics, wide, min_score, maxf2, run_len, fill, killers
        ("deg16_all7", UNWEIGHTED, False, 0.0, 0, 4, 0.95, 0.0),
        ("wide_pair", UNWEIGHTED, True, 0.0, 0, 4, 0.95, 0.0),
        ("aa_ra", ["adamic_adar", "resource_allocation"], False, 0.0, 0, 8,
         0.95, 0.0),
        ("runs_over_a_tile", ["common_neighbors", "adamic_adar"], False,
         0.0, 0, 5000, 1.0, 0.0),
        ("min_score", ["jaccard_coefficient", "common_neighbors"], False,
         0.01, 0, 4, 0.9, 0.0),
        ("maxf2", ["hub_promoted", "resource_allocation"], False, 0.0, 2, 4,
         0.9, 0.0),
        # the edge stream's killer branch
        ("killers_deg16_all7", UNWEIGHTED, False, 0.0, 0, 4, 0.95, 0.2),
        ("killers_wide_pair", UNWEIGHTED, True, 0.001, 0, 4, 0.95, 0.2),
        ("killers_weighted", ["jaccard_coefficient", "adamic_adar",
                              "resource_allocation"], False, 0.0, 2, 6,
         0.95, 0.2),
        ("killers_wide_weighted", ["adamic_adar", "resource_allocation"],
         True, 0.0, 0, 8, 0.9, 0.2),
        ("killers_runs_over_a_tile", ["common_neighbors", "adamic_adar"],
         False, 0.0, 0, 5000, 1.0, 0.3),
    ]
    max_err = 0.0
    for name, names, wide, min_score, maxf2, run_len, fill, kill in cases:
        mets = [METRICS[m] for m in names]
        n_wt = sum(m.needs_weight for m in mets)
        w, u, degs, wts = tail_stream(rng, cap, 20, fill, run_len, wide, n_wt,
                                      kill)
        args = (t(w), t(u), [t(d) for d in degs], [t(x) for x in wts],
                min_score)
        kw = dict(metrics=mets, w_bits=20, n=1 << 20, maxf2=maxf2,
                  killers=bool(kill))
        keys, err = k1_vs_twin(name, mets, args, kw)
        max_err = max(max_err, err)
        note = ""
        if kill:
            crossing = killed_runs_cross_tiles(args[0], args[1], keys, tile)
            if run_len > tile:
                check(crossing > 0, f"K1 {name}: no killed run crosses a "
                      "tile")
            note = f", {crossing} killed runs cross a tile"
        print(f"  K1 {name}: {len(mets)} metrics, cap {cap}: kernel == twin, "
              "twice the same bits" + note)
        if name == "killers_weighted":
            # the same lanes as views one lane into their buffers: hi, and
            # so the lanes' grouping, sits 4 bytes past a 16-byte boundary
            def view(x):
                buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=device)
                buf[1:] = x
                return buf[1:]

            moved = (view(args[0]), view(args[1]), [view(d) for d in args[2]],
                     [view(x) for x in args[3]], min_score)
            check(moved[0].data_ptr() % 16 != 0, "K1: the view is aligned")
            _, err = k1_vs_twin(f"{name} (views at lane 1)", mets, moved, kw)
            max_err = max(max_err, err)
            print(f"  K1 {name}, every input a view one lane into its "
                  "buffer (not 16-byte aligned): kernel == twin")

    # the deep look-back: runs of 3.5, 40 and 2 tiles, so a tile walks back
    # past several predecessors (past a window of 32 in the 40-tile run);
    # with killers, the 3.5-tile run starts with a killer in the first tile
    lengths = [tile // 3, int(3.5 * tile), 5, 40 * tile + 17, 2 * tile, 9]
    mets = [METRICS["common_neighbors"], METRICS["adamic_adar"]]
    for dead in (None, (1,)):
        w, u, degs, wts = runs_stream(rng, lengths, 1, dead)
        args = (t(w), t(u), [t(degs[0])], [t(wts[0])], 0.0)
        kw = dict(metrics=mets, w_bits=12, n=1 << 12, killers=dead is not None)
        keys, err = k1_vs_twin("deep look-back", mets, args, kw)
        max_err = max(max_err, err)
        ends = np.cumsum(lengths) - 1
        cn = desc_key_score(keys[0]).cpu().numpy()[ends]
        alive = np.ones(len(lengths), bool)
        alive[list(dead or ())] = False
        check(np.array_equal(cn[alive], np.array(lengths)[alive])
              and np.all(cn[~alive] == -np.inf),
              "K1 deep look-back: run lengths")
        what = "a killer in the first tile" if dead else "clean"
        print(f"  K1 deep look-back ({what}): runs of "
              f"{', '.join(map(str, lengths))} lanes: kernel == twin, the "
              "run lengths as made")

    out = {}
    for label, c, args, kw in k1_shapes(device, rng):
        k1_vs_twin(f"{label} timing input", kw["metrics"], args, kw)
        tm = k1_time(args, kw)
        per = tm["per_call"]
        kernels = [n for n in per if "tail_onepass" in n]
        memsets = [n for n in per if "emset" in n]
        check(len(kernels) == 1 and per[kernels[0]][0] == 1
              and len(per) == 1 + len(memsets)
              and sum(per[n][0] for n in memsets) <= 1,
              f"K1 {label}: device work per call {per}, not one launch of "
              "the one-pass kernel and at most one memset")
        events = cuda_ms(lambda: ft.fused_tail(*args, **kw))
        plain = cuda_ms(lambda: ft.fused_tail_reference(*args, **kw))
        b = bound(tail_bytes(c, False, 1, 0), 4 * c)
        print(f"  K1 time at cap 2^{c.bit_length() - 1}, deg16, Jaccard, "
              f"{label} (kernel == twin on these inputs): device "
              f"{tm['profiler_ms']:.4f} ms a call (profiler, by launch: "
              + ", ".join(f"{n[:60]} {ms * 1e3:.2f} us x {k:g}"
                          for n, (k, ms) in per.items())
              + f"), {tm['queued_ms']:.4f} ms queued behind a sleep, "
              f"{events:.4f} ms issued back to back; twin {plain:.4f} ms; "
              f"bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
        out[label] = dict(ms=tm["profiler_ms"], queued_ms=tm["queued_ms"],
                          events_ms=events, plain_ms=plain,
                          launches_per_call={n: k for n, (k, _)
                                             in per.items()}, **b)
    return dict(max_abs_err=max_err, **out["clean"], library_ms=None,
                killers_cap_2_21=out["killers"])


def phase_p1(device, rng):
    """P1's probe path: K1 at the prototype's configuration (Jaccard,
    deg16, no weights, no killers, W_BITS 21, 2^21 lanes) through the
    probe's ``pallas_tail``, bit-equal to the plain copy of its XLA tail."""
    import torch
    from linkpred_tpu_torch.experiments import pallas_tail as p1
    from linkpred_tpu_torch.ops import fused_tail as ft

    hi, lo, dpack = (torch.as_tensor(a, device=device)
                     for a in p1.make_stream(rng))
    ft.LAUNCHES = 0
    got = p1.pallas_tail(hi, lo, dpack, 0.0)
    launches = ft.LAUNCHES
    want = p1.xla_tail(hi, lo, dpack, 0.0)
    torch.cuda.synchronize()
    for a, b, what in zip(got, want, ("keys", "ku", "kw")):
        check(torch.equal(a, b), f"P1: {what} not bit-equal to xla_tail")
    # the probe's device work a call (K1's memset and launch, and the key's
    # sign flip), from the profiler over 20 calls
    got = device_profile(lambda: [p1.pallas_tail(hi, lo, dpack, 0.0)
                                  for _ in range(20)])
    ms = sum(t for _, t in got.values()) / 20
    queued = queued_ms(lambda: p1.pallas_tail(hi, lo, dpack, 0.0))
    plain = cuda_ms(lambda: p1.xla_tail(hi, lo, dpack, 0.0))
    b = bound(tail_bytes(p1.LANES, False, 1, 0), 4 * p1.LANES)
    print(f"  P1 pallas_tail at 2^21 lanes, W_BITS 21: K1 == xla_tail bit "
          f"for bit; device {ms:.4f} ms a call (profiler: " + ", ".join(
              f"{n[:50]} {t / 20 * 1e3:.2f} us" for n, (_, t) in got.items())
          + f"), {queued:.4f} ms queued behind a sleep; xla_tail "
          f"{plain:.4f} ms, bound {b['bound_ms']:.4f} ms")
    return dict(launches=launches, max_abs_err=0.0, ms=ms, queued_ms=queued,
                plain_ms=plain, **b, library_ms=None)


# --------------------------------------------------------------- phase 3: K2

def phase_k2(device, rng):
    import torch
    from linkpred_tpu_torch.ops import compact
    from linkpred_tpu_torch.ops.topk import desc_score_key, spread_invalid

    total = 1 << 24
    kk = 282_529           # RMAT-19's k at the bench protocol
    scores = rng.random(total, dtype=np.float32)
    scores[rng.random(total) < 0.9] = -np.inf
    s = torch.as_tensor(scores, device=device)
    lane = torch.arange(total, dtype=torch.int32, device=device)
    key = spread_invalid(desc_score_key(s), s, lane)
    clustered = torch.full((total,), 0x7F800000, dtype=torch.int32,
                           device=device) | (lane & 0x7FFFFE)
    clustered[3_000_000: 3_000_000 + kk] = lane[:kk]
    clustered[-1000:] = 5
    # the view one lane in is not 16-byte aligned and 2^24 - 1 lanes long
    cases = [("random", key), ("clustered", clustered),
             ("random, view at lane 1", key[1:])]
    for name, k in cases:
        thr, _ = compact.sample_threshold(k, kk)
        out = compact.pack_survivors(k, thr)
        ref = compact.pack_survivors_reference(k, thr)
        torch.cuda.synchronize()
        for a, b, what in zip(out, ref, ("keys", "indices", "count")):
            check(torch.equal(a, b), f"K2 {name}: {what} differ")
        print(f"  K2 {name}: {k.numel()} lanes, {int(out[2])} survivors: "
              "kernel == twin")
    # two calls back to back on the stream: the look-back state is fresh
    thr = [compact.sample_threshold(k, kk)[0] for k in (key, clustered)]
    outs = [compact.pack_survivors(k, t) for k, t in zip((key, clustered),
                                                          thr)]
    for k, t, out in zip((key, clustered), thr, outs):
        for a, b in zip(out, compact.pack_survivors_reference(k, t)):
            check(torch.equal(a, b), "K2 back to back: differs")
    print("  K2 twice back to back on one stream: both == twin")
    thr, _ = compact.sample_threshold(key, kk)
    ms = cuda_ms(lambda: compact.pack_survivors(key, thr))
    plain = cuda_ms(lambda: compact.pack_survivors_reference(key, thr))

    def library():
        # one PyTorch call's worth: the surviving lanes and their keys
        idx = torch.nonzero(key <= thr).flatten()
        return key[idx], idx

    lib_ms = cuda_ms(library)
    # the card's reach on K2's bytes: a device copy of the 2^24 keys
    copy = torch.empty_like(key)
    copy_ms = cuda_ms(lambda: copy.copy_(key))
    del copy
    parts = device_profile(lambda: compact.pack_survivors(key, thr))
    print("  K2 device time by launch (profiler, one call): " + ", ".join(
        f"{name[:40]} {ms * 1e3:.1f} us" for name, (_, ms) in parts.items()))
    count = int(compact.pack_survivors(key, thr)[2])
    capacity = total // compact.PACK_RATIO
    # read every key once; write every output lane (key and lane index, the
    # dead ones too) once, and the count
    b = bound(4 * total + 8 * capacity + 4, total)
    print(f"  K2 time at 2^24 lanes ({count} survivors): kernel {ms:.4f} ms, "
          f"twin {plain:.4f} ms, nonzero + gather {lib_ms:.4f} ms, bound "
          f"{b['bound_ms']:.4f} ms ({b['bound_by']}); a copy of the keys "
          f"(67.1 MB read and written) {copy_ms:.4f} ms")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, **b,
                library_ms=lib_ms)


# --------------------------------------------------- phase 4: end to end

def dense_oracle(g, spec, d1, sources=None):
    """{(u, v): score} over valid upper-triangle pairs, or with ``sources``
    over directed pairs (s, w), w != s; float64."""
    n = g.n
    a = np.zeros((n, n))
    src = np.repeat(np.arange(n), g.degrees)
    a[src, g.indices[: g.m]] = 1.0
    deg = a.sum(axis=1)
    ok = deg > 0
    if d1:
        ok &= deg <= d1
    cnt = (a * ok[None, :]) @ a
    acc = cnt
    if spec.needs_weight:
        acc = (a * (spec.weight_from_degree(deg, xp=np) * ok)[None, :]) @ a
    with np.errstate(divide="ignore", invalid="ignore"):
        s = spec.score(cnt, acc, deg[:, None], deg[None, :], xp=np)
    if sources is None:
        valid = np.triu(np.ones((n, n), bool), 1)
    else:
        valid = np.zeros((n, n), bool)
        valid[np.asarray(sources)] = True
        np.fill_diagonal(valid, False)
    valid &= (a == 0) & (cnt > 0) & (np.nan_to_num(s, nan=-np.inf) > 0)
    us, vs = np.nonzero(valid)
    return {(int(u), int(v)): float(s[u, v]) for u, v in zip(us, vs)}


def same_result(got, want, spec, where):
    check(len(got) == len(want), f"{where}: {len(got)} vs {len(want)} rows")
    if not len(want):
        return
    a, b = np.sort(got.score), np.sort(want.score)
    if spec.needs_weight:
        check(np.allclose(a, b, rtol=1e-5, atol=0), f"{where}: scores")
    else:
        check(np.array_equal(a, b), f"{where}: scores not bit-equal")
    check(np.isfinite(got.score).all(), f"{where}: non-finite scores")
    cut = want.score.min() * (1 + 1e-5)
    above = lambda r: {(int(u), int(v)) for u, v, s  # noqa: E731
                       in zip(r.u, r.v, r.score) if s > cut}
    check(above(got) == above(want), f"{where}: pairs above the k boundary")


def check_oracle(g, res, d1, where, sources=None, k=20_000):
    import linkpred_tpu_torch as lt

    for name, r in res.items():
        pairs = dense_oracle(g, lt.METRICS[name], d1, sources)
        check(len(r) == min(len(pairs), k), f"{where} {name}: oracle rows")
        for u, v, s in zip(r.u, r.v, r.score):
            check(np.isclose(s, pairs[(int(u), int(v))], rtol=1e-5),
                  f"{where} {name}: oracle score ({u}, {v})")


def phase_end_to_end(device):
    """``predict_links_multi`` for all 9 metrics, cuda against cpu (and the
    dense oracle where n <= 512): the packed stream at d1 in {64, 0}; the
    edge stream (``slot_budget=0``) in its keyed branch (K1 with killers) at
    d1 in {0, 4}, its sentinel two-key branch and serving mode; and runs
    with ``HUGE_DEVICE_MAX`` forced small so hub sources go to the host
    scorer (``plan.host_src``)."""
    import dataclasses

    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.bench.synth import (planted_partition_graph,
                                                rmat_graph)
    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.predict import plan as plan_mod
    from linkpred_tpu_torch.predict import scoring

    names = list(lt.METRICS)
    opts = lt.PredictOptions(max_edges=20_000)
    graphs = [("planted(8,32)", planted_partition_graph(8, 32, p_in=0.4,
                                                        p_out=0.002, seed=1)),
              ("RMAT-12", rmat_graph(12, edge_factor=16, seed=42))]

    def run(g, d1, where, sources=None, keyed=True, slot_budget=0, cap=None):
        res = {}
        for dev in (device, "cpu"):
            p = plan_mod.build_plan(g, d1, cap, slot_budget=slot_budget,
                                    sources=sources, device=dev)
            if not keyed:
                p = dataclasses.replace(p, keyed=False)
            k_before, s_before = ft.KILLER_LAUNCHES, scoring.SEGMENT_RUNS
            res[str(dev)] = lt.predict_links_multi(
                g, names, min_degree1=d1, options=opts, plan=p,
                sources=sources, device=dev)
            if dev == device:
                killers = ft.KILLER_LAUNCHES - k_before
                check(slot_budget != 0 or not p.packed or not p.total_slots,
                      f"{where}: plan not on the edge stream")
                check((killers > 0) == (keyed and not p.packed),
                      f"{where}: K1 killer launches {killers}")
        got, want = res[str(device)], res["cpu"]
        for name in names:
            same_result(got[name], want[name], lt.METRICS[name],
                        f"{where} {name}")
        if g.n <= 512:
            check_oracle(g, got, d1, where, sources)
        return p, got

    for gname, g in graphs:
        for d1 in (64, 0):
            p, got = run(g, d1, f"{gname} d1={d1}", slot_budget=None)
            print(f"  {gname} d1={d1} ({'packed' if p.packed else 'edge'}):"
                  f" 9 metrics, cuda == cpu "
                  f"({len(got['jaccard_coefficient'])} Jaccard rows)"
                  + (", == dense oracle" if g.n <= 512 else ""))
        # the planted graph's degrees are ~13: d1=4 leaves it no candidate
        for d1 in (0, 4) + ((16,) if g.n <= 512 else ()):
            p, got = run(g, d1, f"{gname} d1={d1} edge")
            print(f"  {gname} d1={d1} edge stream: {p.num_tiles} tiles, "
                  f"9 metrics, cuda == cpu ({len(got['jaccard_coefficient'])}"
                  " Jaccard rows)" + (", == dense oracle" if g.n <= 512
                                      else ""))
        run(g, 0, f"{gname} sentinel", keyed=False)
        print(f"  {gname} d1=0 sentinel two-key branch: cuda == cpu")
        sources = np.arange(0, g.n, max(g.n // 24, 1))
        got = run(g, 0, f"{gname} serving", sources=sources)[1]
        check(set(np.unique(got["jaccard_coefficient"].u))
              <= set(sources.tolist()), f"{gname} serving: sources")
        print(f"  {gname} serving mode ({sources.size} sources) on the edge "
              "stream: cuda == cpu")

    g = graphs[0][1]
    saved = plan_mod.HUGE_DEVICE_MAX
    plan_mod.HUGE_DEVICE_MAX = 160
    try:
        for budget in (None, 0):
            p, got = run(g, 0, f"host_src slot_budget={budget}",
                         slot_budget=budget, cap=128)
            check(p.host_src.size > 0 and p.huge_plan is not None,
                  "host_src: no mega-hub source or no hub sub-plan")
            hub = set(p.host_src.tolist())
            check(any(int(u) in hub for u in got["common_neighbors"].u),
                  "host_src: no host-scored row in the result")
            print(f"  planted d1=0, cap 128, HUGE_DEVICE_MAX 160 "
                  f"({'packed' if p.packed else 'edge stream'}): "
                  f"{p.host_src.size} sources scored on the host beside a "
                  f"{p.huge_plan.num_tiles}-tile hub sub-plan, cuda == cpu "
                  "== dense oracle")
    finally:
        plan_mod.HUGE_DEVICE_MAX = saved


# --------------------------------------------------- phase 5: main path

def time_split(device, plan, y, k):
    """Where one scoring pass of the main path spends its time, by timing
    its parts alone with CUDA events: the tile loop (window reads, the
    int64 sort, the payload gathers, K1), K1 alone on pre-sorted tiles, and
    the selection (threshold, K2, survivor sort, gathers).  The device busy
    share comes from the kernels of one profiled pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.predict import api, scoring

    names = ("jaccard_coefficient",)
    stream = plan.device_stream(device)
    kk = api._exact_k(plan, k)
    ts = plan.tile_start
    bounds = [(int(ts[t]), int(ts[t + 1])) for t in range(len(ts) - 1)
              if ts[t] < ts[t + 1]]
    tile_fn = scoring.tile_scorer(stream, metric_names=names, n=y.n,
                                  **api._pass_kwargs(plan))

    def one_pass():
        return scoring.scan_tiles(tile_fn, ts, kk, 1, plan.cap,
                                  device=device)

    def tiles():
        return [tile_fn(s, e) for s, e in bounds]

    # the pass's buffer (ghost tiles included), and the sorted tiles as K1
    # receives them
    sorted_in = []
    orig = scoring.fused_tail
    scoring.fused_tail = lambda *a, **k_: sorted_in.append((a, k_)) \
        or orig(*a, **k_)
    try:
        buf = scoring._fill_buffer(tile_fn, ts, range(len(ts) - 1), 1,
                                   plan.cap, device)
    finally:
        scoring.fused_tail = orig
    split = {
        "pass": cuda_ms(one_pass, 5),
        "tile loop": cuda_ms(tiles, 5),
        "K1 alone": queued_ms(lambda: [ft.fused_tail(*a, **k_)
                                       for a, k_ in sorted_in], 5),
        "selection": cuda_ms(lambda: scoring._select_topk(*buf, kk), 5),
    }
    one_pass()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_pass()
        torch.cuda.synchronize()
    return split, device_ms_by_kernel(prof)


def phase_main_path(device, scale: int = 19):
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.ops import compact
    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.predict import scoring
    from linkpred_tpu_torch.predict.plan import build_plan

    t0 = time.perf_counter()
    y, removed, k = bench_graph(scale)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_plan(y, 64, device=device)
    plan_ms = (time.perf_counter() - t0) * 1e3
    print(f"  RMAT-{scale}: n={y.n} |E|={y.size} removed={k} "
          f"setup {setup_s:.1f} s; plan: cap {plan.cap}, "
          f"{plan.num_tiles} tiles ({plan.num_tiles_padded} padded), "
          f"{plan.total_slots} slots, plan_ms {plan_ms:.1f}")
    opts = lt.PredictOptions(repeat=5, max_edges=k)

    ft.LAUNCHES = ft.KILLER_LAUNCHES = compact.LAUNCHES = 0
    scoring.PACKED_ARM_RUNS = scoring.SORT_ARM_RUNS = 0
    rates, res = [], None
    for _ in range(3):
        res = lt.predict_links(y, "jaccard_coefficient", min_degree1=64,
                               options=opts, plan=plan, device=device)
        rates.append(y.size / (res.scoring_ms / 1e3))
    launches = {"fused_tail": ft.LAUNCHES, "pack_survivors": compact.LAUNCHES}
    arms = (scoring.PACKED_ARM_RUNS, scoring.SORT_ARM_RUNS)

    recall = recall_of(res, removed)
    rates.sort()
    print(f"  RMAT-{scale} LHub Jaccard deg 64: edges/s median "
          f"{rates[1]:.6e} (samples {', '.join(f'{r:.6e}' for r in rates)});"
          f" scoring_ms {res.scoring_ms:.3f}, transfer_ms "
          f"{res.transfer_ms:.3f}, plan_ms {plan_ms:.1f}; "
          f"{len(res)} predictions, {round(recall * len(removed))} removed "
          f"edges recovered (recall {recall:.6g})")
    print(f"  launches in the main path: {launches}; selection arms "
          f"packed={arms[0]} sort={arms[1]}")
    check(len(res) == k and np.isfinite(res.score).all(),
          "main path: k finite predictions")
    check(np.all(np.diff(res.score) <= 0), "main path: scores descending")
    check(recall > 0, "main path: recall of the removed edges is zero")
    check(all(v > 0 for v in launches.values()),
          f"main path: a kernel never launched: {launches}")
    check(arms[0] > 0, "main path: the survivor pack arm never ran")
    check(ft.KILLER_LAUNCHES == 0, "main path: killers on packed tiles")

    split, by_kernel = time_split(device, plan, y, k)
    busy = sum(by_kernel.values())
    print(f"  one pass {split['pass']:.3f} ms: tile loop "
          f"{split['tile loop']:.3f} ms (K1 alone {split['K1 alone']:.3f} ms),"
          f" selection {split['selection']:.3f} ms; device busy "
          f"{busy:.3f} ms ({100 * busy / split['pass']:.1f}% of the pass); "
          "top device work of the pass:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms:8.3f} ms  {name[:90]}")
    print_k1_kernels(by_kernel)
    return launches


# --------------------------------------------------- phase 6: IHub path

def print_k1_kernels(by_kernel) -> None:
    """K1's line(s) of a profiler table, top ten or not."""
    for name, ms in by_kernel.items():
        if "tail_" in name:
            print(f"    K1: {ms:8.3f} ms  {name[:120]}")


def bench_graph(scale: int):
    """R-MAT at the bench protocol: edge factor 16, seed 42, 0.1|E|
    removed.  Returns (the graph with the edges removed, the removed
    undirected edges as a set of (u < v), k)."""
    from linkpred_tpu_torch.bench.synth import rmat_graph
    from linkpred_tpu_torch.ops.batch import (apply_batch,
                                              generate_edge_deletions,
                                              tidy_batch)

    g = rmat_graph(scale, edge_factor=16, seed=42)
    rng = np.random.default_rng(0)
    deletions = generate_edge_deletions(rng, g, int(0.1 * g.size / 2),
                                        undirected=True)
    deletions, insertions = tidy_batch(deletions, np.empty((0, 2), np.int64),
                                       g)
    y = apply_batch(g, deletions, insertions)
    removed = {(int(a), int(b)) for a, b in deletions if a < b}
    return y, removed, max(deletions.shape[0] // 2, 1)


def recall_of(res, removed) -> float:
    got = {(min(int(a), int(b)), max(int(a), int(b)))
           for a, b in zip(res.u, res.v)}
    return len(removed & got) / max(len(removed), 1)


def device_profile(fn, tries: int = 3):
    """The device work of one call of ``fn`` (after a warm-up call), from
    the profiler: {name: (events, device ms)}, in the order of each name's
    first event.  A profiler session that records no device event (seen on
    the card) is retried; after ``tries`` such sessions the run fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        got = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                n, ms = got.get(ev.name, (0, 0.0))
                got[ev.name] = (n + 1, ms + ev.device_time_total / 1e3)
        if got:
            return got
    check(False, f"the profiler recorded no device event in {tries} sessions")


def device_ms_by_kernel(prof):
    """{kernel name: device ms} over the session, in the order of each
    name's first launch."""
    from torch.autograd import DeviceType

    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) \
                + ev.device_time_total / 1e3
    return by_kernel


def pass_tile_fn(device, p, y, indices=None, degrees=None, stream=None):
    """The Jaccard tile scorer of pass ``p``, as ``predict_links`` builds
    it (``stream``: the pass's device stream unless given)."""
    from linkpred_tpu_torch.predict import api, scoring

    return scoring.tile_scorer(
        p.device_stream(device) if stream is None else stream,
        metric_names=("jaccard_coefficient",), n=y.n, indices=indices,
        degrees=degrees, **api._pass_kwargs(p))


def tile_vs_cpu(where, device, p, y, t, indices=None, degrees=None):
    """Tile ``t`` of pass ``p`` scored on the card and again on CPU copies
    of its window and the CSR (where K1's plain twin runs): the keys, ku
    and kw must be equal.  Returns the count of scored lanes."""
    import torch
    from linkpred_tpu_torch.ops.topk import desc_key_score

    s, e = int(p.tile_start[t]), int(p.tile_start[t + 1])
    got = pass_tile_fn(device, p, y, indices, degrees)(s, e)
    cpu = lambda a: None if a is None else a.cpu()  # noqa: E731
    win = tuple(None if a is None else a[s: s + p.cap].cpu()
                for a in p.device_stream(device))
    want = pass_tile_fn("cpu", p, y, cpu(indices), cpu(degrees),
                        stream=win)(0, e - s)
    for a, b, what in zip(got, want, ("keys", "ku", "kw")):
        check(torch.equal(a.cpu(), b), f"{where}: {what} differ from the "
              "CPU's")
    return int(torch.isfinite(desc_key_score(want[0][0])).sum())


def ihub_pass_split(device, plan, y, kk, indices, degrees):
    """One scoring pass of the IHub plan, pass by pass (the edge stream,
    then the hub sub-plan), host clock around each with a sync.  Then each
    pass's selection alone, with CUDA events, on a buffer of its real
    tiles: one segment and the merge of the segments' winners where the
    pass selects by segment, the whole buffer where it does not."""
    import torch
    from linkpred_tpu_torch.ops.topk import TopK
    from linkpred_tpu_torch.predict import api, scoring

    out = []
    for p in [plan, *api._sub_plans(plan)]:
        tile_fn = pass_tile_fn(device, p, y, indices, degrees)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scoring.scan_tiles(tile_fn, p.tile_start, kk, 1, p.cap,
                           device=device)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n_seg, seg = scoring._segments(len(p.tile_start) - 1, p.cap, 1,
                                       device)
        buf = scoring._fill_buffer(tile_fn, p.tile_start, range(seg), 1,
                                   p.cap, device)
        lanes = buf[1].shape[0]
        if n_seg == 1:
            sel = {f"selection over {lanes} lanes": cuda_ms(
                lambda: scoring._select_topk(*buf, kk), 3)}
        else:
            kk_seg = min(kk, seg * p.cap)
            top = scoring._select_topk(*buf, kk_seg, allow_pack=False)
            stacked = TopK(*(torch.stack([x] * n_seg) for x in top))
            sel = {
                f"selection of the first segment ({lanes} lanes, no pack)":
                    cuda_ms(lambda: scoring._select_topk(
                        *buf, kk_seg, allow_pack=False), 3),
                f"merge of {n_seg} segments' winners "
                f"({n_seg * top.scores.shape[1]} lanes)":
                    cuda_ms(lambda: scoring._merge_stacked(stacked, kk), 3)}
            del top, stacked
        del buf
        torch.cuda.empty_cache()
        out.append((p, ms, n_seg, sel))
    return out


def ihub_tile_split(device, plan, y, indices, degrees, n_win: int = 32):
    """Per-tile time split of the edge stream over a window of ``n_win``
    tiles from the middle of the plan, each part timed alone with CUDA
    events: the slot-map rebuild and gathers (``edge_keys``), the int64
    sort with its payload gathers (``keyed_sort``), K1 with killers; and a
    profiler table of the window's whole tiles.  K1 is held against its
    twin on every sorted tile of the window first.  Returns the window's
    size, the split, the profiler's device ms by kernel, the window's wall
    ms and the count of killed runs that cross a K1 tile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.predict import scoring
    from linkpred_tpu_torch.predict.metrics import METRICS

    mets = [METRICS["jaccard_coefficient"]]
    stream = plan.device_stream(device)
    ts = plan.tile_start
    bounds = [(int(ts[t]), int(ts[t + 1])) for t in range(len(ts) - 1)
              if ts[t] < ts[t + 1]]
    mid = max(len(bounds) // 2 - n_win // 2, 0)
    win = bounds[mid: mid + n_win]
    kw = dict(metrics=mets, cap=plan.cap, w_bits=plan.w_bits,
              upper_only=plan.upper_only)
    tail_kw = dict(metrics=mets, w_bits=plan.w_bits, n=y.n, maxf2=0,
                   killers=True)
    tile_fn = pass_tile_fn(device, plan, y, indices, degrees)

    def tiles():
        return [tile_fn(s, e) for s, e in win]

    def keys():
        return [scoring.edge_keys(indices, degrees, stream, s, e, **kw)
                for s, e in win]

    keyed = keys()
    sorted_in = [scoring.keyed_sort(*a, deg16=plan.deg16, predpacked=False)
                 for a in keyed]
    crossing = 0
    for j, (hi, lo, degs, wts) in enumerate(sorted_in):
        skeys, _ = k1_vs_twin(f"IHub edge tile {mid + j}", mets,
                              (hi, lo, degs, wts, 0.0), tail_kw)
        crossing += killed_runs_cross_tiles(hi, lo, skeys, k1_tile())
        del skeys
    split = {
        "tile": cuda_ms(tiles, 3),
        "slot map + gathers": cuda_ms(keys, 3),
        "sort + payload gathers": cuda_ms(
            lambda: [scoring.keyed_sort(*a, deg16=plan.deg16,
                                        predpacked=False) for a in keyed], 3),
        "K1 (killers)": queued_ms(lambda: [ft.fused_tail(*a, 0.0, **tail_kw)
                                           for a in sorted_in], 3),
    }
    split = {k: v / len(win) for k, v in split.items()}
    del keyed, sorted_in
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tiles()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return len(win), split, device_ms_by_kernel(prof), wall, crossing


def phase_ihub(device, scale: int = 18):
    """IHub at scale: predict_links Jaccard at min_degree1=0 with the
    card's own budgets, which put RMAT-18 on the edge stream."""
    import torch
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.ops import compact
    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.predict import api, scoring
    from linkpred_tpu_torch.predict.plan import build_plan

    t0 = time.perf_counter()
    y, removed, k = bench_graph(scale)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_plan(y, 0, device=device)
    plan_ms = (time.perf_counter() - t0) * 1e3
    hp = plan.huge_plan
    print(f"  RMAT-{scale}: n={y.n} |E|={y.size} removed={k} setup "
          f"{setup_s:.1f} s; IHub plan: packed={plan.packed}, cap "
          f"{plan.cap}, {plan.num_tiles} tiles ({plan.num_tiles_padded} "
          f"padded), {plan.total_slots} slots, deg16={plan.deg16}; hub "
          "sub-plan: "
          + (f"packed={hp.packed}, cap {hp.cap}, {hp.num_tiles} tiles, "
             f"{hp.total_slots} slots" if hp is not None else "none")
          + f"; host_src {plan.host_src.size}; plan_ms {plan_ms:.1f}")
    check(not plan.packed, "IHub: the plan is not on the edge stream")
    check(hp is not None, "IHub: no hub sub-plan")
    opts = lt.PredictOptions(repeat=1, max_edges=k)

    torch.cuda.reset_peak_memory_stats(device)
    ft.LAUNCHES = ft.KILLER_LAUNCHES = compact.LAUNCHES = 0
    scoring.SEGMENT_RUNS = 0
    rates, res = [], None
    for _ in range(3):
        res = lt.predict_links(y, "jaccard_coefficient", min_degree1=0,
                               options=opts, plan=plan, device=device)
        rates.append(y.size / (res.scoring_ms / 1e3))
    launches = {"fused_tail": ft.LAUNCHES, "pack_survivors": compact.LAUNCHES}
    killer_launches, seg_runs = ft.KILLER_LAUNCHES, scoring.SEGMENT_RUNS
    n_passes = 3 * 2          # each call: one warm-up pass, one timed pass
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    recall = recall_of(res, removed)
    rates.sort()
    print(f"  RMAT-{scale} IHub Jaccard: edges/s median {rates[1]:.6e} "
          f"(samples {', '.join(f'{r:.6e}' for r in rates)}); scoring_ms "
          f"{res.scoring_ms:.3f}, transfer_ms {res.transfer_ms:.3f}, plan_ms "
          f"{plan_ms:.1f}; {len(res)} predictions, recall {recall:.6g}; "
          f"peak device memory {peak_gb:.3f} GB")
    print(f"  launches in the IHub path ({n_passes} passes): {launches}, of "
          f"which K1 with killers {killer_launches}; selection segments "
          f"{seg_runs}")
    check(len(res) == k and np.isfinite(res.score).all(),
          "IHub: k finite predictions")
    check(np.all(np.diff(res.score) <= 0), "IHub: scores descending")
    check(killer_launches > 0, "IHub: K1 never ran its killer branch")
    # one K1 launch per non-empty tile of the edge stream and the hub
    # sub-plan, in every pass
    tiles = [int(np.count_nonzero(np.diff(p.tile_start) > 0))
             for p in (plan, hp)]
    check(launches["fused_tail"] == n_passes * sum(tiles),
          f"IHub: {launches['fused_tail']} K1 launches, not {n_passes} x "
          f"({tiles[0]} edge tiles + {tiles[1]} hub sub-plan tiles)")
    check(seg_runs >= 2 * n_passes,
          f"IHub: the edge pass selected over {seg_runs} segments in "
          f"{n_passes} passes, not more than one each")

    indices, degrees = lt.PlanCache().device_graph(y, device)
    # the path's tiles at their real shapes against the CPU, whose K1 is
    # the plain twin: an edge tile (K1 with killers, cap 2^21) and the hub
    # sub-plan's fullest tile (clean K1 at cap 2^23, 8,192 K1 tiles)
    live = np.flatnonzero(np.diff(plan.tile_start) > 0)
    mid = int(live[live.size // 2])
    fullest = int(np.argmax(np.diff(hp.tile_start)))
    for where, p, t, csr in (("edge tile", plan, mid, (indices, degrees)),
                             ("hub sub-plan tile", hp, fullest, ())):
        scored = tile_vs_cpu(f"IHub {where} {t}", device, p, y, t, *csr)
        check(scored > 0, f"IHub {where} {t}: no scored pair")
        print(f"  IHub {where} {t} (cap {p.cap}): card == CPU (keys, ku, "
              f"kw), {scored} scored pairs")
    kk = api._exact_k(plan, k)
    for p, ms, n_seg, sel in ihub_pass_split(device, plan, y, kk, indices,
                                             degrees):
        print(f"  pass {'edge stream' if not p.packed else 'packed'} cap "
              f"{p.cap}, {p.num_tiles} tiles: {ms:.3f} ms (host clock), "
              f"{n_seg} selection segment(s)")
        for name, sel_ms in sel.items():
            print(f"    {name}: {sel_ms:.3f} ms")
    n_win, split, by_kernel, wall, crossing = ihub_tile_split(
        device, plan, y, indices, degrees)
    print(f"  K1 with killers == twin on all {n_win} tiles of the window; "
          f"{crossing} killed runs cross a K1 tile there")
    print(f"  edge tile split over {n_win} tiles of cap {plan.cap} (ms per "
          "tile, each part timed alone): " + ", ".join(
              f"{name} {ms:.4f}" for name, ms in split.items()))
    busy = sum(by_kernel.values())
    print(f"  profiler over the window: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall ({100 * busy / wall:.1f}%); top device work:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {ms:8.3f} ms  {name[:90]}")
    print_k1_kernels(by_kernel)
    del indices, degrees
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------ phase 7: the sort probes

# log2 of the sizes the probes' paths run P2 and P3 at: where the TPU
# measured them, and the engine's tile sizes (the middle one is the
# record's headline); the bitonic kernel is timed there and at the hub
# sub-plan's cap 2^23 (its key-value arrays past the 50 MB L2), and held
# against its plain version at every size its launch planner treats
# differently (below a tile, one tile, two tiles, and the timed ones); the
# radix probe's own size
SORT_SIZES = (18, 20, 21)
TIMED_SIZES = SORT_SIZES + (23,)
CHECK_SIZES = (7, 13, 14) + TIMED_SIZES
RADIX_LOG2 = 21


def dup_keys(rng, n: int) -> np.ndarray:
    """Duplicate-heavy int32 keys over the full range: n draws from 1,024
    values."""
    vals = rng.integers(-(1 << 31), 1 << 31, 1024, dtype=np.int64)
    return vals[rng.integers(0, 1024, n)].astype(np.int32)


def bitonic_vs_plain(device, rng, log2n: int):
    """The bitonic kernel through P2 keys-only, P2 kv and P3 kv (and P3
    without payload) on duplicate-heavy keys, against its plain version bit
    for bit (keys and payload), against ``torch.sort`` (keys), with the
    payload a permutation and ``x[p] == k``; the inputs stay unwritten.
    Returns the card tensors (x, payload) and the kernel's grid launches
    per sort, as ``bitonic.cu`` counted them in each of the four sorts
    (which must agree with each other and with the rows of the plan)."""
    import torch
    from linkpred_tpu_torch.experiments import pallas_bitonic as p2
    from linkpred_tpu_torch.experiments import pallas_bitonic2 as p3

    n = 1 << log2n
    where = f"bitonic 2^{log2n}"
    shape = (n // p2.LANES, p2.LANES)
    x = torch.as_tensor(dup_keys(rng, n), device=device).reshape(shape)
    pay = torch.arange(n, dtype=torch.int32, device=device).reshape(shape)
    x0, pay0 = x.clone(), pay.clone()
    plain_k, plain_p = p2.bitonic_stages(x, n, payload=pay)
    launched = []

    def counted(f, *args):
        p2.GRID_LAUNCHES = 0
        out = f(*args)
        launched.append(p2.GRID_LAUNCHES)
        return out

    got = {"P2 keys": (counted(p2.make_pallas_sort(n), x), None),
           "P2 kv": counted(p2.make_pallas_sort_kv(n), x, pay),
           "P3 kv": counted(p3.make_sort(n), x, pay)}
    k_np, p_np = counted(p3.make_sort(n, with_payload=False), x, pay)
    torch.cuda.synchronize()
    rows = len(p2.plan_launches(*p3.stage_table(n), n))
    check(launched == [rows] * 4, f"{where}: grid launches per sort "
          f"{launched}, the plan has {rows} rows")
    check(torch.equal(x, x0) and torch.equal(pay, pay0),
          f"{where}: the input was written")
    check(torch.equal(k_np, plain_k) and torch.equal(p_np, pay),
          f"{where}: P3 without payload != plain keys + the payload as given")
    want = torch.sort(x.reshape(-1)).values
    flat_x = x.reshape(-1)
    for name, (k, p) in got.items():
        check(torch.equal(k, plain_k), f"{where} {name}: keys != plain")
        check(torch.equal(k.reshape(-1), want),
              f"{where} {name}: keys != torch.sort")
        if p is None:
            continue
        check(torch.equal(p, plain_p), f"{where} {name}: payload != plain")
        perm = p.reshape(-1).long()
        check(torch.equal(torch.sort(perm).values,
                          torch.arange(n, device=device)),
              f"{where} {name}: payload not a permutation")
        check(torch.equal(flat_x[perm], k.reshape(-1)),
              f"{where} {name}: x[p] != k")
    ties = n - int(torch.unique(flat_x).numel())
    print(f"  {where}: P2 keys, P2 kv, P3 kv (and P3 without payload) == "
          f"plain bit for bit, keys == torch.sort, x[p] == k; {ties} tied "
          f"lanes; {rows} grid launches per sort (counted in each)")
    return x, pay, rows


def launch_ms(x, pay):
    """Device ms of each grid launch of one bitonic sort of ``x`` (with the
    payload ``pay``, or None): the plan's rows run one at a time through
    ``sort_network`` on copies, a CUDA event after each, all queued behind
    a sleep kernel so that the host's issue gaps fall inside the sleep.
    The result must equal the whole sort's."""
    import torch
    from linkpred_tpu_torch.experiments import pallas_bitonic as p2
    from linkpred_tpu_torch.experiments import pallas_bitonic2 as p3

    n = x.numel()
    ks, js = p3.stage_table(n)
    plan = p2.plan_launches(ks, js, n).tolist()
    k = x.clone()
    p = None if pay is None else pay.clone()
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(plan) + 1)]
    torch.cuda._sleep(50_000_000)
    events[0].record()
    for row, (kind, first, count) in enumerate(plan):
        stages = slice(first, first + count)
        p2.sort_network(k, p, ks[stages], js[stages], [(kind, 0, count)],
                        "bitonic launch by launch")
        events[row + 1].record()
    torch.cuda.synchronize()
    if p is None:
        check(torch.equal(k, p2.make_pallas_sort(n)(x)),
              "bitonic launch by launch: keys != the whole sort's")
    else:
        for a, b in zip((k, p), p2.make_pallas_sort_kv(n)(x, pay)):
            check(torch.equal(a, b),
                  "bitonic launch by launch: != the whole sort's")
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def time_bitonic(device, x, pay, rows: int):
    """Kernel, ``torch.sort`` (+ gather) and plain version on the same card
    tensors: keys-only through P2, key-value through P2 and P3.  Then the
    kernel and ``torch.sort`` on the random 31-bit keys that P2's and P3's
    ``run`` sort."""
    import torch
    from linkpred_tpu_torch.experiments import pallas_bitonic as p2
    from linkpred_tpu_torch.experiments import pallas_bitonic2 as p3

    n = x.numel()
    m = n.bit_length() - 1
    compares = m * (m + 1) // 2 * n // 2
    flat, pflat = x.reshape(-1), pay.reshape(-1)
    ks, js = p3.stage_table(n)

    def kv_library():
        v, idx = torch.sort(flat)
        return v, pflat[idx]

    f, fkv, f3 = (p2.make_pallas_sort(n), p2.make_pallas_sort_kv(n),
                  p3.make_sort(n))
    keys = dict(ms=cuda_ms(lambda: f(x)),
                plain_ms=cuda_ms(lambda: p2.bitonic_stages(x, n), 3),
                library_ms=cuda_ms(lambda: torch.sort(flat)),
                **bound(8 * n, compares))
    lib_kv = cuda_ms(kv_library)
    kv = dict(ms=cuda_ms(lambda: fkv(x, pay)),
              plain_ms=cuda_ms(lambda: p2.bitonic_stages(x, n, payload=pay),
                               3),
              library_ms=lib_kv, **bound(16 * n, compares))
    table = dict(ms=cuda_ms(lambda: f3(x, pay)),
                 plain_ms=cuda_ms(lambda: p3.table_stages(x, pay, ks, js), 3),
                 library_ms=lib_kv, **bound(16 * n, compares))
    for name, t in (("P2 keys", keys), ("P2 kv", kv), ("P3 kv", table)):
        print(f"  {name} 2^{m}: kernel {t['ms']:.4f} ms, torch.sort"
              f"{'' if name == 'P2 keys' else ' + gather'} "
              f"{t['library_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
              f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
              f"{rows} grid launches per sort")
    r31 = torch.as_tensor(np.random.default_rng(0).integers(
        0, 1 << 31, n, dtype=np.int32), device=device)
    keys["random31"] = dict(ms=cuda_ms(lambda: f(r31.reshape(x.shape))),
                            library_ms=cuda_ms(lambda: torch.sort(r31)))
    print(f"  P2 keys 2^{m} on run()'s random 31-bit keys: kernel "
          f"{keys['random31']['ms']:.4f} ms, torch.sort "
          f"{keys['random31']['library_ms']:.4f} ms (1,024-value keys: "
          f"{keys['ms']:.4f}, {keys['library_ms']:.4f} ms)")
    if m == 20:
        for name, p in (("keys", None), ("kv", pay)):
            per = launch_ms(x, p)
            check(len(per) == rows and all(ms > 0 for ms in per),
                  f"bitonic {name} 2^{m}: launch times {per}")
            print(f"  P2 {name} 2^{m} device time per grid launch (CUDA "
                  "events, launches queued back to back): " + ", ".join(
                      f"{ms * 1e3:.1f}" for ms in per)
                  + f" us; sum {sum(per):.4f} ms")
    return keys, kv, table


def phase_sort_probes(device, rng):
    """The sort-feasibility probes: P2 and P3 (the bitonic kernel) and the
    radix probe (its sort and 1-bit split columns and P4, the dynamic-store
    kernel), each driven through its ``run``/``main`` with the launch
    counts zeroed just before and read just after; then each kernel against
    its plain version, and the timings beside the bounds."""
    import torch
    from linkpred_tpu_torch.experiments import pallas_bitonic as p2
    from linkpred_tpu_torch.experiments import pallas_bitonic2 as p3
    from linkpred_tpu_torch.experiments import radix_probe as rp
    from linkpred_tpu_torch.ops import compact

    # the probes' paths: P2/P3 at 2^18 (where the TPU measured them) and at
    # the engine's tile sizes; the radix probe at its own 2^21 lanes
    p2.LAUNCHES = p3.LAUNCHES = rp.LAUNCHES = compact.LAUNCHES = 0
    for m in SORT_SIZES:
        p2.run(m, payload=True, device=device)
        p3.run(m, device=device)
    # ten calls per timing: with the probe's three, one slow first call of
    # make_run(1) skewed (t_8 - t_1) / 7 by a third on the card
    radix = rp.main(["--lanes-log2", str(RADIX_LOG2), "--repeat", "10"])
    launches = {"make_pallas_sort": p2.LAUNCHES, "make_sort": p3.LAUNCHES,
                "dynstore_run": rp.LAUNCHES,
                "pack_survivors": compact.LAUNCHES}
    print(f"  launches in the probes' paths: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"sort probes: a kernel never launched: {launches}")

    timed, per_sort = {}, {}
    for m in CHECK_SIZES:
        x, pay, per_sort[f"2^{m}"] = bitonic_vs_plain(device, rng, m)
        if m in TIMED_SIZES:
            timed[m] = time_bitonic(device, x, pay, per_sort[f"2^{m}"])
        del x, pay
    check(per_sort["2^20"] <= 16,
          f"bitonic: {per_sort['2^20']} grid launches per 2^20 sort")

    # P4 at the probe's shape
    offs, xs = (torch.as_tensor(a, device=device)
                for a in rp.dynstore_inputs(np.random.default_rng(5)))
    for iters in (1, 32):
        got = rp.dynstore_run(iters, offs, xs)
        want = rp.dynstore_reference(iters, offs, xs)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"P4 iters={iters}: kernel != plain")
    untouched = int((got == rp.INT32_MIN).all(dim=1).sum())
    p4 = dict(ms=cuda_ms(lambda: rp.dynstore_run(32, offs, xs)),
              plain_ms=cuda_ms(lambda: rp.dynstore_reference(32, offs, xs),
                               2),
              **bound(4 * (rp.NSTORES + 2 * rp.ROWS * rp.COLS),
                      32 * rp.NSTORES * rp.BLK * rp.COLS))
    print(f"  P4 dynstore (512, 128), 256 stores: kernel == plain at iters 1 "
          f"and 32 ({untouched} rows untouched); at iters 32 kernel "
          f"{p4['ms']:.4f} ms, plain {p4['plain_ms']:.4f} ms, bound "
          f"{p4['bound_ms']:.6f} ms; {radix['per_store_us']:.5f} us per "
          "store (radix probe)")

    # K2 at ratio=1 on the 1-bit split's lanes: every survivor fits
    key = rp.pack_keys(np.random.default_rng(1), 1 << RADIX_LOG2, device) \
        ^ 0x5A5A5
    thr = torch.tensor(rp.SPLIT_THR, dtype=torch.int32, device=device)
    out = compact.pack_survivors(key, thr, ratio=1)
    ref = compact.pack_survivors_reference(key, thr, ratio=1)
    torch.cuda.synchronize()
    for a, b, what in zip(out, ref, ("keys", "indices", "count")):
        check(torch.equal(a, b), f"K2 ratio=1: {what} differ")
    count = int(out[2])
    check(0 < count < key.numel() and out[0].numel() == key.numel(),
          f"K2 ratio=1: {count} survivors of {key.numel()}")
    print(f"  K2 at ratio=1 on 2^{RADIX_LOG2} split lanes: {count} "
          "survivors, kernel == plain")

    def row(t, extra):
        return dict(max_abs_err=0.0, **t, **extra)

    head = SORT_SIZES[1]
    by_size = lambda i: {f"2^{m}": timed[m][i]  # noqa: E731
                         for m in TIMED_SIZES if m != head}
    keys, kv, table = timed[head]
    p2_row = row(keys, dict(launches=launches["make_pallas_sort"],
                            shape=f"2^{head} keys", kv=kv,
                            kv_by_size=by_size(1), keys_by_size=by_size(0),
                            launches_per_sort=per_sort))
    p3_row = row(table, dict(launches=launches["make_sort"],
                             shape=f"2^{head} key-value", by_size=by_size(2),
                             launches_per_sort=per_sort))
    p4_row = row(p4, dict(launches=launches["dynstore_run"],
                          shape="iters 32", library_ms=None,
                          per_store_us=radix["per_store_us"]))
    return p2_row, p3_row, p4_row, launches["pack_survivors"]


def k1_ab(other: str) -> int:
    """K1's device times (``k1_times``) of the tree at ``other`` and of this
    one, each in a process of its own, in turns: other, this, this,
    other.  Prints one JSON line per turn."""
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    check(os.path.isdir(os.path.join(other, "linkpred_tpu_torch")),
          f"--k1-ab: no linkpred_tpu_torch in {other}")
    print(card_line())
    for tree in (other, here, here, other):
        code = ("import importlib.util, json, sys; "
                f"sys.path.insert(0, {tree!r}); "
                "spec = importlib.util.spec_from_file_location("
                f"'smoke', {os.path.join(here, 'chip_smoke.py')!r}); "
                "m = importlib.util.module_from_spec(spec); "
                "spec.loader.exec_module(m); "
                "print(json.dumps(m.k1_times()))")
        r = subprocess.run([sys.executable, "-c", code], cwd=tree,
                           capture_output=True, text=True, timeout=900)
        check(r.returncode == 0, f"--k1-ab in {tree}: {r.stderr[-3000:]}")
        print(json.dumps({"tree": tree, "k1": json.loads(
            r.stdout.strip().splitlines()[-1])}), flush=True)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--k1-ab"]:
        return k1_ab(sys.argv[2])
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import linkpred_tpu_torch  # noqa: F401  (fails without the repository)
    from linkpred_tpu_torch.kernels import _build

    device = torch.device("cuda", 0)
    card = card_line()
    print("phase 0: card")
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          "device(s)")
    t_start = time.perf_counter()

    def phase(title):
        print(f"{title} (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)

    rng = np.random.default_rng(0)
    phase("phase 1: build, then P5 against its plain version")
    t0 = time.perf_counter()
    _build.load()
    print(f"  kernels built by nvcc from linkpred_tpu_torch/kernels/csrc "
          f"and loaded in {time.perf_counter() - t0:.2f} s")
    p5 = phase_p5(device, rng)
    phase("phase 2: K1 fused_tail against its twin; P1 against xla_tail")
    k1 = phase_k1(device, rng)
    p1 = phase_p1(device, rng)
    phase("phase 3: K2 pack_survivors against its twin")
    k2 = phase_k2(device, rng)
    phase("phase 4: end to end, cuda against cpu")
    phase_end_to_end(device)
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 19
    phase(f"phase 5: the LHub main path, RMAT-{scale}")
    lhub = phase_main_path(device, scale)
    torch.cuda.empty_cache()
    phase("phase 6: the IHub path, RMAT-18 on the edge stream")
    ihub = phase_ihub(device, 18)
    torch.cuda.empty_cache()
    phase("phase 7: the sort probes P2, P3 (bitonic) and P4 (radix probe); "
          "bitonic at 2^7-2^23")
    p2, p3, p4, probe_packs = phase_sort_probes(device, rng)
    phase("done")

    stats = {
        "fused_tail": dict(
            launches=lhub["fused_tail"] + ihub["fused_tail"],
            launches_by_path={"lhub": lhub["fused_tail"],
                              "ihub": ihub["fused_tail"]}, **k1),
        "pack_survivors": dict(
            launches=lhub["pack_survivors"] + ihub["pack_survivors"]
            + probe_packs,
            launches_by_path={"lhub": lhub["pack_survivors"],
                              "ihub": ihub["pack_survivors"],
                              "radix_probe": probe_packs}, **k2),
        "pallas_tail": p1,
        "affine_smoke": p5,
        "make_pallas_sort": dict(
            also_replaces="experiments/pallas_bitonic.py:95", **p2),
        "make_sort": p3,
        "dynstore_run": p4,
    }
    for name, pr in REDESIGNED_IN.items():
        stats[name]["redesigned_in"] = pr
    record = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             **stats[name]) for name, src, rep in KERNELS]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
