#!/usr/bin/env python3
"""Smoke run of linkpred_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels, measures the card's launch floor (empty kernels back to back from
C) and checks P5, the toolchain smoke, against its plain version and numpy
at the probe's (8, 128), 2^20, 2^26, ragged lengths and a misaligned view,
timed by the profiler against the floor and (at 2^26) the bytes bound;
checks each other kernel against its plain PyTorch twin, checks the port
end to end against the CPU and a dense oracle (packed and edge-stream
plans, serving mode, the mega-hub host scorer), and drives the two main
paths at the bench protocol:

* LHub (phase 5): ``predict_links`` Jaccard at deg 64 on RMAT-19, the
  packed slot stream;
* IHub (phase 6): ``predict_links`` Jaccard at ``min_degree1=0`` on
  RMAT-18 with the card's own budgets: the edge stream (K1's killer branch,
  selection by segment) plus the packed hub sub-plan.  Over a window of 32
  edge tiles the tile's slot map (a binary search of the tile's rows) is
  held lane for lane against the formula it replaced (a scatter-max of row
  starts and a cummax over the window), and both are timed.

Phases 5 and 6 also measure the device bytes a lane that one tile
allocates (``max_memory_allocated`` around it, less what was resident):
the packed tile at cap 2^21 and 2^23 and the edge tile at cap 2^21 with
killers, Jaccard and all nine metrics; each must stay at or under
``predict.scoring.TILE_BYTES_PER_LANE``, what the memory check prices.

Phase 7 drives the JAX package's sort-feasibility probes as ported: P2 and
P3 (the bitonic network, ``bitonic.cu``) bit for bit against their plain
version at every size its launch planner treats differently (2^7, one
tile, two tiles, 2^18-2^21, 2^23), timed at 2^18-2^23 against
``torch.sort``, and the radix probe (``torch.sort``, K2 at ``ratio=1`` as
a 1-bit split, P4's dynamic stores in ``dynstore.cu``); P4 against its
plain version and its banded order at iters 1, 2 and 32 on the probe's
offsets and on offsets that stress its bands, its device time queued
behind a sleep and by the profiler (taken in phase 1, where the profiler
records the card's work), the per-store cost from their difference, and
the radix arithmetic with that cost.

Phase 8 drives the experiment driver, ``cli.main``, as a user runs it: on
a planted-partition graph against the same sweep on the CPU (the kernels'
plain versions), on RMAT-18 written as MTX (all 9 metrics, thresholds 4
and 64, two deletion fractions, fused and unfused, the logs parsed into
CSV), and ``python -m linkpred_tpu_torch`` as a subprocess.

Phase 9 drives the bench leg and the rest of the experiment layer: the
bench row (``bench.run.main()``) at phase 5's scale with phase 5's graph as
its cache, checked against the roofline model of phase 5's plan and the
card's peak; ``python -m linkpred_tpu_torch.bench.run`` as a subprocess at
RMAT-14, making its cache and then reading it; the heuristic model zoo on
the card against the CPU; ``python -m linkpred_tpu_torch.bench.sweep`` as a
subprocess (three graphs, ``--resume``, ``--suite reference
--allow-missing``) and ``run_sweep`` on the card against the CPU; an npz
round trip of phase 5's graph; ``profile_fn`` around one LHub pass.

Phase 10 drives the host layer and the device helpers on the card against
the port's own CPU path: ``bfs_levels`` on phase 5's graph, modularity and
``communities_disconnected`` on phase 8's planted graph, the top-k merge
helpers over 2^21 candidates at phase 5's k, the device deletion sampler at
0.1|E| of phase 5's graph, ``xorshift32_step`` and ``scatter_or`` over 2^24
lanes.

Phase 11 drives the sharded pass (``parallel/``): (a) a one-rank NCCL
process group in this process, ``predict_links(mesh=)`` on phase 5's graph
and plan against the plain pass; (b) ``python -m
linkpred_tpu_torch.parallel.sim 2`` on the one card over gloo (NCCL refuses
two ranks on one device): LHub RMAT-19 and the IHub edge stream at RMAT-17,
each exact against rank 0's single-process pass, every rank's stream bytes
against the padded total / 2, its priced device bytes against its free
memory, its K1 and K2 launches, its pass and gather times; (c) the port's
dry run (deletions, ``apply_batch``, the sharded pass) at D = 2.

Phase 12 drives the GraphSAGE family (``models/gnn.py``) at the module's
widths (hidden 64, out 32, 8 degree features, batch 4096): on phase 8's
planted graph with 0.1|E| held out, 150 training steps full-graph and
``fanouts=(10, 10)`` on the card, held-out AUC > 0.65, the card-trained
parameters encoding on the CPU as on the card; on phase 5's RMAT-19, 20
steps of each with their ms a step, then ``GNNPredictor`` and
``HybridPredictor`` on LHub Jaccard deg 64 candidates at k = the removed
edges, their recall beside the heuristic's.

Phase 13 drives the port-side examples and scripts as a user runs them:
(a) ``examples/serving/run_torch.py`` (three requests, one cached plan,
the last request against the CPU); (b) ``examples/ihub_vs_lhub/
run_torch.py`` at RMAT 14-15 (cut from its default 14-16), both
fractions, each leg's plan ms and stream beside its scoring ms, IHub and
LHub at RMAT-14 against the CPU;
(c) ``examples/multihost_sim/run_torch.py`` with two rank processes on
the card; (d) ``scripts/bench_table_torch.py 18 19``, a fresh bench
process a row; (e) ``scripts/verify_torch.py``, the dense oracle.

Phase 14 drives the engine's design probes (``linkpred_tpu_torch/
experiments/``, the counterparts of the JAX package's ``experiments/``):
the graph probes (``profile_bench``, ``profile_tiles``, ``diag_scale``,
``diag_s21``, ``ab_split`` and its ``--deferred``, ``diag_pack``) on phase
5's graph and plan, the synthetic ones at ``PROBE_CUTS``; every probe
holds its arms equal on the card and raises otherwise; the phase prints
its rows, each probe's wall seconds against ``PROBES_BUDGET_S``, and K1's
and K2's launches (the path ``probes``).

    python3 chip_smoke.py [scale]
    python3 chip_smoke.py --probes OUT_DIR
    python3 chip_smoke.py --k1-ab OTHER_TREE
    python3 chip_smoke.py --ihub-lhub OUT_DIR CPU_SCALE SCALE...
    python3 chip_smoke.py --sweep-vs-tpu OUT_DIR TPU_CSV SWEEP_ARGS...

``scale`` (default 19) sets the R-MAT scale of the LHub path.  With
``--probes`` it runs only the design probes, at the JAX probes' own sizes,
into ``OUT_DIR/probes.jsonl``.  With
``--k1-ab`` it only times K1 at the main paths' shapes, in this tree and in
another checkout of the repository (such as the parent commit unpacked by
``git archive``), in turns.  With ``--ihub-lhub`` it runs only phase 13
(b) at the given scales into ``OUT_DIR``, the CPU check at ``CPU_SCALE``
(fraction 0.1).  With ``--sweep-vs-tpu`` it runs ``python -m
linkpred_tpu_torch.bench.sweep SWEEP_ARGS`` into ``OUT_DIR`` and holds its
rows against the TPU sweep's CSV (``sweep_vs_tpu``).  Run from the
root of the repository.  Every phase prints its lines and any
failure raises, so the run exits non-zero.  With no CUDA device, or without
the package beside the script, it exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record, and the line before that the card's name and
power limit.  Each kernel's row has the contract's ``bound_ms`` (the
larger of its bytes over the memory rate and its operations over the peak
rate, ``bound_by`` "bytes" or "operations") and beside it
``launch_floor_ms`` and ``bound_with_launch_ms``: the floor where it
exceeds that roofline (``bound_with_launch_by`` "launch").
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import weakref

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
                 "make_sort": 4, "fused_tail": 5, "pallas_tail": 5,
                 "dynstore_run": 11, "affine_smoke": 11}
# The card's memory rate and float32 rate outside the tensor cores
# (H100 SXM data sheet): the roofline of every kernel here.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
UNWEIGHTED = ["common_neighbors", "jaccard_coefficient", "sorensen_index",
              "salton_cosine_similarity", "hub_promoted", "hub_depressed",
              "leicht_holme_nerman"]
ALL_METRICS = (*UNWEIGHTED, "adamic_adar", "resource_allocation")


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: check failed: {msg}")


def kernel_launches() -> dict:
    """K1's and K2's CUDA launches by wrapper name, from the program's
    counters (``utils/profiling.py``) since their last reset."""
    from linkpred_tpu_torch.utils.profiling import counter

    return {"fused_tail": counter("k1.launches"),
            "pack_survivors": counter("k2.launches")}


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


# The card's launch floor in ms (phase 1 measures it before any bound).
LAUNCH_FLOOR_MS = None


def bound(nbytes: float, ops: float = 0.0):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the float32 operations over their peak rate
    (``bound_ms``, ``bound_by`` "bytes" or "operations"); beside it, the
    launch floor of phase 1 and ``bound_with_launch_ms``: the floor where
    it exceeds that roofline (``bound_with_launch_by`` "launch"), else the
    roofline."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    roof = max(t_bytes, t_ops)
    by = "bytes" if t_bytes >= t_ops else "operations"
    check(LAUNCH_FLOOR_MS is not None, "bound: no launch floor measured")
    return dict(bound_ms=roof, bound_by=by, launch_floor_ms=LAUNCH_FLOOR_MS,
                bound_with_launch_ms=max(roof, LAUNCH_FLOOR_MS),
                bound_with_launch_by="launch" if LAUNCH_FLOOR_MS > roof
                else by)


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

def kernel_device_ms(fn, part: str) -> float:
    """Device ms of the launches of one call of ``fn`` whose name holds
    ``part`` (the profiler, :func:`device_profile`); fails if none ran."""
    got = {name: ms for name, (_, ms) in device_profile(fn).items()
           if part in name}
    check(got, f"the profiler saw no launch named *{part}*")
    return sum(got.values())


def all_device_ms(fn) -> float:
    """Device ms of every launch of one call of ``fn`` (the profiler)."""
    return sum(ms for _, ms in device_profile(fn).values())


# P5's checked lengths beyond the probe's (8, 128): a power of two, the
# bytes-bound size, two ragged ones; and the view at element offset 1.
P5_LENGTHS = (1 << 20, 1 << 26, (1 << 20) + 1, (1 << 20) + 3)
P5_TIMED = 1 << 26
P5_HOST_CALLS = 1000


def phase_p5(device, rng):
    """The toolchain smoke right after the build: the card's launch floor
    (empty kernels back to back from C), P5's probe path (its kernel on the
    probe's (8, 128) shape), then the kernel against its plain version and
    2x + 1 in numpy at every length of ``P5_LENGTHS`` and on a view one
    element into its buffer (not 16-byte aligned); device ms by the
    profiler at (8, 128) against the floor and at 2^26 against the bytes
    bound; the wrapper's host us a call; the events' ms of 200 calls."""
    import torch
    from linkpred_tpu_torch.experiments import pallas_smoke as p5

    global LAUNCH_FLOOR_MS
    floor_us = p5.launch_floor_us(device, 1000)
    LAUNCH_FLOOR_MS = floor_us / 1e3
    print(f"  launch floor: {floor_us:.3f} us a launch (1,000 empty kernels "
          "back to back from C, CUDA events)")
    check(0 < floor_us < 100, f"launch floor {floor_us} us")

    x = torch.arange(1024, dtype=torch.int32, device=device).reshape(8, 128)
    p5.LAUNCHES = 0
    out = p5.affine_smoke(x)
    launches = p5.LAUNCHES
    torch.cuda.synchronize()
    check(torch.equal(out, p5.affine_smoke_reference(x)), "P5: kernel != plain")
    check(np.array_equal(out.cpu().numpy(),
                         np.arange(1024, dtype=np.int32).reshape(8, 128) * 2
                         + 1), "P5: kernel != 2x + 1")

    def wraps(a):
        return (a.astype(np.int64) * 2 + 1).astype(np.int32)

    for n in P5_LENGTHS + ("view",):
        m = (1 << 20) + 5 if n == "view" else n
        host = rng.integers(-(1 << 31), 1 << 31, m).astype(np.int32)
        buf = torch.as_tensor(host, device=device)
        xs, want = (buf[1:], wraps(host[1:])) if n == "view" \
            else (buf, wraps(host))
        if n == "view":
            check(xs.data_ptr() % 16 != 0, "P5: the view is 16-byte aligned")
        got = p5.affine_smoke(xs)
        plain = p5.affine_smoke_reference(xs)
        torch.cuda.synchronize()
        check(torch.equal(got, plain), f"P5: kernel != plain at {n}")
        check(np.array_equal(got.cpu().numpy(), want),
              f"P5: kernel != 2x + 1 (wrapping) at {n}")
        del buf, xs, got, plain
    print(f"  P5: kernel == plain == 2x + 1 at (8, 128), "
          f"{', '.join(str(n) for n in P5_LENGTHS)} and a view at element "
          "offset 1")

    # the library's one call for int32 2x + 1: 1 + 2 * x
    one = torch.ones((), dtype=torch.int32, device=device)

    def library(t):
        return torch.add(one, t, alpha=2)

    check(torch.equal(library(x), out), "P5: torch.add(1, x, alpha=2) != "
          "kernel at (8, 128)")
    ms = kernel_device_ms(lambda: p5.affine_smoke(x), "affine_smoke")
    plain_ms = all_device_ms(lambda: p5.affine_smoke_reference(x))
    library_ms = all_device_ms(lambda: library(x))
    big = torch.as_tensor(rng.integers(-(1 << 31), 1 << 31, P5_TIMED)
                          .astype(np.int32), device=device)
    check(torch.equal(library(big), p5.affine_smoke(big)),
          "P5: torch.add(1, x, alpha=2) != kernel at 2^26")
    big_ms = kernel_device_ms(lambda: p5.affine_smoke(big), "affine_smoke")
    big_plain_ms = all_device_ms(lambda: p5.affine_smoke_reference(big))
    big_library_ms = all_device_ms(lambda: library(big))
    big_bound = bound(8 * P5_TIMED, 2 * P5_TIMED)
    del big
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(P5_HOST_CALLS):
        p5.affine_smoke(x)
    host_us = (time.perf_counter() - t0) * 1e6 / P5_HOST_CALLS
    torch.cuda.synchronize()
    events_ms = cuda_ms(lambda: p5.affine_smoke(x), 200)
    plain_events = cuda_ms(lambda: p5.affine_smoke_reference(x), 200)
    b = bound(2 * x.numel() * 4, 2 * x.numel())
    print(f"  P5 (8, 128): device {ms * 1e3:.3f} us by the profiler against "
          f"the launch floor {floor_us:.3f} us (bytes bound "
          f"{b['bound_ms'] * 1e3:.4f} us); plain {plain_ms * 1e3:.3f} us; "
          f"library (torch.add(1, x, alpha=2)) {library_ms * 1e3:.3f} us; "
          f"the wrapper's host path {host_us:.3f} us a call "
          f"({P5_HOST_CALLS} calls, no sync); events over 200 calls: kernel "
          f"{events_ms:.4f} ms, plain {plain_events:.4f} ms")
    print(f"  P5 2^26 lanes: device {big_ms:.4f} ms by the profiler against "
          f"the bytes bound {big_bound['bound_ms']:.4f} ms "
          f"({100 * big_bound['bound_ms'] / big_ms:.1f}% of it); plain "
          f"{big_plain_ms:.4f} ms; library {big_library_ms:.4f} ms")
    return dict(launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                **b, library_ms=library_ms,
                library_call="torch.add(one, x, alpha=2)", shape="(8, 128)",
                events_ms=events_ms, plain_events_ms=plain_events,
                host_us_per_call=host_us, ms_2e26=big_ms,
                plain_ms_2e26=big_plain_ms,
                library_ms_2e26=big_library_ms,
                bound_ms_2e26=big_bound["bound_ms"])


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
    from linkpred_tpu_torch.utils.profiling import counter, reset_counters
    import torch
    from linkpred_tpu_torch.experiments import pallas_tail as p1

    hi, lo, dpack = (torch.as_tensor(a, device=device)
                     for a in p1.make_stream(rng))
    reset_counters()
    got = p1.pallas_tail(hi, lo, dpack, 0.0)
    launches = counter("k1.launches")
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
    from linkpred_tpu_torch.utils.profiling import counter
    import dataclasses

    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.bench.synth import (planted_partition_graph,
                                                rmat_graph)
    from linkpred_tpu_torch.predict import plan as plan_mod

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
            k_before = counter("k1.killer_launches")
            res[str(dev)] = lt.predict_links_multi(
                g, names, min_degree1=d1, options=opts, plan=p,
                sources=sources, device=dev)
            if dev == device:
                killers = counter("k1.killer_launches") - k_before
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

    kk = api._exact_k(plan, k)
    ts = plan.tile_start
    bounds = [(int(ts[t]), int(ts[t + 1])) for t in range(len(ts) - 1)
              if ts[t] < ts[t + 1]]
    tile_fn, one_pass = lhub_pass(device, plan, y, k)

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


def lhub_pass(device, plan, y, k):
    """The Jaccard tile scorer of the packed ``plan`` and one scoring pass
    over its tiles, as ``predict_links`` runs it (the top-``k`` selection
    included)."""
    from linkpred_tpu_torch.predict import api, scoring

    tile_fn = scoring.tile_scorer(plan.device_stream(device),
                                  metric_names=("jaccard_coefficient",),
                                  n=y.n, **api._pass_kwargs(plan))

    def one_pass():
        return scoring.scan_tiles(tile_fn, plan.tile_start,
                                  api._exact_k(plan, k), 1, plan.cap,
                                  device=device)

    return tile_fn, one_pass


def tile_bytes_a_lane(device, where, p, y, metric_names, indices=None,
                      degrees=None) -> float:
    """C11: the device bytes a lane that one tile of pass ``p`` (its
    fullest) allocates while it runs, beyond what was allocated before it
    (the stream resident): ``max_memory_allocated`` after a reset, less
    ``memory_allocated`` before, over cap; after one warm-up call.  Fails
    if it exceeds ``predict.scoring.TILE_BYTES_PER_LANE``, the figure the
    memory check prices."""
    import torch
    from linkpred_tpu_torch.predict import api, scoring
    from linkpred_tpu_torch.predict.metrics import METRICS

    weighted = any(METRICS[m].needs_weight for m in metric_names)
    tile_fn = scoring.tile_scorer(
        p.device_stream(device, weighted), metric_names=metric_names,
        n=y.n, indices=indices, degrees=degrees, **api._pass_kwargs(p))
    t = int(np.argmax(np.diff(p.tile_start)))
    s, e = int(p.tile_start[t]), int(p.tile_start[t + 1])
    tile_fn(s, e)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    out = tile_fn(s, e)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(device)
    del out
    per_lane = (peak - before) / p.cap
    print(f"  C11 {where}: tile {t} of cap 2^{p.cap.bit_length() - 1}, "
          f"{len(metric_names)} metric(s): {peak - before} B above the "
          f"{before} B resident, {per_lane:.3f} B a lane (priced "
          f"{scoring.TILE_BYTES_PER_LANE})")
    check(per_lane <= scoring.TILE_BYTES_PER_LANE,
          f"C11 {where}: a tile took {per_lane:.3f} B a lane, over the "
          f"{scoring.TILE_BYTES_PER_LANE} that device_bytes prices")
    return per_lane


def phase_main_path(device, scale: int = 19):
    """The LHub main path at RMAT-``scale``.  Returns the K1 and K2
    launches of its run, and (the graph, its tidied deletions, the plan, k)
    for phase 9."""
    from linkpred_tpu_torch.utils.profiling import counter, reset_counters
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.predict.plan import build_plan

    t0 = time.perf_counter()
    y, removed, k, deletions = bench_graph(scale)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_plan(y, 64, device=device)
    plan_ms = (time.perf_counter() - t0) * 1e3
    print(f"  RMAT-{scale}: n={y.n} |E|={y.size} removed={k} "
          f"setup {setup_s:.1f} s; plan: cap {plan.cap}, "
          f"{plan.num_tiles} tiles ({plan.num_tiles_padded} padded), "
          f"{plan.total_slots} slots, plan_ms {plan_ms:.1f}")
    opts = lt.PredictOptions(repeat=5, max_edges=k)

    reset_counters()
    rates, res = [], None
    for _ in range(3):
        res = lt.predict_links(y, "jaccard_coefficient", min_degree1=64,
                               options=opts, plan=plan, device=device)
        rates.append(y.size / (res.scoring_ms / 1e3))
    launches = kernel_launches()
    arms = (counter("select.packed_arm"), counter("select.sort_arm"))

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
    check(counter("k1.killer_launches") == 0,
          "main path: killers on packed tiles")

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

    # C11: the packed tile loop at cap 2^21, Jaccard and all nine metrics
    p21 = build_plan(y, 64, 1 << 21, device=device)
    for names in (("jaccard_coefficient",), ALL_METRICS):
        tile_bytes_a_lane(device, f"packed RMAT-{scale} LHub", p21, y, names)
    del p21
    return launches, (y, deletions, plan, k)


# --------------------------------------------------- phase 6: IHub path

def print_k1_kernels(by_kernel) -> None:
    """K1's line(s) of a profiler table, top ten or not."""
    for name, ms in by_kernel.items():
        if "tail_" in name:
            print(f"    K1: {ms:8.3f} ms  {name[:120]}")


def bench_graph(scale: int):
    """R-MAT at the bench protocol: edge factor 16, seed 42, 0.1|E|
    removed.  Returns (the graph with the edges removed, the removed
    undirected edges as a set of (u < v), k, the tidied deletions)."""
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
    return y, removed, max(deletions.shape[0] // 2, 1), deletions


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


def slot_map_ab(stream, win, cap):
    """The slot map of each tile of ``win``: the new one
    (``scoring._slot_map``) equal to the old formula
    (``experiments.ab_edge3.scatter_slot_map``) on every lane, then
    both timed with CUDA events over the window.  Returns (old, new) ms a
    tile."""
    import torch
    from linkpred_tpu_torch.experiments.ab_edge3 import scatter_slot_map
    from linkpred_tpu_torch.predict import scoring

    fe_work = stream[0]
    iota = torch.arange(cap, dtype=torch.int32, device=fe_work.device)
    for s, e in win:
        new = scoring._slot_map(fe_work, s, e, iota)[3]
        check(torch.equal(new, scatter_slot_map(fe_work, s, e, cap)[1]),
              f"IHub slot map of tile [{s}, {e}) differs from the old "
              "formula's")
    old_ms = cuda_ms(lambda: [scatter_slot_map(fe_work, s, e, cap)
                              for s, e in win], 3)
    new_ms = cuda_ms(lambda: [scoring._slot_map(fe_work, s, e, iota)
                              for s, e in win], 3)
    return old_ms / len(win), new_ms / len(win)


def ihub_tile_split(device, plan, y, indices, degrees, n_win: int = 32):
    """Per-tile time split of the edge stream over a window of ``n_win``
    tiles from the middle of the plan, each part timed alone with CUDA
    events: the slot map and gathers (``edge_keys``), the int64 sort with
    its payload gathers (``keyed_sort``), K1 with killers; and a profiler
    table of the window's whole tiles.  K1 is held against its twin on
    every sorted tile of the window first.  Returns the window's size, the
    split, the profiler's device ms by kernel, the window's wall ms, the
    count of killed runs that cross a K1 tile, and the old and new slot
    map's ms a tile (:func:`slot_map_ab`)."""
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
    slot_ms = slot_map_ab(stream, win, plan.cap)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tiles()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return (len(win), split, device_ms_by_kernel(prof), wall, crossing,
            slot_ms)


def phase_ihub(device, scale: int = 18):
    """IHub at scale: predict_links Jaccard at min_degree1=0 with the
    card's own budgets, which put RMAT-18 on the edge stream."""
    from linkpred_tpu_torch.utils.profiling import counter, reset_counters
    import torch
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.predict import api
    from linkpred_tpu_torch.predict.plan import build_plan

    t0 = time.perf_counter()
    y, removed, k, _ = bench_graph(scale)
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
    reset_counters()
    rates, res = [], None
    for _ in range(3):
        res = lt.predict_links(y, "jaccard_coefficient", min_degree1=0,
                               options=opts, plan=plan, device=device)
        rates.append(y.size / (res.scoring_ms / 1e3))
    launches = kernel_launches()
    killer_launches = counter("k1.killer_launches")
    seg_runs = counter("scan.segments")
    skips = counter("api.warmup_skips")
    # the first call: one warm-up pass and one timed pass; the calls on
    # the same plan after it skip the warm-up and run the timed pass alone
    n_passes = 1 + 3
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
    check(skips == 2, f"IHub: {skips} of the 2 repeat calls on the plan "
          "skipped the warm-up")
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
    n_win, split, by_kernel, wall, crossing, slot_ms = ihub_tile_split(
        device, plan, y, indices, degrees)
    print(f"  K1 with killers == twin on all {n_win} tiles of the window; "
          f"{crossing} killed runs cross a K1 tile there")
    print(f"  slot map old/new ms a tile: {slot_ms[0]:.4f} / "
          f"{slot_ms[1]:.4f} (the scatter-max + cummax over the window, "
          f"the binary search of the tile's rows; equal on every lane of "
          f"all {n_win} tiles)")
    print(f"  edge tile split over {n_win} tiles of cap {plan.cap} (ms per "
          "tile, each part timed alone): " + ", ".join(
              f"{name} {ms:.4f}" for name, ms in split.items()))
    busy = sum(by_kernel.values())
    print(f"  profiler over the window: device busy {busy:.3f} ms of "
          f"{wall:.3f} ms wall ({100 * busy / wall:.1f}%); top device work:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"    {ms:8.3f} ms  {name[:90]}")
    print_k1_kernels(by_kernel)

    # C11: the packed tile loop at cap 2^23 (the hub sub-plan) and the edge
    # tile at cap 2^21 with killers, Jaccard and all nine metrics
    tile_bytes_a_lane(device, f"packed RMAT-{scale} IHub hub sub-plan", hp,
                      y, ("jaccard_coefficient",))
    for names in (("jaccard_coefficient",), ALL_METRICS):
        tile_bytes_a_lane(device, f"edge RMAT-{scale} IHub", plan, y, names,
                          indices, degrees)
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


def p4_stress_offsets():
    """Offsets built to stress the kernel's bands: {name: int32[256]}."""
    n = 256
    edges = np.array([31, 32, 33, 63, 64, 65, 24, 25, 39, 40, 95, 96, 97,
                      479, 480, 481, 503, 504, 0, 1])
    return {
        "all at 0": np.zeros(n),
        "all at 504": np.full(n, 504),
        "clamped (-5, 10^6)": np.resize([-5, 10 ** 6, 17, -5, 10 ** 6, 250],
                                        n),
        "band edges": np.resize(edges, n),
    }


def p4_device_ms(device):
    """P4's device ms a call by the profiler at iters 1 and 32 on the
    probe's inputs: ``{iters: ms}``.  Taken in phase 1: later in the run,
    after the profiled passes of phases 5 and 6, the profiler recorded no
    device event for these calls in any session (seen on the card)."""
    import torch
    from linkpred_tpu_torch.experiments import radix_probe as rp

    offs, xs = (torch.as_tensor(a, device=device)
                for a in rp.dynstore_inputs(np.random.default_rng(5)))
    return {i: kernel_device_ms(lambda: rp.dynstore_run(i, offs, xs),
                                "dynstore") for i in (1, 32)}


def p4_checks(device, radix, dev):
    """P4 against its plain version (and the banded order it applies the
    stores in) at iters 1, 2 and 32, on the probe's inputs and on the
    stress offsets; its grid; device ms queued behind a sleep at iters 1
    and 32, the per-store us from their difference (the radix probe's) and
    from that of the profiler's ms ``dev`` (:func:`p4_device_ms`), and the
    radix arithmetic again with that cost.  Returns P4's row of the record
    (less its launches)."""
    import torch
    from linkpred_tpu_torch.experiments import radix_probe as rp
    from linkpred_tpu_torch.kernels import _build

    ctas = _build.load().lp_dynstore_ctas()
    check(ctas >= 128, f"P4: {ctas} CTAs a launch")
    offs, xs = (torch.as_tensor(a, device=device)
                for a in rp.dynstore_inputs(np.random.default_rng(5)))
    sets = {"probe": offs, **{
        name: torch.as_tensor(o.astype(np.int32), device=device)
        for name, o in p4_stress_offsets().items()}}
    for name, o in sets.items():
        for iters in (1, 2, 32):
            got = rp.dynstore_run(iters, o, xs)
            want = rp.dynstore_reference(iters, o, xs)
            torch.cuda.synchronize()
            check(torch.equal(got, want),
                  f"P4 {name} iters={iters}: kernel != plain")
            if iters < 32:
                check(torch.equal(rp.dynstore_banded(iters, o, xs), want),
                      f"P4 {name} iters={iters}: banded != plain")
    got = rp.dynstore_run(1, offs, xs)
    untouched = int((got == rp.INT32_MIN).all(dim=1).sum())
    queued = {i: queued_ms(lambda: rp.dynstore_run(i, offs, xs), 20)
              for i in (1, 32)}
    per_store_us = (queued[32] - queued[1]) / 31 / rp.NSTORES * 1e3
    dev_per_store_us = (dev[32] - dev[1]) / 31 / rp.NSTORES * 1e3
    p4 = dict(ms=dev[32],
              plain_ms=cuda_ms(lambda: rp.dynstore_reference(32, offs, xs),
                               2),
              **bound(4 * (rp.NSTORES + 2 * rp.ROWS * rp.COLS),
                      32 * rp.NSTORES * rp.BLK * rp.COLS),
              ms_iters1=dev[1], queued_ms_iters1=queued[1],
              queued_ms_iters32=queued[32], per_store_us=per_store_us,
              device_per_store_us=dev_per_store_us, ctas=ctas)
    print(f"  P4 dynstore (512, 128), 256 stores, {ctas} CTAs: kernel == "
          f"plain (and the banded order == plain at iters 1, 2) at iters 1, "
          f"2, 32 on the probe's offsets ({untouched} rows untouched) and on "
          f"{', '.join(list(sets)[1:])}")
    print(f"  P4 device ms a call by the profiler: iters 1 {dev[1]:.5f}, "
          f"iters 32 {dev[32]:.5f}; queued behind a sleep (the fill "
          f"included): {queued[1]:.5f}, {queued[32]:.5f}; per store "
          f"{per_store_us:.6f} us queued, {dev_per_store_us:.6f} us by the "
          f"profiler, {radix['per_store_us']:.6f} us in the probe's own run;"
          f" plain {p4['plain_ms']:.4f} ms at iters 32; bytes bound "
          f"{p4['bound_ms'] * 1e3:.4f} us, launch floor "
          f"{p4['launch_floor_ms'] * 1e3:.3f} us")
    rp.radix_arithmetic(RADIX_LOG2, radix["sort_ms"], radix["pack_ms"],
                        per_store_us)
    return p4


def phase_sort_probes(device, rng, p4_dev):
    """The sort-feasibility probes: P2 and P3 (the bitonic kernel) and the
    radix probe (its sort and 1-bit split columns and P4, the dynamic-store
    kernel), each driven through its ``run``/``main`` with the launch
    counts zeroed just before and read just after; then each kernel against
    its plain version, and the timings beside the bounds."""
    from linkpred_tpu_torch.utils.profiling import counter, reset_counters
    import torch
    from linkpred_tpu_torch.experiments import pallas_bitonic as p2
    from linkpred_tpu_torch.experiments import pallas_bitonic2 as p3
    from linkpred_tpu_torch.experiments import radix_probe as rp
    from linkpred_tpu_torch.ops import compact

    # the probes' paths: P2/P3 at 2^18 (where the TPU measured them) and at
    # the engine's tile sizes; the radix probe at its own 2^21 lanes
    p2.LAUNCHES = p3.LAUNCHES = rp.LAUNCHES = 0
    reset_counters()
    for m in SORT_SIZES:
        p2.run(m, payload=True, device=device)
        p3.run(m, device=device)
    # ten calls per timing: with the probe's three, one slow first call of
    # make_run(1) skewed (t_8 - t_1) / 7 by a third on the card
    radix = rp.main(["--lanes-log2", str(RADIX_LOG2), "--repeat", "10"])
    launches = {"make_pallas_sort": p2.LAUNCHES, "make_sort": p3.LAUNCHES,
                "dynstore_run": rp.LAUNCHES,
                "pack_survivors": counter("k2.launches")}
    print(f"  launches in the probes' paths: {launches}")
    check(all(v > 0 for v in launches.values()),
          f"sort probes: a kernel never launched: {launches}")
    p4 = p4_checks(device, radix, p4_dev)

    timed, per_sort = {}, {}
    for m in CHECK_SIZES:
        x, pay, per_sort[f"2^{m}"] = bitonic_vs_plain(device, rng, m)
        if m in TIMED_SIZES:
            timed[m] = time_bitonic(device, x, pay, per_sort[f"2^{m}"])
        del x, pay
    check(per_sort["2^20"] <= 16,
          f"bitonic: {per_sort['2^20']} grid launches per 2^20 sort")

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
                          probe_per_store_us=radix["per_store_us"]))
    return p2_row, p3_row, p4_row, launches["pack_survivors"]


# ------------------------------------------ phase 8: the experiment driver

# Phase 8's sweeps: one batch repeat and one timed pass for the planted
# graph and the subprocess; RMAT-18 takes two fractions and the reference's
# repeat-method 5.
DRIVER_SWEEP = ["--repeat-batch", "1", "--repeat-method", "1"]
RMAT_DRIVER = ["--degrees", "4,64", "--deletions-begin", "0.01",
               "--deletions-end", "0.1", "--repeat-batch", "1",
               "--repeat-method", "5", "--seed", "42"]


def nonempty_tiles(plan) -> int:
    """The tiles of ``plan`` and its sub-plans that hold slots: one K1
    launch each in every scoring pass."""
    from linkpred_tpu_torch.predict import api

    return sum(int(np.count_nonzero(np.diff(p.tile_start) > 0))
               for p in (plan, *api._sub_plans(plan)))


class DriverProbe:
    """Instruments one run of the experiment driver by wrapping what the
    harness and the CLI call: per result row, the predicted pairs tied with
    the k-th score and the counts behind precision and recall; per plan,
    its hub threshold and non-empty tiles (sub-plans included); per batch,
    the host time of sample + tidy + apply and the device memory allocated
    right after the batch's plan cache is cleared; the ``read_mtx`` wall
    time.  Restores every wrapped name on exit."""

    def __init__(self, device):
        self.device = device
        self.ties, self.counts, self.batch_s, self.mem = [], [], [], []
        # id -> weak reference of each plan seen: a plan freed after its
        # batch may leave its id to the next batch's plan, which is new
        self.plans, self._seen = [], {}
        self.read_s = None
        self._saved = []

    def _patch(self, mod, name, fn):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def __enter__(self):
        import torch
        from linkpred_tpu_torch import cli
        from linkpred_tpu_torch.bench import harness as h

        multi, single, common = (h.predict_links_multi, h.predict_links,
                                 h.common_pair_count)
        dels, apply, read, cache = (h.generate_edge_deletions, h.apply_batch,
                                    cli.read_mtx, h.PlanCache)
        probe, t_batch = self, []

        def ties(res, k):
            if not len(res) or len(res) < k:
                return 0
            return int(np.count_nonzero(res.score
                                        <= res.score[-1] * (1 + 1e-5)))

        def rec_multi(g, metrics, **kw):
            out = multi(g, metrics, **kw)
            probe.ties += [ties(out[m], kw["options"].max_edges)
                           for m in metrics]
            return out

        def rec_single(g, metric, **kw):
            out = single(g, metric=metric, **kw)
            probe.ties.append(ties(out, kw["options"].max_edges))
            return out

        def rec_common(a, b):
            c = common(a, b)
            probe.counts.append((c, a.shape[0], b.shape[0]))
            return c

        def rec_dels(*a, **kw):
            t_batch.append(time.perf_counter())
            return dels(*a, **kw)

        def rec_apply(*a, **kw):
            out = apply(*a, **kw)
            probe.batch_s.append(time.perf_counter() - t_batch.pop())
            return out

        def rec_read(*a, **kw):
            t0 = time.perf_counter()
            out = read(*a, **kw)
            probe.read_s = time.perf_counter() - t0
            return out

        class Cache(cache):
            def get(self, g, min_degree1, *a, **kw):
                plan = super().get(g, min_degree1, *a, **kw)
                seen = probe._seen.get(id(plan))
                if seen is None or seen() is not plan:
                    probe._seen[id(plan)] = weakref.ref(plan)
                    probe.plans.append((min_degree1, nonempty_tiles(plan)))
                return plan

            def clear(self):
                super().clear()
                probe.mem.append(torch.cuda.memory_allocated(probe.device)
                                 if torch.device(probe.device).type == "cuda"
                                 else 0)

        for mod, name, fn in ((h, "predict_links_multi", rec_multi),
                              (h, "predict_links", rec_single),
                              (h, "common_pair_count", rec_common),
                              (h, "generate_edge_deletions", rec_dels),
                              (h, "apply_batch", rec_apply),
                              (h, "PlanCache", Cache),
                              (cli, "read_mtx", rec_read)):
            self._patch(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        return False


def run_cli(argv):
    """``cli.main(argv)`` in this process with its standard output
    captured; returns the log's text."""
    import contextlib
    import io

    from linkpred_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    check(rc == 0, f"cli.main({argv}) returned {rc}")
    return out.getvalue()


def rows_match(where, got, p_got, want, p_want, tag=None):
    """Rows of two runs of one sweep, row by row: the same fractions,
    thread label and technique (``tag``: the ``(got, want)`` backend tags
    where they differ); the same removed and predicted pair counts; common
    pairs equal or apart by no more than twice the pairs tied with the k-th
    score (each side may pick others among those).  Returns how many rows
    differ within that allowance."""
    check(len(got) == len(want) == len(p_got.counts) == len(p_want.counts)
          == len(p_got.ties) == len(p_want.ties) > 0,
          f"{where}: {len(got)} against {len(want)} rows")
    differ = 0
    for i, (a, b) in enumerate(zip(got, want)):
        tech = b["technique"] if tag is None else \
            b["technique"].replace(tag[1], tag[0])
        for f in ("batch_deletions_fraction", "batch_insertions_fraction",
                  "num_threads"):
            check(a[f] == b[f], f"{where} row {i}: {f} {a[f]} != {b[f]}")
        check(a["technique"] == tech,
              f"{where} row {i}: {a['technique']} != {tech}")
        (ca, da, ia), (cb, db, ib) = p_got.counts[i], p_want.counts[i]
        check((da, ia) == (db, ib),
              f"{where} {tech}: removed/predicted pairs {da, ia} != {db, ib}")
        allow = 2 * max(p_got.ties[i], p_want.ties[i])
        check(abs(ca - cb) <= allow, f"{where} {tech}: common pairs {ca} "
              f"against {cb}, beyond the {allow} the k-th score's ties allow")
        differ += ca != cb
    return differ


def phase_driver_vs_plain(device, tmp):
    """Part (a): ``cli.main`` on the card against ``run_experiment`` on
    the CPU (the kernels' plain versions), same seed, all 9 metrics, hub
    thresholds 0, 4, 64, one deletion fraction, on a planted-partition
    graph of 2,000 vertices written by the port's ``write_mtx``.  Returns
    the K1 and K2 launches of the card's run and the graph's path."""
    from linkpred_tpu_torch.utils.profiling import reset_counters
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.bench import harness
    from linkpred_tpu_torch.bench.synth import planted_partition_graph
    from linkpred_tpu_torch.ops.transform import remove_self_loops

    # 2 tiles of 2^20 slots at thresholds 0 and 64 (4 padded): the
    # selection buffer reaches the survivor pack's 2^22 lanes
    g = planted_partition_graph(20, 100, p_in=0.3, p_out=0.0005, seed=3)
    path = os.path.join(tmp, "planted.mtx")
    lt.write_mtx(g, path)
    sweep = ["--degrees", "0,4,64", "--deletions-begin", "0.1",
             "--deletions-end", "0.1", "--seed", "7", *DRIVER_SWEEP]

    reset_counters()
    with DriverProbe(device) as p_card:
        log = run_cli([path, "1", "0", "--jsonl", "--device", device.type,
                       *sweep])
    launches = kernel_launches()
    got = [json.loads(ln) for ln in log.splitlines() if ln.startswith("{")]

    y = remove_self_loops(lt.read_mtx(path))
    cfg = harness.ExperimentConfig(
        repeat_batch=1, repeat_method=1, deletions_begin=0.1,
        deletions_end=0.1, degrees=(0, 4, 64), seed=7, device="cpu")
    with DriverProbe("cpu") as p_cpu:
        want = harness.run_experiment(y, cfg, emit=lambda _: None)
    differ = rows_match("driver (a) card against CPU", got, p_card, want,
                        p_cpu)
    check(len(got) == 9 * 3, f"driver (a): {len(got)} rows, not 27")
    check(max(r["recall"] for r in got) > 0,
          "driver (a): every recall is zero")
    check(all(v > 0 for v in launches.values()),
          f"driver (a): a kernel never launched: {launches}")
    best = max(got, key=lambda r: r["recall"])
    print(f"  planted(20 x 100): n={g.n} |E|={g.m}; cli.main --device "
          f"{device.type} "
          f"== run_experiment on the CPU in {len(got)} rows (all 9 metrics "
          f"x thresholds 0, 4, 64; {differ} rows apart within the k-th "
          f"score's ties); best recall {best['recall']:.6g} "
          f"({best['technique']}); launches {launches}")
    return launches, path


def phase_driver_rmat(device, tmp, scale: int = 18):
    """Part (b): ``cli.main`` on R-MAT-``scale`` at the bench protocol's
    generator (edge factor 16, seed 42), written as pattern/general MTX of
    its upper triangle, so the driver's symmetrize runs; all 9 metrics,
    thresholds 4 and 64, deletion fractions 0.01 and 0.1, repeat-method 5;
    fused, then ``--unfused``.  Both logs go through the port's
    post-processor.  Returns the K1 and K2 launches of both runs."""
    from linkpred_tpu_torch.utils.profiling import reset_counters
    import torch
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.bench import process
    from linkpred_tpu_torch.bench.synth import rmat_graph
    from linkpred_tpu_torch.graph import edge_list

    t_phase = time.perf_counter()
    g = rmat_graph(scale, edge_factor=16, seed=42)
    src, dst = edge_list(g)
    name = f"rmat{scale}"
    path = os.path.join(tmp, f"{name}.mtx")
    t0 = time.perf_counter()
    lt.write_mtx(lt.from_edges(src[src < dst], dst[src < dst], n=g.n), path)
    print(f"  RMAT-{scale}: n={g.n} |E|={g.m}; its upper triangle written "
          f"as pattern/general MTX ({os.path.getsize(path)} bytes) in "
          f"{time.perf_counter() - t0:.1f} s")

    launches = {"fused_tail": 0, "pack_survivors": 0}
    runs = {}
    for mode in ("fused", "unfused"):
        extra = ["--unfused"] if mode == "unfused" else []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counters()
        with DriverProbe(device) as probe:
            t0 = time.perf_counter()
            log = run_cli([path, "0", "0", "--device", device.type,
                           *RMAT_DRIVER, *extra])
            wall = time.perf_counter() - t0
        got = kernel_launches()
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
        log_path = os.path.join(tmp, f"{name}-{mode}.log")
        with open(log_path, "w") as f:
            f.write(log)
        csv_path = os.path.join(tmp, f"{name}-{mode}.csv")
        check(process.main(["csv", log_path, csv_path]) == 0,
              f"driver (b) {mode}: the post-processor failed")
        data = process.read_log(log_path)
        check(list(data) == [name], f"driver (b) {mode}: graphs {list(data)}")
        rows = data[name]
        with open(csv_path) as f:
            csv_rows = f.read().count("\n") - 1
        check(len(rows) == csv_rows == 36,
              f"driver (b) {mode}: {len(rows)} rows, {csv_rows} in the CSV, "
              "not 36 (9 metrics x 2 thresholds x 2 fractions)")
        check(all(r["order"] == g.n and r["size"] == g.m for r in rows),
              f"driver (b) {mode}: order/size not {g.n}/{g.m}")
        check(all(0 <= r[f] <= 1 for r in rows for f in ("precision",
                                                          "recall")),
              f"driver (b) {mode}: precision or recall outside [0, 1]")
        check(max(r["recall"] for r in rows) > 0,
              f"driver (b) {mode}: every recall is zero")
        check(all(v > 0 for v in got.values()),
              f"driver (b) {mode}: a kernel never launched: {got}")
        # one K1 launch per non-empty tile in each of a call's 6 passes (1
        # warm-up + repeat-method 5); unfused, each metric is its own call
        calls = 9 if mode == "unfused" else 1
        tiles = sum(t for _, t in probe.plans)
        check(got["fused_tail"] == calls * 6 * tiles,
              f"driver (b) {mode}: {got['fused_tail']} K1 launches, not "
              f"{calls} x 6 x {tiles} tiles")
        check(len(probe.mem) == 2 and probe.mem[1] <= probe.mem[0],
              f"driver (b) {mode}: device memory after each epoch "
              f"{probe.mem} grew")
        # the counts behind the log's 4-digit precision and recall
        full = [dict(r, precision=c / max(i, 1), recall=c / max(d, 1))
                for r, (c, d, i) in zip(rows, probe.counts)]
        check(all(f"{r['precision']:.3e}" == f"{x['precision']:.3e}"
                  and f"{r['recall']:.3e}" == f"{x['recall']:.3e}"
                  for r, x in zip(rows, full)),
              f"driver (b) {mode}: logged precision/recall != the counts'")
        runs[mode] = (full, probe)
        for k in launches:
            launches[k] += got[k]
        print(f"  {mode}: cli.main wall {wall:.3f} s; read_mtx "
              f"{probe.read_s:.3f} s; host batch (sample, tidy, apply) per "
              f"epoch {', '.join(f'{s:.3f}' for s in probe.batch_s)} s; "
              f"device memory after each epoch "
              f"{', '.join(str(m) for m in probe.mem)} B, peak "
              f"{peak_gb:.3f} GB; launches {got}; non-empty tiles by "
              f"threshold {probe.plans}; 36 rows (total ms / scoring ms):")
        for i in range(0, 36, 3):
            print("    " + "; ".join(
                f"{r['technique']} @{r['batch_insertions_fraction']:g}: "
                f"{r['total_time']:.1f} / {r['scoring_time']:.1f}"
                for r in rows[i:i + 3]))
        best = max(full, key=lambda r: r["recall"])
        print(f"    best recall {best['recall']:.6g} ({best['technique']} at "
              f"{best['batch_insertions_fraction']:g})")
    differ = rows_match("driver (b) fused against unfused", *runs["fused"],
                        *runs["unfused"], tag=("CudaFused", "Cuda"))
    print(f"  fused == unfused in precision and recall in 36 rows ({differ} "
          "apart within the k-th score's ties); part (b) wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    return launches


def run_file(argv, env=None, timeout: int = 600):
    """``python argv...`` from the repository's root as a subprocess; it
    must exit 0.  Returns (its standard output, wall seconds)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, *argv], cwd=here, env=env,
                       capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"python {' '.join(argv)}: rc {r.returncode}: "
          f"{r.stdout[-2000:]} {r.stderr[-3000:]}")
    return r.stdout, wall


def run_module(argv, env=None, timeout: int = 600):
    """``python -m argv...``, as :func:`run_file`."""
    return run_file(["-m", *argv], env, timeout)


def phase_driver_subprocess(path):
    """Part (c): the real entry point, ``python -m linkpred_tpu_torch``,
    as a subprocess on the card; its log must parse."""
    from linkpred_tpu_torch.bench import process

    out, wall = run_module([
        "linkpred_tpu_torch", path, "1", "0", "--metrics", "cn,aa",
        "--degrees", "0,32", "--deletions-begin", "0.05", "--deletions-end",
        "0.05", "--seed", "5", *DRIVER_SWEEP])
    log_path = os.path.splitext(path)[0] + "-subprocess.log"
    with open(log_path, "w") as f:
        f.write(out)
    rows = process.read_log(log_path).get("planted", [])
    check(len(rows) == 4 and all(r["technique"].endswith(("CudaFused0",
                                                          "CudaFused32"))
                                 for r in rows),
          f"python -m linkpred_tpu_torch: rows {rows}")
    print(f"  python -m linkpred_tpu_torch planted.mtx 1 0 --metrics cn,aa "
          f"--degrees 0,32: rc 0 in {wall:.1f} s, 4 rows parsed")


def phase_driver(device):
    """The experiment driver on the card, parts (a)-(c).  Returns the K1
    and K2 launches of the driver's runs in this process."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        a, path = phase_driver_vs_plain(device, tmp)
        b = phase_driver_rmat(device, tmp)
        phase_driver_subprocess(path)
    return {k: a[k] + b[k] for k in a}


# ------------------------------ phase 9: the bench leg, the experiment layer

# The bench row's keys, in bench.py's order, on a card in the peak table.
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline", "engine", "samples",
              "rate_min", "rate_max", "hbm_model_bytes",
              "achieved_gbps_min_model", "hbm_peak_gbps", "frac_of_peak"]
# Part (d)'s sweep: two synthetic graphs beside the planted MTX, three
# metrics, IHub and LHub at 64, one fraction, one timed pass.
SWEEP_ARGS = ["--synthetic", "ppart:20:100,rmat:14:16", "--metrics",
              "cn,jaccard,aa", "--degrees", "0,64", "--deletions-begin",
              "0.1", "--deletions-end", "0.1", "--repeat-batch", "1",
              "--repeat-method", "1", "--seed", "7"]
SWEEP_GRAPHS = ["planted", "ppart_c20_s100", "rmat_s14_e16"]


def bench_env(**knobs):
    """This process's environment without its ``BENCH_*`` knobs, plus
    ``knobs``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(knobs)
    return env


def bench_row(out: str, where: str) -> dict:
    """The bench row: the last line of ``out``, with bench.py's keys."""
    row = json.loads(out.strip().splitlines()[-1])
    check(list(row) == BENCH_KEYS, f"{where}: keys {list(row)}")
    check(row["engine"] == "key64", f"{where}: engine {row['engine']}")
    check(0 < row["rate_min"] <= row["value"] <= row["rate_max"],
          f"{where}: median outside its samples' spread")
    return row


def phase_bench_row(device, tmp, main_path, scale):
    """Part (a): ``bench.run.main()`` in this process at phase 5's scale,
    its graph cache seeded with phase 5's graph and deletions (the same
    protocol), so nothing is made twice; then ``python -m
    linkpred_tpu_torch.bench.run`` on that cache in a process of its own.
    Returns the K1 and K2 launches of the in-process run."""
    from linkpred_tpu_torch.utils.profiling import reset_counters
    import contextlib
    import io

    from linkpred_tpu_torch.bench import run
    from linkpred_tpu_torch.utils import roofline

    y, deletions, plan, _ = main_path
    cache = os.path.join(tmp, "bench_cache")
    run.write_cache(cache, scale, y, deletions)
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("BENCH_")}
    os.environ.update(BENCH_SCALE=str(scale), BENCH_CACHE_DIR=cache)
    out = io.StringIO()
    reset_counters()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = run.main()
        wall = time.perf_counter() - t0
    finally:
        for k in ("BENCH_SCALE", "BENCH_CACHE_DIR"):
            os.environ.pop(k)
        os.environ.update(saved)
    launches = kernel_launches()
    check(rc == 0, f"bench (a): main() returned {rc}")
    row = bench_row(out.getvalue(), "bench (a)")
    check(row["metric"] == f"lhub_jaccard_coefficient_deg64_rmat{scale}_rate",
          f"bench (a): metric {row['metric']}")
    check(plan.packed, "bench (a): phase 5's plan is not packed")
    mb = roofline.packed_pass_min_bytes(int(plan.tile_slot_start[-1]),
                                        deg16=plan.deg16)
    check(row["hbm_model_bytes"] == mb,
          f"bench (a): model bytes {row['hbm_model_bytes']} != {mb}")
    peak = roofline.device_peak_gbps(device)
    check(peak is not None and row["hbm_peak_gbps"] == peak,
          f"bench (a): peak {row['hbm_peak_gbps']} != the table's {peak}")
    check(0 < row["frac_of_peak"] <= 1.05,
          f"bench (a): frac_of_peak {row['frac_of_peak']}")
    check(all(v > 0 for v in launches.values()),
          f"bench (a): a kernel never launched: {launches}")
    print(f"  bench.run.main() at RMAT-{scale} in this process: {wall:.1f} s "
          f"(cache read, plan, {row['samples']} samples); launches "
          f"{launches}; the row and the card:")
    print("  " + json.dumps(row))
    print("  " + card_line())
    # the same row from a process of its own on the same cache: what a
    # user's `python -m linkpred_tpu_torch.bench.run` measures
    env = bench_env(BENCH_SCALE=str(scale), BENCH_CACHE_DIR=cache)
    stamp = os.stat(run.cache_path(cache, scale)).st_mtime_ns
    out, wall = run_module(["linkpred_tpu_torch.bench.run"], env)
    fresh = bench_row(out, "bench (a) subprocess")
    check(os.stat(run.cache_path(cache, scale)).st_mtime_ns == stamp
          and fresh["metric"] == row["metric"]
          and fresh["hbm_model_bytes"] == mb,
          f"bench (a) subprocess: row {fresh}")
    print(f"  python -m linkpred_tpu_torch.bench.run at RMAT-{scale} on the "
          f"same cache: rc 0 in {wall:.1f} s; the row:")
    print("  " + json.dumps(fresh))
    return launches


def phase_bench_subprocess(tmp):
    """Part (b): ``python -m linkpred_tpu_torch.bench.run`` as a
    subprocess at RMAT-14 on an empty cache dir (the synthesis and the
    cache write run), then again on the same dir (the cache is read: the
    file is not written again)."""
    from linkpred_tpu_torch.bench import run

    cache = os.path.join(tmp, "bench_cache14")
    env = bench_env(BENCH_SCALE="14", BENCH_CACHE_DIR=cache)
    argv = ["linkpred_tpu_torch.bench.run"]
    out, wall = run_module(argv, env)
    first = bench_row(out, "bench (b) first run")
    path = run.cache_path(cache, 14)
    check(os.path.exists(path), "bench (b): the first run wrote no cache")
    stamp = os.stat(path).st_mtime_ns
    out, wall2 = run_module(argv, env)
    second = bench_row(out, "bench (b) second run")
    check(os.stat(path).st_mtime_ns == stamp,
          "bench (b): the second run made the graph again")
    check(first["metric"] == second["metric"]
          == "lhub_jaccard_coefficient_deg64_rmat14_rate"
          and first["hbm_model_bytes"] == second["hbm_model_bytes"],
          f"bench (b): rows {first} / {second}")
    print(f"  python -m linkpred_tpu_torch.bench.run, BENCH_SCALE=14: rc 0 "
          f"in {wall:.1f} s (made and cached), {wall2:.1f} s (cache read); "
          f"{first['value']:.6e} / {second['value']:.6e} edges/s, "
          f"{first['hbm_model_bytes']} model bytes in both")


def phase_models(device, tmp):
    """Part (c): ``all_models(degrees=(0, 4, 64))`` on the card against
    the same zoo on the CPU, on the planted graph of phase 8 (a) written as
    MTX and read back.  Returns the graph's path."""
    from linkpred_tpu_torch.utils.profiling import reset_counters
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.bench.synth import planted_partition_graph
    from linkpred_tpu_torch.models import all_models
    from linkpred_tpu_torch.ops.transform import remove_self_loops

    g = planted_partition_graph(20, 100, p_in=0.3, p_out=0.0005, seed=3)
    path = os.path.join(tmp, "planted.mtx")
    lt.write_mtx(g, path)
    y = remove_self_loops(lt.read_mtx(path))
    k = int(0.1 * y.size / 2)
    card = all_models(degrees=(0, 4, 64), device=device.type)
    cpu = all_models(degrees=(0, 4, 64), device="cpu")
    reset_counters()
    rows, t_card, t_cpu = [], 0.0, 0.0
    for p, q in zip(card, cpu):
        check(p.name == q.name and p.name.endswith(f"Cuda{p.min_degree1}"),
              f"models (c): names {p.name}, {q.name}")
        t0 = time.perf_counter()
        a = p.predict(y, max_edges=k)
        t1 = time.perf_counter()
        b = q.predict(y, max_edges=k)
        t_card += t1 - t0
        t_cpu += time.perf_counter() - t1
        same_result(a, b, lt.METRICS[p.metric], f"models (c) {p.name}")
        rows.append(len(a))
    launches = kernel_launches()
    check(len(card) == 27 and {p.min_degree1 for p in card} == {0, 4, 64},
          f"models (c): {len(card)} predictors")
    check(all(v > 0 for v in launches.values()),
          f"models (c): a kernel never launched: {launches}")
    print(f"  all_models(degrees=(0, 4, 64)): {len(card)} predictors on "
          f"{device.type} == on the CPU (k = {k}; rows by threshold 0/4/64: "
          f"{rows[:3]}); card {t_card:.1f} s, CPU {t_cpu:.1f} s; launches "
          f"{launches}")
    return path


def phase_sweep(device, tmp, planted):
    """Part (d): ``python -m linkpred_tpu_torch.bench.sweep`` on the card
    as a subprocess (the planted MTX, ``ppart:20:100`` and RMAT-14), again
    with ``--resume``, and ``--suite reference --allow-missing`` on a data
    dir holding one small graph as coAuthorsDBLP; then ``run_sweep`` in
    this process on the card against the CPU."""
    from linkpred_tpu_torch.utils.profiling import reset_counters
    import contextlib
    import io

    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.bench import harness, process, sweep
    from linkpred_tpu_torch.bench.synth import planted_partition_graph

    out_dir = os.path.join(tmp, "sweep")
    argv = ["linkpred_tpu_torch.bench.sweep", "--graphs", planted,
            *SWEEP_ARGS, "--out-dir", out_dir]
    _, wall = run_module(argv)
    log_path = os.path.join(out_dir, "sweep.log")
    data = process.read_log(log_path)
    check(list(data) == SWEEP_GRAPHS, f"sweep (d): graphs {list(data)}")
    with open(os.path.join(out_dir, "sweep.csv")) as f:
        check(f.read().count("\n") - 1 == 18, "sweep (d): sweep.csv rows")
    for name, rows in data.items():
        with open(os.path.join(out_dir, f"{name}.csv")) as f:
            n_csv = f.read().count("\n") - 1
        check(len(rows) == n_csv == 6, f"sweep (d) {name}: {len(rows)} "
              f"rows, {n_csv} in its CSV, not 6 (3 metrics x 2 thresholds)")
        check(all(r["technique"].endswith(("CudaFused0", "CudaFused64"))
                  and 0 <= r["precision"] <= 1 and 0 <= r["recall"] <= 1
                  for r in rows), f"sweep (d) {name}: rows {rows}")
        check(max(r["recall"] for r in rows) > 0,
              f"sweep (d) {name}: every recall is zero")
    with open(log_path) as f:
        n_lines = len(f.read().splitlines())
    out, wall2 = run_module([*argv, "--resume"])
    check(all(f"skipping {name}" in out for name in SWEEP_GRAPHS),
          "sweep (d): --resume did not skip every graph")
    with open(log_path) as f:
        check(len(f.read().splitlines()) == n_lines,
              "sweep (d): --resume added lines")

    data_dir = os.path.join(tmp, "suite_data")
    os.makedirs(data_dir)
    lt.write_mtx(planted_partition_graph(4, 25, p_in=0.4, p_out=0.01,
                                         seed=5),
                 os.path.join(data_dir, "coAuthorsDBLP.mtx"))
    suite_out = os.path.join(tmp, "suite_out")
    _, wall3 = run_module([
        "linkpred_tpu_torch.bench.sweep", "--suite", "reference",
        "--data-dir", data_dir, "--allow-missing", "--out-dir", suite_out,
        "--metrics", "jaccard", "--degrees", "0,8", "--repeat-batch", "1",
        "--repeat-method", "1", "--deletions-begin", "0.1",
        "--deletions-end", "0.1", "--seed", "7"])
    with open(os.path.join(suite_out, "f1_report.json")) as f:
        report = json.load(f)
    with open(os.path.join(suite_out, "sweep.log")) as f:
        suite_log = f.read()
    check(set(report) == {"ihub@0.1", "lhub@0.1"}
          and "coAuthorsDBLP" in suite_log
          and "(symmetrize)" not in suite_log,
          f"sweep (d) suite: report {report}")
    print(f"  python -m linkpred_tpu_torch.bench.sweep on {SWEEP_GRAPHS}: rc "
          f"0 in {wall:.1f} s, 18 rows (6 a graph, one CSV each); --resume "
          f"skipped all three in {wall2:.1f} s; --suite reference "
          f"--allow-missing on coAuthorsDBLP: f1_report.json "
          f"{json.dumps(report)} in {wall3:.1f} s")

    runs = {}
    for side, dev in (("card", device.type), ("cpu", "cpu")):
        cfg = harness.ExperimentConfig(
            repeat_batch=1, repeat_method=1, deletions_begin=0.1,
            deletions_end=0.1, metrics=("cn", "jaccard", "aa"),
            degrees=(0, 64), seed=7, device=dev)
        reset_counters()
        with DriverProbe(dev) as probe, \
                contextlib.redirect_stdout(io.StringIO()):
            path = sweep.run_sweep([planted], cfg,
                                   os.path.join(tmp, f"run_sweep_{side}"))
        launches = kernel_launches()
        runs[side] = (process.read_log(path)["planted"], probe)
        if side == "card":
            check(all(v > 0 for v in launches.values()),
                  f"sweep (d) run_sweep: a kernel never launched: {launches}")
            card_launches = launches
    differ = rows_match("sweep (d) run_sweep card against CPU",
                        *runs["card"], *runs["cpu"])
    print(f"  run_sweep on the planted graph: {device.type} == cpu in "
          f"precision and recall in {len(runs['cpu'][0])} rows ({differ} "
          f"apart within the k-th score's ties); launches {card_launches}")


def phase_npz_profile(device, tmp, main_path):
    """Part (e): phase 5's graph through ``save_graph``/``load_graph``,
    field for field; ``profile_fn`` around one pass of the LHub main
    path, K1 among its kernel rows."""
    import torch
    from linkpred_tpu_torch.io import npz
    from linkpred_tpu_torch.utils import profiling

    y, _, plan, k = main_path
    path = os.path.join(tmp, "rmat.npz")
    t0 = time.perf_counter()
    npz.save_graph(y, path)
    t1 = time.perf_counter()
    back = npz.load_graph(path)
    t2 = time.perf_counter()
    for f in ("offsets", "indices", "degrees"):
        a, b = getattr(back, f), getattr(y, f)
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"npz (e): {f} differs after the round trip")
    check((back.n, back.m, back.weights, back.values)
          == (y.n, y.m, None, None), "npz (e): n, m, weights or values")
    print(f"  npz: RMAT n={y.n} |E|={y.m} saved in {t1 - t0:.3f} s "
          f"({os.path.getsize(path)} bytes), loaded in {t2 - t1:.3f} s, "
          "equal field for field")

    _, one_pass = lhub_pass(device, plan, y, k)
    one_pass()
    torch.cuda.synchronize()
    # a profiler session that records no device event (seen on the card)
    # makes profile_fn raise; a fresh session is tried, as device_profile
    # does, and the third such session fails the run
    for attempt in range(3):
        try:
            _, summary = profiling.profile_fn(one_pass, top=10_000)
            break
        except RuntimeError as e:
            check(attempt < 2 and "no device event" in str(e), str(e))
            print(f"  profile_fn: {e}; a new session")
    print("  profile_fn around one LHub pass, top 10 rows (ms):")
    for name, ms, on_card in summary[:10]:
        print(f"    {ms:9.3f}  {'card' if on_card else 'host'}  {name[:100]}")
    k1 = [(name, ms) for name, ms, on_card in summary
          if on_card and "tail_onepass" in name]
    check(k1, "profile_fn: no tail_onepass (K1) row among the kernels")
    for name, ms in k1:
        print(f"    K1: {ms:9.3f} ms  {name[:100]}")


def phase_bench_layer(device, main_path, scale):
    """The bench leg and the experiment layer on the card, parts (a)-(e).
    Returns the K1 and K2 launches of the bench row's run, part (a)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launches = phase_bench_row(device, tmp, main_path, scale)
        t1 = time.perf_counter()
        phase_bench_subprocess(tmp)
        t2 = time.perf_counter()
        planted = phase_models(device, tmp)
        t3 = time.perf_counter()
        phase_sweep(device, tmp, planted)
        t4 = time.perf_counter()
        phase_npz_profile(device, tmp, main_path)
        t5 = time.perf_counter()
    print(f"  phase 9 parts: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
          f"(c) {t3 - t2:.1f} s, (d) {t4 - t3:.1f} s, (e) {t5 - t4:.1f} s")
    return launches


# ------------------------------- phase 10: host layer and device helpers

# Phase 10's device helpers at the sizes users run them: the xorshift lanes
# and the scatter_or ids (with duplicates: ids drawn from 2^20 slots).
HELPER_LANES = 1 << 24
SCATTER_SLOTS = 1 << 20
TOPK_CANDIDATES = 1 << 21


def wall_ms(fn):
    """``fn()`` and its host-clock milliseconds, the device synchronised
    before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_host_bfs(device, y):
    """``bfs_levels`` on RMAT from vertex 0 and from a 64-vertex mask, the
    card against the port's CPU path; the whole call (edge list, upload,
    level loop) on the host clock, and the level loop alone by CUDA
    events."""
    import torch
    from linkpred_tpu_torch.graph import edge_list
    from linkpred_tpu_torch.ops import traverse

    rng = np.random.default_rng(10)
    mask = np.zeros(y.n, bool)
    mask[rng.choice(y.n, 64, replace=False)] = True
    esrc, edst = (torch.as_tensor(a, device=device) for a in edge_list(y))
    for name, start in (("vertex 0", 0), ("a 64-vertex mask", mask)):
        got, ms = wall_ms(lambda: traverse.bfs_levels(y, start,
                                                      device=device))
        want = traverse.bfs_levels(y, start, device="cpu")
        check(np.array_equal(got, want),
              f"host layer: bfs_levels from {name}: card != CPU")
        smask = torch.as_tensor(want == 0, device=device)
        loop_ms = cuda_ms(lambda: traverse._bfs_device(esrc, edst, smask), 3)
        print(f"  bfs_levels from {name}: card == CPU, {int(got.max()) + 1} "
              f"levels, {int((got >= 0).sum())} of {y.n} vertices reached; "
              f"{ms:.3f} ms a call (host clock), level loop {loop_ms:.3f} ms")


def phase_host_communities(device):
    """``modularity`` and ``communities_disconnected`` on phase 8's
    planted graph with its true labels, and with one community made of
    two members of distant blocks (disconnected)."""
    from linkpred_tpu_torch.bench.synth import planted_partition_graph
    from linkpred_tpu_torch.ops import properties

    g = planted_partition_graph(20, 100, p_in=0.3, p_out=0.0005, seed=3)
    labels = np.arange(g.n) // 100
    q, q_ms = wall_ms(lambda: properties.modularity_by(g, labels))
    q1 = properties.modularity(g)
    check(0.5 < q < 1 and q1 < q,
          f"host layer: modularity of the planted labels {q}, singletons "
          f"{q1}")
    split = labels.copy()
    split[[0, 550]] = 20
    for name, x in (("true labels", labels), ("a split community", split)):
        got, ms = wall_ms(lambda: properties.communities_disconnected(
            g, x, device=device))
        want = properties.communities_disconnected(g, x, device="cpu")
        check(np.array_equal(got, want),
              f"host layer: communities_disconnected ({name}): card "
              f"{got} != CPU {want}")
        check((got.size == 0) == (name == "true labels"),
              f"host layer: communities_disconnected ({name}): {got}")
        print(f"  communities_disconnected, {name}: card == CPU "
              f"{got.tolist()}; {ms:.3f} ms (host clock)")
    print(f"  planted(20 x 100): modularity of the true labels {q!r} "
          f"({q_ms:.3f} ms, host NumPy), of singletons {q1!r}")


def phase_host_topk(device, k):
    """``topk_from_candidates`` over 2^21 candidates (tied scores, -inf
    lanes) at ``k``, and ``topk_merge`` of two such buffers, card against
    CPU: scores equal, (u, v) equal outside the k-th score's ties."""
    import torch
    from linkpred_tpu_torch.ops import topk

    rng = np.random.default_rng(11)

    def candidates():
        s = (rng.integers(0, 1 << 12, TOPK_CANDIDATES) / 64).astype(
            np.float32)
        s[rng.random(TOPK_CANDIDATES) < 0.1] = -np.inf
        return (s, *(rng.integers(0, 1 << 19, TOPK_CANDIDATES).astype(
            np.int32) for _ in range(2)))

    def same(got, want, what):
        gs, ws = got.scores.cpu().numpy(), want.scores.numpy()
        check(np.array_equal(gs, ws), f"host layer: {what}: scores differ")
        above = ws > ws[-1]
        pairs = [set(zip(t.u.cpu().numpy()[above].tolist(),
                         t.v.cpu().numpy()[above].tolist()))
                 for t in (got, want)]
        check(pairs[0] == pairs[1],
              f"host layer: {what}: pairs above the k-th score differ")
        return int((ws == ws[-1]).sum())

    bufs, cpu_bufs = [], []
    for _ in range(2):
        c = candidates()
        dev = [torch.as_tensor(a, device=device) for a in c]
        top, ms = wall_ms(lambda: topk.topk_from_candidates(*dev, k))
        ev_ms = cuda_ms(lambda: topk.topk_from_candidates(*dev, k), 5)
        want = topk.topk_from_candidates(*map(torch.as_tensor, c), k)
        ties = same(top, want, "topk_from_candidates")
        bufs.append(top)
        cpu_bufs.append(want)
    merged = topk.topk_merge(*bufs)
    m_ms = cuda_ms(lambda: topk.topk_merge(*bufs), 5)
    m_ties = same(merged, topk.topk_merge(*cpu_bufs), "topk_merge")
    print(f"  topk_from_candidates over {TOPK_CANDIDATES} candidates at k = "
          f"{k}: card == CPU ({ties} lanes tie at the k-th score); "
          f"{ev_ms:.4f} ms (events), {ms:.3f} ms first call (host clock); "
          f"topk_merge of two: card == CPU ({m_ties} at the k-th score), "
          f"{m_ms:.4f} ms (events)")


def phase_host_deletions(device, y):
    """``generate_edge_deletions_device`` at 0.1|E| on RMAT: every valid
    pair an edge, ``valid`` = deg(u) > 0, ids in range, the same seed the
    same draws; on the card and on the CPU path."""
    import torch
    from linkpred_tpu_torch.graph import edge_list
    from linkpred_tpu_torch.ops import batch

    size = int(0.1 * y.size)
    src, dst = edge_list(y)
    keys = src * y.n + dst                     # ascending: CSR order
    deg = np.asarray(y.degrees)
    for dev in (device, torch.device("cpu")):
        out = []
        for _ in range(2):
            gen = torch.Generator(device=dev).manual_seed(9)
            res, ms = wall_ms(lambda: batch.generate_edge_deletions_device(
                gen, y, size, device=dev))
            out.append((res, ms))
        (pairs, valid), ms = out[0]
        check(all(torch.equal(a, b) for a, b in zip(out[0][0], out[1][0])),
              f"host layer: deletions on {dev.type}: one seed, two draws")
        p, ok = pairs.cpu().numpy().astype(np.int64), valid.cpu().numpy()
        check(p.shape == (size, 2) and (p[:, 0] >= 0).all()
              and (p[:, 0] < y.n).all(), f"deletions on {dev.type}: range")
        check(np.array_equal(ok, deg[p[:, 0]] > 0),
              f"host layer: deletions on {dev.type}: valid != deg(u) > 0")
        q = p[ok, 0] * y.n + p[ok, 1]
        at = np.searchsorted(keys, q).clip(max=keys.size - 1)
        check(np.array_equal(keys[at], q),
              f"host layer: deletions on {dev.type}: a valid pair is not "
              "an edge")
        print(f"  generate_edge_deletions_device on {dev.type}: {size} "
              f"draws, {int(ok.sum())} valid, each an edge, valid == "
              f"deg(u) > 0, one seed one output; {out[1][1]:.3f} ms "
              "(host clock, the CSR upload included)")


def phase_host_lanes(device):
    """``xorshift32_step`` over 2^24 lanes (states across the uint32
    range) bit for bit against the CPU path and the host engine, and
    ``scatter_or`` of 2^24 int32 and bool values into 2^20 slots (16
    writers a slot on average) against the CPU path."""
    import torch
    from linkpred_tpu_torch.ops import vector
    from linkpred_tpu_torch.utils import random as xr

    rng = np.random.default_rng(12)
    states = rng.integers(1, 1 << 32, HELPER_LANES, dtype=np.int64)
    dev_states = torch.as_tensor(states, device=device)
    got = xr.xorshift32_step(dev_states)
    ms = cuda_ms(lambda: xr.xorshift32_step(dev_states))
    want = xr.xorshift32_step(torch.as_tensor(states))
    check(torch.equal(got.cpu(), want),
          "host layer: xorshift32_step card != CPU")
    host = [xr.Xorshift32(int(s))() for s in states[:4096]]
    check(got[:4096].cpu().tolist() == host,
          "host layer: xorshift32_step != the host engine")
    print(f"  xorshift32_step over {HELPER_LANES} lanes: card == CPU bit for "
          f"bit ({int((got >= 1 << 31).sum())} results >= 2^31), == "
          f"Xorshift32 on 4096 lanes; {ms:.4f} ms (events)")

    ids = rng.integers(0, SCATTER_SLOTS, HELPER_LANES).astype(np.int32)
    for name, a, x in (
            ("int32", rng.integers(0, 2, SCATTER_SLOTS).astype(np.int32),
             rng.integers(-2 ** 31, 2 ** 31, HELPER_LANES).astype(np.int32)),
            ("bool", np.zeros(SCATTER_SLOTS, bool),
             rng.random(HELPER_LANES) < 0.05)):
        args = [torch.as_tensor(v, device=device) for v in (a, ids, x)]
        got = vector.scatter_or(*args)
        ms = cuda_ms(lambda: vector.scatter_or(*args), 3)
        want = vector.scatter_or(*map(torch.as_tensor, (a, ids, x)))
        check(torch.equal(got.cpu(), want),
              f"host layer: scatter_or ({name}) card != CPU")
        print(f"  scatter_or of {HELPER_LANES} {name} values into "
              f"{SCATTER_SLOTS} slots: card == CPU; {ms:.3f} ms (events)")


def phase_host_layer(device, main_path):
    """The host layer and the device helpers on the card against the
    port's own CPU path, at RMAT-``scale`` of phase 5 unless named
    otherwise; each part's time printed."""
    y, _, _, k = main_path
    parts = (("(a) bfs_levels", lambda: phase_host_bfs(device, y)),
             ("(b) modularity and communities",
              lambda: phase_host_communities(device)),
             ("(c) top-k helpers", lambda: phase_host_topk(device, k)),
             ("(d) device deletions", lambda: phase_host_deletions(device,
                                                                   y)),
             ("(e) xorshift32 and scatter_or",
              lambda: phase_host_lanes(device)))
    times = []
    for name, fn in parts:
        t0 = time.perf_counter()
        fn()
        times.append(f"{name} {time.perf_counter() - t0:.1f} s")
    print("  phase 10 parts: " + ", ".join(times))


# ----------------------------------------- phase 11: the sharded pass

# The scale of the edge-stream IHub graph phase 11's two ranks share.
SIM_IHUB_SCALE = 17


def sim_records(argv, timeout: int = 900):
    """``python -m linkpred_tpu_torch.parallel.sim argv...``: it must exit
    0 (every rank, rank 0's check against the single-process pass
    included).  Returns (the ranks' records, wall seconds)."""
    out, wall = run_module(["linkpred_tpu_torch.parallel.sim", *argv],
                           timeout=timeout)
    recs = [json.loads(line.split("SIM ", 1)[1]) for line in
            out.splitlines() if "SIM {" in line]
    check("sim: OK" in out and recs, f"parallel.sim {argv}: {out[-3000:]}")
    return recs, wall


def phase_one_rank(device, main_path, tmp):
    """Part (a): a one-rank process group on the card (NCCL),
    ``predict_links(mesh=)`` on phase 5's graph, plan and k against the
    plain pass: the same score multiset and the same pairs above the k-th
    score.  Returns the K1 and K2 launches of the sharded run."""
    from linkpred_tpu_torch.utils.profiling import reset_counters
    import torch
    import torch.distributed as dist

    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.ops.topk import TopK
    from linkpred_tpu_torch.parallel import distributed, mesh as pmesh

    y, _, plan, k = main_path
    spec = lt.METRICS["jaccard_coefficient"]
    opts = lt.PredictOptions(repeat=5, max_edges=k)
    single = lt.predict_links(y, spec.name, min_degree1=64, options=opts,
                              plan=plan, device=device)
    distributed.init_distributed(
        f"file://{tmp}/one_rank", 1, 0,
        backend=distributed.default_backend(1, device.type))
    try:
        mesh = pmesh.make_mesh(1, device=device)
        reset_counters()
        sharded = lt.predict_links(y, spec.name, min_degree1=64,
                                   options=opts, plan=plan, mesh=mesh)
        launches = kernel_launches()
        kk = sharded.u.shape[0]
        buf = TopK(*(torch.zeros((1, kk), dtype=dt, device=device)
                     for dt in (torch.float32, torch.int32, torch.int32)))
        gather_ms = cuda_ms(lambda: pmesh.gather_topk(buf, mesh, kk))
        backend = mesh.backend
    finally:
        dist.destroy_process_group()
    same_result(sharded, single, spec, "sharded (a) one rank")
    check(all(v > 0 for v in launches.values()),
          f"sharded (a): a kernel never launched: {launches}")
    print(f"  (a) one rank, {backend}, {device}: LHub Jaccard deg 64 "
          f"n={y.n}, k {k}: {len(sharded)} predictions == the plain pass; "
          f"scoring_ms {sharded.scoring_ms:.3f} (plain "
          f"{single.scoring_ms:.3f}); all-gather of [1, {kk}] "
          f"{gather_ms:.4f} ms; launches {launches}")
    return launches


def phase_two_ranks(tmp, main_path):
    """Part (b): two rank processes on the one card (gloo: NCCL refuses
    two ranks on one device), LHub Jaccard deg 64 on phase 5's graph and
    the IHub edge stream at RMAT-``SIM_IHUB_SCALE``, each exact against
    rank 0's single-process pass.  Each rank's stream bytes, priced bytes
    against free memory, launches, pass and gather times are printed.
    Returns the ranks' K1 and K2 launches."""
    from linkpred_tpu_torch.io.npz import save_graph

    y, _, _, k = main_path
    y_ihub, _, k_ihub, _ = bench_graph(SIM_IHUB_SCALE)
    save_graph(y, os.path.join(tmp, "lhub.npz"))
    save_graph(y_ihub, os.path.join(tmp, "ihub.npz"))
    spec = [dict(name="lhub_rmat19", graph=os.path.join(tmp, "lhub.npz"),
                 metrics=["jaccard_coefficient"], min_degree1=64, cap=None,
                 max_edges=k, repeat=5),
            dict(name=f"ihub_edge_rmat{SIM_IHUB_SCALE}",
                 graph=os.path.join(tmp, "ihub.npz"),
                 metrics=["jaccard_coefficient"], min_degree1=0, cap=None,
                 slot_budget=0, max_edges=k_ihub, repeat=1)]
    path = os.path.join(tmp, "spec.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    recs, wall = sim_records(["2", "--device", "cuda", "--spec", path,
                              "--timeout", "800"])
    launches = {"fused_tail": 0, "pack_survivors": 0}
    for r in sorted(recs, key=lambda r: (r["case"], r["rank"])):
        share = r["padded_total_bytes"] / 2 + r["cap_tail_bytes"]
        print(f"  (b) {r['case']} rank {r['rank']}/{r['world']} "
              f"{r['backend']} {r['device']}: {r['tiles']} tiles (cap "
              f"{r['cap']}, {r['passes']} pass(es), packed {r['packed']}); "
              f"stream {r['stream_bytes']} B of {r['padded_total_bytes']} B "
              f"padded ({r['stream_bytes'] / share:.3f} x total/2 + one cap "
              f"tail of {r['cap_tail_bytes']} B); priced "
              f"{r['priced_bytes']} B against {r['free_bytes']} B free; "
              f"launches K1 {r['k1_launches']}, K2 {r['k2_launches']}; "
              f"plan_ms {r['plan_ms']:.1f}, pass {r['pass_ms']:.3f} ms, "
              f"gather {r['gather_ms']:.3f} ms; {r['results']} results")
        check(r["stream_bytes"] < r["padded_total_bytes"],
              f"sharded (b) {r['case']} rank {r['rank']}: holds the whole "
              "stream")
        if r["packed"] and r["passes"] == 1:
            check(r["stream_bytes"] <= 1.125 * (share + r["cap_tail_bytes"]),
                  f"sharded (b) {r['case']} rank {r['rank']}: more than its "
                  "share")
        check(r["priced_bytes"] <= r["free_bytes"],
              f"sharded (b) {r['case']} rank {r['rank']}: priced over free")
        check(r["stream_bytes"] == 0 or r["k1_launches"] > 0,
              f"sharded (b) {r['case']} rank {r['rank']}: K1 never ran")
        launches["fused_tail"] += r["k1_launches"]
        launches["pack_survivors"] += r["k2_launches"]
    check(len(recs) == 4, f"sharded (b): {len(recs)} records")
    print(f"  (b) two ranks: rc 0 in {wall:.1f} s; launches {launches}")
    return launches


def phase_sharded(device, main_path):
    """Phase 11, parts (a)-(c).  Returns the K1 and K2 launches of (a) and
    of (b)'s ranks."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        one = phase_one_rank(device, main_path, tmp)
        t1 = time.perf_counter()
        two = phase_two_ranks(tmp, main_path)
        t2 = time.perf_counter()
    recs, wall = sim_records(["2", "--device", "cuda", "--dryrun",
                              "--timeout", "300"])
    rank0 = [r for r in recs if r["rank"] == 0][0]
    check(len(recs) == 2 and rank0["results"] > 0 and rank0["recall"] > 0,
          f"sharded (c): {recs}")
    print(f"  (c) the dry run at D = 2 on {rank0['device']}: "
          f"{rank0['results']} predictions == the single-process pass, "
          f"recall {rank0['recall']:.4f}; rc 0 in {wall:.1f} s")
    print(f"  phase 11 parts: (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, "
          f"(c) {wall:.1f} s")
    return {name: one[name] + two[name] for name in one}


# ------------------------------------------- phase 12: the GraphSAGE family

GNN_STEPS = 150
GNN_RMAT_STEPS = 20


def held_out_auc(params, feats, y, g, deletions, rng) -> float:
    """Pairwise AUC of the held-out edges against as many random
    non-edges of ``g``, scored by the full-graph encode of ``y``."""
    import torch

    from linkpred_tpu_torch.models import gnn

    dev = params.l1.w.device
    esrc, edst, deg, _, _ = gnn._graph_tensors(y, dev)
    with torch.no_grad():
        emb = gnn.sage_encode(params, torch.as_tensor(feats, device=dev),
                              esrc, edst, deg)
    pos = deletions[deletions[:, 0] < deletions[:, 1]]
    neg = []
    while len(neg) < len(pos):
        u, v = int(rng.integers(0, y.n)), int(rng.integers(0, y.n))
        if u != v and not g.has_edge(u, v):
            neg.append((min(u, v), max(u, v)))
    neg = np.asarray(neg)

    def score(p):
        return gnn.sddmm_scores(emb, torch.as_tensor(p[:, 0], device=dev),
                                torch.as_tensor(p[:, 1], device=dev)
                                ).cpu().numpy()

    ps, ns = score(pos), score(neg)
    return float(np.mean(ps[:, None] > ns[None, :])
                 + 0.5 * np.mean(ps[:, None] == ns[None, :]))


def train_ms(g, fanouts, steps, device):
    """(params, feats, loss, ms a step): ``steps`` steps of ``train_sage``'s
    own step function at the module's widths.  The first step warms the
    libraries up; the other ``steps - 1`` are timed by CUDA events around
    the step loop alone, so the set-up (edge list, degree features,
    uploads) falls outside the window."""
    from linkpred_tpu_torch.models import gnn

    params, feats, step = gnn._sage_trainer(g, fanouts=fanouts,
                                            device=device)
    losses = []
    ms = cuda_ms(lambda: losses.append(step()), steps - 1)
    return params, feats, float(losses[-1]), ms


def phase_gnn_planted(device):
    """Part (a): phase 8's planted graph with 0.1|E| held out; train on
    the card at full width, full-graph and ``fanouts=(10, 10)``, and hold
    the held-out AUC above 0.65; the card-trained parameters encode on the
    CPU as on the card (rtol 1e-4, atol 2e-5 on the unit-norm embeddings:
    float32 inner products of up to 128 terms and neighbour sums of ~90,
    added in other orders on the two devices, err by up to ~K eps)."""
    import copy

    import torch

    from linkpred_tpu_torch.bench.synth import planted_partition_graph
    from linkpred_tpu_torch.models import gnn
    from linkpred_tpu_torch.ops.batch import (apply_batch,
                                              generate_edge_deletions,
                                              tidy_batch)

    g = planted_partition_graph(20, 100, p_in=0.3, p_out=0.0005, seed=3)
    rng = np.random.default_rng(0)
    deletions = generate_edge_deletions(rng, g, g.size // 10,
                                        undirected=True)
    deletions, ins = tidy_batch(deletions, np.empty((0, 2), np.int64), g)
    y = apply_batch(g, deletions, ins)
    for fanouts in (None, (10, 10)):
        params, feats, loss, ms = train_ms(y, fanouts, GNN_STEPS, device)
        auc = held_out_auc(params, feats, y, g, deletions, rng)
        embs = []
        for p in (params, copy.deepcopy(params).to("cpu")):
            dev = p.l1.w.device
            esrc, edst, deg, _, _ = gnn._graph_tensors(y, dev)
            with torch.no_grad():
                embs.append(gnn.sage_encode(
                    p, torch.as_tensor(feats, device=dev), esrc, edst,
                    deg).cpu())
        err = float((embs[0] - embs[1]).abs().max())
        print(f"  (a) planted n={y.n} |E|={y.size}, {len(deletions) // 2} "
              f"held out; fanouts {fanouts}: {GNN_STEPS} steps, loss "
              f"{loss:.4f}, {ms:.3f} ms a step; held-out AUC {auc:.4f}; "
              f"card vs CPU encode max abs err {err:.3e}")
        check(auc > 0.65, f"gnn (a) fanouts {fanouts}: AUC {auc}")
        check(np.allclose(embs[0].numpy(), embs[1].numpy(), rtol=1e-4,
                          atol=2e-5),
              f"gnn (a) fanouts {fanouts}: card and CPU encodes differ "
              f"({err})")


def phase_gnn_rmat(device, main_path):
    """Part (b): phase 5's RMAT-19 graph.  20 full-graph and 20 sampled
    training steps with their ms a step, then ``GNNPredictor`` and
    ``HybridPredictor`` with LHub Jaccard deg 64 candidates at k = the
    removed edges, beside the heuristic's recall.  Returns the K1 and K2
    launches of the two predictors."""
    from linkpred_tpu_torch.utils.profiling import reset_counters
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.models import (GNNPredictor, HeuristicPredictor,
                                           HybridPredictor)

    y, deletions, plan, k = main_path
    removed = {(int(a), int(b)) for a, b in deletions if a < b}
    for fanouts in (None, (10, 10)):
        params, feats, loss, ms = train_ms(y, fanouts, GNN_RMAT_STEPS,
                                           device)
        check(np.isfinite(loss), f"gnn (b) fanouts {fanouts}: loss {loss}")
        print(f"  (b) RMAT n={y.n} |E|={y.size}, fanouts {fanouts}: "
              f"{GNN_RMAT_STEPS} steps, loss {loss:.4f}, {ms:.3f} ms a step")
    heur = lt.predict_links(y, "jaccard_coefficient", min_degree1=64,
                            options=lt.PredictOptions(max_edges=k),
                            plan=plan, device=device)
    gnn_p = GNNPredictor(params, feats, candidate_metric="jaccard",
                         min_degree1=64, device=device.type)
    hyb = HybridPredictor(gnn_p, HeuristicPredictor(
        "jaccard", 64, cap=plan.cap, device=device.type))
    reset_counters()
    t0 = time.perf_counter()
    res_g = gnn_p.predict(y, max_edges=k)
    t1 = time.perf_counter()
    res_h = hyb.predict(y, max_edges=k)
    t2 = time.perf_counter()
    launches = kernel_launches()
    for name, res in (("GNN", res_g), ("hybrid", res_h)):
        check(len(res) == k and np.isfinite(res.score).all()
              and np.all(np.diff(res.score) <= 0)
              and np.all(res.u < res.v),
              f"gnn (b) {name}: k finite descending u < v results")
    print(f"  (b) at k = {k} (candidates {4 * k}, LHub Jaccard deg 64): "
          f"recall GNN {recall_of(res_g, removed):.6f} ({t1 - t0:.1f} s), "
          f"hybrid {recall_of(res_h, removed):.6f} ({t2 - t1:.1f} s), "
          f"heuristic {recall_of(heur, removed):.6f}; launches {launches}")
    # K2 runs where a selection keeps at most a quarter of 2^22 or more
    # lanes (scoring._argselect); 4k candidates of 16 tiles of 2^20 lanes
    # are more, so this path's selections sort and only K1 must run
    check(launches["fused_tail"] > 0, f"gnn (b): K1 never launched: "
          f"{launches}")
    return launches


def phase_gnn(device, main_path):
    """Phase 12, parts (a)-(b).  Returns the K1 and K2 launches of the
    GNN's candidate passes."""
    t0 = time.perf_counter()
    phase_gnn_planted(device)
    t1 = time.perf_counter()
    launches = phase_gnn_rmat(device, main_path)
    print(f"  phase 12 parts: (a) {t1 - t0:.1f} s, (b) "
          f"{time.perf_counter() - t1:.1f} s")
    return launches


# ------------------------------------------ phase 13: the examples on the card

# Part (b): the example's scales, cut from its default 14-16 to keep the
# phase inside its budget (RMAT-16's two IHub plans take ~45 s on the card's
# host), and the (scale, fraction) held against the CPU: the largest scale
# whose CPU legs stay under 30 s on the card's host (RMAT-15's took 24.6
# and 37.4 s in two runs; PERF.md section 6).  Part (d)'s scales.  The
# phase's budget in seconds of the smoke.
EXAMPLE_SCALES = (14, 15)
EXAMPLE_CPU_CHECK = (14, 0.1)
TABLE_SCALES = (18, 19)
EXAMPLES_BUDGET_S = 180


def load_file(rel: str, name: str):
    """A file of the repository loaded as a module (the examples and the
    scripts are files, not packages)."""
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(here, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plan_path(p) -> str:
    """The stream a plan scores on, with its sub-plans."""
    out = (f"{'packed' if p.packed else 'edge'} cap {p.cap}, {p.num_tiles} "
           f"tiles, {p.total_slots} slots")
    for name, sub in (("hub", p.huge_plan), ("side", p.side_plan)):
        if sub is not None:
            out += f" + {name} sub-plan ({plan_path(sub)})"
    if p.host_src.size:
        out += f" + {p.host_src.size} host-scored hubs"
    return out


class PlanTimer:
    """While entered, ``predict.api.build_plan`` (the plan that
    ``predict_links`` builds when given none) is timed: ``ms`` holds each
    call's host milliseconds, ``paths`` each plan's :func:`plan_path`."""

    def __enter__(self):
        from linkpred_tpu_torch.predict import api

        self.api, self.real, self.ms, self.paths = api, api.build_plan, [], []

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            p = self.real(*args, **kwargs)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.paths.append(plan_path(p))
            return p

        api.build_plan = timed
        return self

    def __exit__(self, *exc):
        self.api.build_plan = self.real


def phase_examples_serving(device):
    """Part (a): ``examples/serving/run_torch.py`` at its default size on
    the card: one plan for the three requests; the last request's rows
    equal a ``device="cpu"`` run's up to ties at the k-th score (AA at
    rtol 1e-5, C7)."""
    import linkpred_tpu_torch as lt

    mod = load_file("examples/serving/run_torch.py", "serving_torch")
    with PlanTimer() as plans:
        got = mod.main(device=device)
    check(len(plans.ms) == 1, f"serving (a): {len(plans.ms)} plans built "
          "for three requests of one user set")
    want = mod.main(device="cpu")[-1]
    same_result(got[-1], want, lt.METRICS["adamic_adar"],
                "serving (a) last request")
    print(f"  (a) serving: 3 requests, 1 plan ({plans.ms[0]:.1f} ms); "
          f"scoring_ms {', '.join(f'{r.scoring_ms:.3f}' for r in got)}; "
          f"request 2's {len(got[-1])} rows == the CPU run's")


def phase_examples_ihub_lhub(device, out_dir, scales=None, cpu_check=None):
    """Part (b): ``examples/ihub_vs_lhub/run_torch.py`` at ``scales``
    (``EXAMPLE_SCALES``), both fractions, ``repeat=3``, into ``out_dir``:
    each row's scoring ms, speedup, F1s, and each leg's plan ms and stream;
    then IHub and LHub at ``cpu_check`` (``EXAMPLE_CPU_CHECK``: scale,
    fraction) on the card against the CPU."""
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.bench.synth import rmat_graph

    scales = EXAMPLE_SCALES if scales is None else scales
    cpu_check = EXAMPLE_CPU_CHECK if cpu_check is None else cpu_check

    mod = load_file("examples/ihub_vs_lhub/run_torch.py", "ihub_lhub_torch")
    with PlanTimer() as plans:
        rows = mod.main(tuple(scales), device=device, out_dir=out_dir)
    check(len(rows) == 2 * len(scales) and len(plans.ms) == 2 * len(rows),
          f"ihub_vs_lhub (b): {len(rows)} rows, {len(plans.ms)} plans")
    check(sorted(os.listdir(out_dir)) == ["speedup_cuda.csv",
                                          "speedup_cuda.md"],
          f"ihub_vs_lhub (b): wrote {os.listdir(out_dir)}")
    for i, r in enumerate(rows):
        check(r["ihub_ms"] > 0 and r["lhub_ms"] > 0
              and 0 <= r["ihub_f1"] <= 1 and 0 <= r["lhub_f1"] <= 1,
              f"ihub_vs_lhub (b): row {r}")
        print(f"  (b) s{r['scale']} frac {r['fraction']} (|E| "
              f"{r['m_directed']}): IHub {r['ihub_ms']} ms scoring, plan "
              f"{plans.ms[2 * i]:.1f} ms; LHub {r['lhub_ms']} ms, plan "
              f"{plans.ms[2 * i + 1]:.1f} ms; speedup {r['speedup']}x; F1 "
              f"{r['ihub_f1']} / {r['lhub_f1']}")
        print(f"      IHub {plans.paths[2 * i]}; LHub "
              f"{plans.paths[2 * i + 1]}")
    scale, frac = cpu_check
    y, dels = mod.removal_batch(rmat_graph(scale, edge_factor=16, seed=42),
                                frac)
    spec = lt.METRICS[mod.METRIC]
    opts = lt.PredictOptions(max_edges=max(dels.shape[0] // 2, 1))
    for d1 in (0, mod.HUB_DEG):
        card = lt.predict_links(y, spec.name, min_degree1=d1, options=opts,
                                device=device)
        t0 = time.perf_counter()
        cpu = lt.predict_links(y, spec.name, min_degree1=d1, options=opts,
                               device="cpu")
        cpu_s = time.perf_counter() - t0
        same_result(card, cpu, spec, f"ihub_vs_lhub (b) s{scale} frac "
                    f"{frac} d1 {d1}")
        print(f"  (b) s{scale} frac {frac} {'IHub' if d1 == 0 else 'LHub'}: "
              f"{len(card)} rows == the CPU run's (CPU leg {cpu_s:.1f} s)")


def phase_examples_subprocesses(main_path, scale, tmp):
    """Parts (c) and (d): the multi-process example with two ranks on the
    card, and the scale table at ``TABLE_SCALES``, a fresh bench process a
    row, its cache seeded with phase 5's graph where phase 5 ran one of
    those scales."""
    from linkpred_tpu_torch.bench import run

    out, wall = run_file(["examples/multihost_sim/run_torch.py", "2",
                          "--timeout", "300"], timeout=400)
    ok = [line for line in out.splitlines() if "multihost_sim OK" in line]
    check(len(ok) == 1 and "sim: OK, 2 ranks" in out,
          f"multihost (c): {out[-2000:]}")
    print(f"  (c) {ok[0].strip()}; rc 0 in {wall:.1f} s")

    y, deletions, _, _ = main_path
    cache = os.path.join(tmp, "table_cache")
    if scale in TABLE_SCALES:
        run.write_cache(cache, scale, y, deletions)
    out, wall = run_file(["scripts/bench_table_torch.py",
                          *map(str, TABLE_SCALES)],
                         env=bench_env(BENCH_CACHE_DIR=cache), timeout=900)
    lines = out.strip().splitlines()
    check([line.split(":")[0] for line in lines[:len(TABLE_SCALES)]]
          == [f"s{s}" for s in TABLE_SCALES]
          and "| graph | rate | vs reference headline |" in lines
          and not any("FAILED" in line for line in lines),
          f"bench table (d): {out[-2000:]}")
    seeded = (f"RMAT-{scale} read from phase 5's graph"
              if scale in TABLE_SCALES else "every graph made")
    print(f"  (d) scripts/bench_table_torch.py "
          f"{' '.join(map(str, TABLE_SCALES))}: rc 0 in {wall:.1f} s "
          f"({seeded}):")
    for line in lines:
        print("    " + line)


def phase_examples(device, main_path, scale):
    """Phase 13, parts (a)-(e): the port-side examples and scripts on the
    card (``scale``: phase 5's).  Returns the K1 and K2 launches of the
    parts run in this process ((a), (b) and (e))."""
    from linkpred_tpu_torch.utils.profiling import reset_counters
    import contextlib
    import io
    import tempfile


    t_start = time.perf_counter()
    times = {}
    with tempfile.TemporaryDirectory() as tmp:
        reset_counters()
        t0 = time.perf_counter()
        phase_examples_serving(device)
        times["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_examples_ihub_lhub(device, os.path.join(tmp, "speedup"))
        times["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        verify = load_file("scripts/verify_torch.py", "verify_torch")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            check(verify.main([]) == 0, "verify (e): rc")
        launches = kernel_launches()
        lines = out.getvalue().strip().splitlines()
        check(len(lines) == 3 and lines[0].startswith("device: cuda")
              and lines[1].startswith("OK: jaccard")
              and lines[2].startswith("OK: adamic_adar"),
              f"verify (e): {lines}")
        for line in lines:
            print("  (e) " + line)
        times["e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_examples_subprocesses(main_path, scale, tmp)
        times["c+d"] = time.perf_counter() - t0
    check(all(v > 0 for v in launches.values()),
          f"examples: a kernel never launched: {launches}")
    total = time.perf_counter() - t_start
    parts = ", ".join(f"({k}) {v:.1f} s" for k, v in times.items())
    print(f"  phase 13 parts: {parts}; {total:.1f} s of its "
          f"{EXAMPLES_BUDGET_S} s budget; launches in this process "
          f"{launches}")
    return launches


# ------------------------------------ phase 14: the engine's design probes

# The phase's budget in seconds of the smoke.
PROBES_BUDGET_S = 150
# The synthetic probes, each with its arguments here: its own size where
# that is cheap, else a cut (ab_select 2^23 of its 2^25 lanes, ab_sel2 8 of
# its 32 tiles, ab_pack_sel 2^24 of its 68 x 2^21 lanes with kk at the
# same 1.567% share, ab_batchsort 8 of its 32 rows, ab_deg_gather 4 of its
# 16 tiles, ab_edge3 2 of its 8, mesh_overhead 1 and 2 ranks at RMAT-13).
PROBE_CUTS = [
    ("ab_width2", []),
    ("ab_batchsort", ["--t", "8"]),
    ("ab_merge", []),
    ("amort2", []),
    ("ab_select", ["--log2n", "23"]),
    ("ab_sel2", ["--t", "8"]),
    ("ab_pack_sel", ["--lanes", str(1 << 24), "--kk",
                     str(round(2234330 * (1 << 24) / (68 << 21)))]),
    ("ab_deg_gather", ["--t", "4"]),
    ("ab_edge3", ["--t", "2"]),
    ("ab_edge2", []),
    ("mesh_overhead", ["--mo-scale", "13", "--ranks", "1,2"]),
]
# The probes at the JAX probes' own sizes (``--probes``), in the order of
# the port's slice: where a pass spends its time, the selection, the
# tile's sort and gathers, the ranks.
PROBES_FULL = [
    ("profile_bench", []), ("profile_tiles", []), ("diag_scale", []),
    ("diag_s21", []), ("ab_split", []), ("ab_split", ["--deferred"]),
    ("ab_select", []), ("ab_sel2", []), ("ab_pack_sel", []),
    ("diag_pack", []), ("ab_width2", []), ("ab_batchsort", []),
    ("ab_deg_gather", []), ("ab_edge3", []), ("ab_edge2", []),
    ("ab_merge", []), ("amort2", []), ("mesh_overhead", []),
]


def probe_module(name: str):
    import importlib

    return importlib.import_module(f"linkpred_tpu_torch.experiments.{name}")


def phase_probes(device, main_path):
    """Phase 14: every ported design probe on the card, its arms held
    equal there (each probe raises on a disagreement).  The graph probes
    run on phase 5's graph and plan (RMAT-19: profile_tiles on it at k =
    4096 in place of the generator's RMAT-18, diag_s21 and diag_pack at
    RMAT-19 in place of 21); the synthetic ones at ``PROBE_CUTS``.  Prints
    a digest of each probe's rows (the top 5 of a per-op table) and its
    wall seconds; returns K1's and K2's launches."""
    from linkpred_tpu_torch.utils.profiling import reset_counters
    import contextlib
    import io

    from linkpred_tpu_torch.experiments import (_probe, ab_split, diag_pack,
                                                diag_s21, diag_scale,
                                                profile_bench)

    y, deletions, plan, k = main_path
    graph_probes = [
        ("profile_bench", lambda r: profile_bench.profile_pass(
            y, plan, k, device, r)),
        ("profile_tiles", lambda r: profile_bench.profile_pass(
            y, plan, 4096, device, r, top=40)),
        ("diag_scale", lambda r: diag_scale.diagnose(
            y, plan, 1 << 20, device, r, trace=True)),
        ("diag_s21", lambda r: diag_s21.diagnose(y, plan, k, device, r,
                                                 pack=False)),
        ("ab_split", lambda r: ab_split.split(y, plan, 1 << 18, device, r)),
        ("ab_deferred", lambda r: ab_split.split(y, plan, 1 << 19, device,
                                                 r)),
        ("diag_pack", lambda r: diag_pack.decision(y, plan, k, device, r)),
    ]
    def quiet(fn):
        # a probe's own JSON lines (the per-op tables run to kilobytes)
        # give way to a digest of its rows
        with contextlib.redirect_stdout(io.StringIO()):
            return fn()

    def graph_run(name, run):
        rows = _probe.Rows(name, device, scale="phase 5's")
        run(rows)
        return rows.rows

    reset_counters()
    walls = {}
    t_start = time.perf_counter()
    runs = [(name, lambda n=name, r=run: graph_run(n, r))
            for name, run in graph_probes]
    runs += [(name, lambda n=name, a=argv: probe_module(n).main(
        ["--device", "cuda", *a])) for name, argv in PROBE_CUTS]
    for name, run in runs:
        t0 = time.perf_counter()
        rows = quiet(run)
        walls[name] = time.perf_counter() - t0
        for row in rows[1:]:
            if row.get("row") == "ops":
                row = dict(row, ops=[[n[:60], round(t, 3), dev]
                                     for n, t, dev in row["ops"][:5]])
            print("    " + json.dumps(row)[:300])
    launches = kernel_launches()
    total = time.perf_counter() - t_start
    print("  phase 14 walls: " + ", ".join(f"{n} {t:.1f} s"
                                           for n, t in walls.items()))
    print(f"  phase 14: {len(walls)} probes, every arm held equal on the "
          f"card; {total:.1f} s of its {PROBES_BUDGET_S} s budget; "
          f"launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"probes: a kernel never launched: {launches}")
    return launches


def run_probes(out_dir: str) -> int:
    """``--probes``: probes 1-17 at the JAX probes' own sizes, one after
    another in this process, their rows (and each probe's wall seconds,
    or its failure) appended to ``out_dir/probes.jsonl``.  Returns the
    count of probes that failed."""
    import traceback

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "probes.jsonl")
    failed = 0
    print(card_line())
    for name, argv in PROBES_FULL:
        t0 = time.perf_counter()
        try:
            rows = probe_module(name).main(["--device", "cuda", *argv])
            rows.append({"probe": rows[0]["probe"], "row": "wall",
                         "seconds": time.perf_counter() - t0})
        except Exception as e:      # recorded, and the run exits non-zero
            failed += 1
            traceback.print_exc()
            rows = [{"probe": name, "argv": argv, "row": "failed",
                     "error": f"{type(e).__name__}: {e}"[:2000],
                     "seconds": time.perf_counter() - t0}]
        with open(path, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        print(f"--probes: {name} {' '.join(argv)} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        import torch

        torch.cuda.empty_cache()
    print(f"--probes: {len(PROBES_FULL) - failed} of {len(PROBES_FULL)} "
          f"ran; rows in {path}")
    return failed


def technique_key(row) -> tuple:
    """(deletions fraction, insertions fraction, metric, hub threshold) of
    a result row, whichever package's tag it carries."""
    import re

    m = re.fullmatch(r"predictLinks(.+?)(?:Tpu|Cuda)(?:Fused)?(\d+)",
                     row["technique"])
    return (float(row["batch_deletions_fraction"]),
            float(row["batch_insertions_fraction"]), m.group(1),
            int(m.group(2)))


def sweep_vs_tpu(device, out_dir: str, tpu_csv: str, argv) -> int:
    """``python -m linkpred_tpu_torch.bench.sweep argv --out-dir out_dir``
    on ``device``, in this process, under :class:`DriverProbe`; then its
    rows against the TPU's ``tpu_csv`` row for row (technique matched by
    metric and hub threshold): each row whose precision or recall differs,
    the largest difference, and whether the pairs tied at the k-th score
    explain it: the card's common count may move by at most twice the
    pairs tied with its k-th score (``test_torch_harness.py``'s rule).
    Returns the count of rows that ties do not explain."""
    import csv

    from linkpred_tpu_torch.bench import process, sweep

    check(not os.path.exists(os.path.join(out_dir, "sweep.log")),
          f"sweep: {out_dir} holds a log already")
    with DriverProbe(device) as probe:
        rc = sweep.main([*argv, "--out-dir", out_dir, "--device",
                         device.type])
    check(rc == 0, f"sweep: rc {rc}")
    rows = [r for rs in process.read_log(
        os.path.join(out_dir, "sweep.log")).values() for r in rs]
    check(len(rows) == len(probe.ties) == len(probe.counts),
          f"sweep: {len(rows)} rows, {len(probe.ties)} probed")
    with open(tpu_csv, newline="") as f:
        tpu = {technique_key(r): r for r in csv.DictReader(f)}
    check(sorted(tpu) == sorted(technique_key(r) for r in rows),
          f"sweep: the rows are not the TPU sweep's ({tpu_csv})")
    print(card_line())
    differ, worst, unexplained = 0, 0.0, 0
    for r, ties, (common, n_del, n_ins) in zip(rows, probe.ties,
                                                probe.counts):
        w = tpu[technique_key(r)]
        d = max(abs(r["precision"] - float(w["precision"])),
                abs(r["recall"] - float(w["recall"])))
        if d == 0:
            continue
        differ += 1
        worst = max(worst, d)
        tpu_common = round(float(w["precision"]) * n_ins)
        ok = abs(common - tpu_common) <= 2 * ties
        unexplained += not ok
        print(f"  {r['technique']} at -{r['batch_deletions_fraction']}/+"
              f"{r['batch_insertions_fraction']}: precision "
              f"{r['precision']} / recall {r['recall']} against "
              f"the TPU's {w['precision']} / {w['recall']}; common "
              f"{common} against {tpu_common} of {n_ins} predicted, "
              f"{n_del} removed; {ties} pairs tied at the k-th score: "
              + ("explained by ties" if ok else "NOT explained by ties"))
    print(f"sweep vs TPU: {differ} of {len(rows)} rows differ, the "
          f"largest by {worst:.7g}; {unexplained} not explained by ties")
    return unexplained


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
    if sys.argv[1:2] == ["--sweep-vs-tpu"]:
        out_dir, tpu_csv, *argv = sys.argv[2:]
        return 1 if sweep_vs_tpu(device, out_dir, tpu_csv, argv) else 0
    if sys.argv[1:2] == ["--probes"]:
        return 1 if run_probes(sys.argv[2]) else 0
    if sys.argv[1:2] == ["--ihub-lhub"]:
        out_dir, cpu_scale, *scales = sys.argv[2:]
        print(card_line())
        phase_examples_ihub_lhub(device, out_dir, [int(s) for s in scales],
                                 (int(cpu_scale), 0.1))
        return 0
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
    phase("phase 1: build; the launch floor; P5 against its plain "
          "version; P4's device time")
    t0 = time.perf_counter()
    _build.load()
    print(f"  kernels built by nvcc from linkpred_tpu_torch/kernels/csrc "
          f"and loaded in {time.perf_counter() - t0:.2f} s")
    p5 = phase_p5(device, rng)
    p4_dev = p4_device_ms(device)
    print(f"  P4 device ms a call by the profiler (for phase 7): "
          f"{p4_dev[1]:.5f} at iters 1, {p4_dev[32]:.5f} at iters 32")
    phase("phase 2: K1 fused_tail against its twin; P1 against xla_tail")
    k1 = phase_k1(device, rng)
    p1 = phase_p1(device, rng)
    phase("phase 3: K2 pack_survivors against its twin")
    k2 = phase_k2(device, rng)
    phase("phase 4: end to end, cuda against cpu")
    phase_end_to_end(device)
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 19
    phase(f"phase 5: the LHub main path, RMAT-{scale}")
    lhub, main_path = phase_main_path(device, scale)
    torch.cuda.empty_cache()
    phase("phase 6: the IHub path, RMAT-18 on the edge stream")
    ihub = phase_ihub(device, 18)
    torch.cuda.empty_cache()
    phase("phase 7: the sort probes P2, P3 (bitonic) and P4 (radix probe); "
          "bitonic at 2^7-2^23")
    p2, p3, p4, probe_packs = phase_sort_probes(device, rng, p4_dev)
    torch.cuda.empty_cache()
    phase("phase 8: the experiment driver (cli.main: card against CPU on a "
          "planted graph; RMAT-18 fused and unfused; python -m "
          "linkpred_tpu_torch)")
    driver = phase_driver(device)
    torch.cuda.empty_cache()
    phase("phase 9: the bench leg and the experiment layer (bench.run in "
          "process and as a subprocess; the models and the sweep, card "
          "against CPU; npz; profile_fn)")
    bench = phase_bench_layer(device, main_path, scale)
    torch.cuda.empty_cache()
    phase("phase 10: host layer and device helpers (BFS, communities, "
          "top-k merge, device deletions, xorshift32, scatter_or), card "
          "against CPU")
    phase_host_layer(device, main_path)
    torch.cuda.empty_cache()
    phase("phase 11: the sharded pass (one rank on NCCL; two rank "
          "processes on the one card over gloo; the dry run)")
    sharded = phase_sharded(device, main_path)
    torch.cuda.empty_cache()
    phase("phase 12: the GraphSAGE family at full width (planted graph, "
          "RMAT-19)")
    gnn = phase_gnn(device, main_path)
    torch.cuda.empty_cache()
    phase("phase 13: the examples and scripts (serving, IHub vs LHub, two "
          "rank processes, the scale table, the oracle drive)")
    examples = phase_examples(device, main_path, scale)
    torch.cuda.empty_cache()
    phase("phase 14: the engine's design probes (where a pass spends its "
          "time, the selection, the tile's sort and gathers, the ranks)")
    probes = phase_probes(device, main_path)
    del main_path
    phase("done")

    paths = {"lhub": lhub, "ihub": ihub, "driver": driver, "bench": bench,
             "sharded": sharded, "gnn": gnn, "examples": examples,
             "probes": probes}
    by_path = {name: {path: got[name] for path, got in paths.items()}
               for name in ("fused_tail", "pack_survivors")}
    by_path["pack_survivors"]["radix_probe"] = probe_packs
    stats = {
        "fused_tail": dict(
            launches=sum(by_path["fused_tail"].values()),
            launches_by_path=by_path["fused_tail"], **k1),
        "pack_survivors": dict(
            launches=sum(by_path["pack_survivors"].values()),
            launches_by_path=by_path["pack_survivors"], **k2),
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
