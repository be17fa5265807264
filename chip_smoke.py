#!/usr/bin/env python3
"""Smoke run of linkpred_tpu_torch on one NVIDIA GPU: builds the CUDA
kernels, checks each against its plain PyTorch twin, checks the port end to
end against the CPU and a dense oracle, and drives the main path
(``predict_links``, LHub Jaccard at deg 64, k = half the removed edges) on
an RMAT-19 graph at the bench protocol.

    python3 chip_smoke.py [scale]

``scale`` (default 19) sets the R-MAT scale of the main path.  Run from the
root of the repository.  Every phase prints its lines and any
failure raises, so the run exits non-zero.  With no CUDA device, or without
the package beside the script, it exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record.
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
]
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


# --------------------------------------------------------------- phase 2: K1

def tail_stream(rng, cap, w_bits, fill, run_len, wide, n_wt):
    """A sorted tile as the main path hands it to K1: (w, u) pairs with
    run_len lanes per pair on average, degrees constant per pair, pad lanes
    after the real ones."""
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
    w = np.concatenate([w, nv | (lane & 1023)]).astype(np.int32)
    u = np.concatenate([u, np.zeros(pad, np.int64)]).astype(np.int32)
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
        wts.append(x)
    return w, u, degs, wts


def phase_k1(device, rng):
    import torch
    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.ops.topk import desc_key_score
    from linkpred_tpu_torch.predict.metrics import METRICS

    cap = 1 << 20
    cases = [
        # name, metrics, wide, min_score, maxf2, run_len, fill
        ("deg16_all7", UNWEIGHTED, False, 0.0, 0, 4, 0.95),
        ("wide_pair", UNWEIGHTED, True, 0.0, 0, 4, 0.95),
        ("aa_ra", ["adamic_adar", "resource_allocation"], False, 0.0, 0, 8,
         0.95),
        ("runs_over_a_block", ["common_neighbors", "adamic_adar"], False,
         0.0, 0, 5000, 1.0),
        ("min_score", ["jaccard_coefficient", "common_neighbors"], False,
         0.01, 0, 4, 0.9),
        ("maxf2", ["hub_promoted", "resource_allocation"], False, 0.0, 2, 4,
         0.9),
    ]
    max_err = 0.0
    for name, names, wide, min_score, maxf2, run_len, fill in cases:
        mets = [METRICS[m] for m in names]
        n_wt = sum(m.needs_weight for m in mets)
        w, u, degs, wts = tail_stream(rng, cap, 20, fill, run_len, wide, n_wt)
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        args = (t(w), t(u), [t(d) for d in degs], [t(x) for x in wts],
                min_score)
        kw = dict(metrics=mets, w_bits=20, n=1 << 20, maxf2=maxf2)
        kk, ku, kv = ft.fused_tail(*args, **kw)
        rk, ru, rv = ft.fused_tail_reference(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(ku, ru) and torch.equal(kv, rv), f"K1 {name}: ku/kw")
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
        print(f"  K1 {name}: {len(mets)} metrics, cap {cap}: kernel == twin")
    # time at the main path's shape: deg16, Jaccard, cap 2^20
    w, u, degs, wts = tail_stream(rng, cap, 19, 0.97, 3, False, 0)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    args = (t(w), t(u), [t(degs[0])], [], 0.0)
    kw = dict(metrics=[METRICS["jaccard_coefficient"]], w_bits=19,
              n=1 << 19, maxf2=0)
    ms = cuda_ms(lambda: ft.fused_tail(*args, **kw))
    plain = cuda_ms(lambda: ft.fused_tail_reference(*args, **kw))
    print(f"  K1 time at cap 2^20, deg16, Jaccard: kernel {ms:.4f} ms, "
          f"twin {plain:.4f} ms")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain)


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
    for name, k in [("random", key), ("clustered", clustered)]:
        thr, _ = compact.sample_threshold(k, kk)
        out = compact.pack_survivors(k, thr)
        ref = compact.pack_survivors_reference(k, thr)
        torch.cuda.synchronize()
        for a, b, what in zip(out, ref, ("keys", "indices", "count")):
            check(torch.equal(a, b), f"K2 {name}: {what} differ")
        print(f"  K2 {name}: {total} lanes, {int(out[2])} survivors: "
              "kernel == twin")
    thr, _ = compact.sample_threshold(key, kk)
    ms = cuda_ms(lambda: compact.pack_survivors(key, thr))
    plain = cuda_ms(lambda: compact.pack_survivors_reference(key, thr))
    print(f"  K2 time at 2^24 lanes: kernel {ms:.4f} ms, twin {plain:.4f} ms")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain)


# --------------------------------------------------- phase 4: end to end

def dense_oracle(g, spec, d1):
    """{(u, v): score} over valid upper-triangle pairs, float64."""
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
    valid = np.triu(np.ones((n, n), bool), 1) & (a == 0) & (cnt > 0) \
        & (np.nan_to_num(s, nan=-np.inf) > 0)
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


def phase_end_to_end(device):
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.bench.synth import (planted_partition_graph,
                                                rmat_graph)

    names = list(lt.METRICS)
    graphs = [("planted(8,32)", planted_partition_graph(8, 32, p_in=0.4,
                                                        p_out=0.002, seed=1)),
              ("RMAT-12", rmat_graph(12, edge_factor=16, seed=42))]
    for gname, g in graphs:
        for d1 in (64, 0):
            opts = lt.PredictOptions(max_edges=20_000)
            got = lt.predict_links_multi(g, names, min_degree1=d1,
                                         options=opts, device=device)
            want = lt.predict_links_multi(g, names, min_degree1=d1,
                                          options=opts, device="cpu")
            for name in names:
                same_result(got[name], want[name], lt.METRICS[name],
                            f"{gname} d1={d1} {name}")
            if g.n <= 512:
                for name in names:
                    pairs = dense_oracle(g, lt.METRICS[name], d1)
                    r = got[name]
                    check(len(r) == min(len(pairs), 20_000),
                          f"{gname} {name}: oracle row count")
                    for u, v, s in zip(r.u, r.v, r.score):
                        check(np.isclose(s, pairs[(int(u), int(v))],
                                         rtol=1e-5),
                              f"{gname} {name}: oracle score ({u}, {v})")
            print(f"  {gname} d1={d1}: 9 metrics, cuda == cpu "
                  f"({len(got['jaccard_coefficient'])} Jaccard rows)"
                  + (", == dense oracle" if g.n <= 512 else ""))


# --------------------------------------------------- phase 5: main path

def time_split(device, plan, y, k):
    """Where one scoring pass of the main path spends its time, by timing
    its parts alone with CUDA events: the tile loop (window reads, the
    int64 sort, the payload gathers, K1), K1 alone on pre-sorted tiles, and
    the selection (threshold, K2, survivor sort, gathers).  The device busy
    share comes from the kernels of one profiled pass."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.predict import scoring
    from linkpred_tpu_torch.predict.metrics import METRICS

    mets = (METRICS["jaccard_coefficient"],)
    stream = plan.device_stream(device)
    all_slots = plan.total_slots + plan.huge_slots + (
        plan.side_plan.total_slots if plan.side_plan else 0)
    kk = min(-(-k // 1024) * 1024, max(all_slots, 1))   # the API's exact k
    kw = dict(metrics=mets, cap=plan.cap, maxf2=0, min_score=0.0,
              w_bits=plan.w_bits, n=y.n, deg16=plan.deg16)
    ts = plan.tile_start
    bounds = [(int(ts[t]), int(ts[t + 1])) for t in range(len(ts) - 1)
              if ts[t] < ts[t + 1]]

    def one_pass():
        return scoring.score_tiles(
            stream, ts, 0.0, metric_names=(mets[0].name,), cap=plan.cap,
            k=kk, n=y.n, w_bits=plan.w_bits, deg16=plan.deg16,
            device=device)

    def tiles():
        return [scoring.tile_candidates_packed(*stream, s, e, **kw)
                for s, e in bounds]

    # sorted tiles as K1 receives them
    sorted_in = []
    orig = scoring.fused_tail
    scoring.fused_tail = lambda *a, **k_: sorted_in.append((a, k_)) \
        or orig(*a, **k_)
    try:
        outs = tiles()
    finally:
        scoring.fused_tail = orig
    keys = torch.cat([o[0] for o in outs], dim=1)
    us = torch.cat([o[1] for o in outs])
    vs = torch.cat([o[2] for o in outs])
    pad = plan.num_tiles_padded * plan.cap - keys.shape[1]
    if pad:   # ghost tiles, as the pass buffers them
        lane = torch.arange(pad, dtype=torch.int32, device=device)
        keys = torch.cat([keys, (0x7F800000 | (lane & 0x7FFFFE))[None]], 1)
        us = torch.cat([us, torch.zeros(pad, dtype=us.dtype, device=device)])
        vs = torch.cat([vs, torch.zeros(pad, dtype=vs.dtype, device=device)])
    split = {
        "pass": cuda_ms(one_pass, 5),
        "tile loop": cuda_ms(tiles, 5),
        "K1 alone": cuda_ms(lambda: [ft.fused_tail(*a, **k_)
                                     for a, k_ in sorted_in], 5),
        "selection": cuda_ms(lambda: scoring._select_topk(keys, us, vs, kk),
                             5),
    }
    one_pass()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_pass()
        torch.cuda.synchronize()
    by_kernel = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_kernel[ev.name] = by_kernel.get(ev.name, 0.0) \
                + ev.device_time_total / 1e3
    return split, by_kernel


def phase_main_path(device, scale: int = 19):
    import torch
    import linkpred_tpu_torch as lt
    from linkpred_tpu_torch.bench.synth import rmat_graph
    from linkpred_tpu_torch.ops import compact
    from linkpred_tpu_torch.ops import fused_tail as ft
    from linkpred_tpu_torch.ops.batch import (apply_batch,
                                              generate_edge_deletions,
                                              tidy_batch)
    from linkpred_tpu_torch.predict import scoring
    from linkpred_tpu_torch.predict.plan import build_plan

    t0 = time.perf_counter()
    g = rmat_graph(scale, edge_factor=16, seed=42)
    rng = np.random.default_rng(0)
    deletions = generate_edge_deletions(rng, g, int(0.1 * g.size / 2),
                                        undirected=True)
    deletions, insertions = tidy_batch(deletions, np.empty((0, 2), np.int64),
                                       g)
    y = apply_batch(g, deletions, insertions)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = build_plan(y, 64, device=device)
    plan_ms = (time.perf_counter() - t0) * 1e3
    k = max(deletions.shape[0] // 2, 1)
    print(f"  RMAT-{scale}: n={y.n} |E|={y.size} removed={k} "
          f"setup {setup_s:.1f} s; plan: cap {plan.cap}, "
          f"{plan.num_tiles} tiles ({plan.num_tiles_padded} padded), "
          f"{plan.total_slots} slots, plan_ms {plan_ms:.1f}")
    opts = lt.PredictOptions(repeat=5, max_edges=k)

    ft.LAUNCHES = compact.LAUNCHES = 0
    scoring.PACKED_ARM_RUNS = scoring.SORT_ARM_RUNS = 0
    rates, res = [], None
    for _ in range(3):
        res = lt.predict_links(y, "jaccard_coefficient", min_degree1=64,
                               options=opts, plan=plan, device=device)
        rates.append(y.size / (res.scoring_ms / 1e3))
    launches = {"fused_tail": ft.LAUNCHES, "pack_survivors": compact.LAUNCHES}
    arms = (scoring.PACKED_ARM_RUNS, scoring.SORT_ARM_RUNS)

    removed = {(int(a), int(b)) for a, b in deletions if a < b}
    got = {(min(int(a), int(b)), max(int(a), int(b)))
           for a, b in zip(res.u, res.v)}
    hits = len(removed & got)
    recall = hits / max(len(removed), 1)
    rates.sort()
    print(f"  RMAT-{scale} LHub Jaccard deg 64: edges/s median "
          f"{rates[1]:.6e} (samples {', '.join(f'{r:.6e}' for r in rates)});"
          f" scoring_ms {res.scoring_ms:.3f}, transfer_ms "
          f"{res.transfer_ms:.3f}, plan_ms {plan_ms:.1f}; "
          f"{len(res)} predictions, {hits} removed edges recovered "
          f"(recall {recall:.6g})")
    print(f"  launches in the main path: {launches}; selection arms "
          f"packed={arms[0]} sort={arms[1]}")
    check(len(res) == k and np.isfinite(res.score).all(),
          "main path: k finite predictions")
    check(np.all(np.diff(res.score) <= 0), "main path: scores descending")
    check(recall > 0, "main path: recall of the removed edges is zero")
    check(all(v > 0 for v in launches.values()),
          f"main path: a kernel never launched: {launches}")
    check(arms[0] > 0, "main path: the survivor pack arm never ran")

    split, by_kernel = time_split(device, plan, y, k)
    busy = sum(by_kernel.values())
    print(f"  one pass {split['pass']:.3f} ms: tile loop "
          f"{split['tile loop']:.3f} ms (K1 alone {split['K1 alone']:.3f} ms),"
          f" selection {split['selection']:.3f} ms; device busy "
          f"{busy:.3f} ms ({100 * busy / split['pass']:.1f}% of the pass); "
          "top device work of the pass:")
    for name, ms in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms:8.3f} ms  {name[:90]}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
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

    print("phase 1: build")
    t0 = time.perf_counter()
    _build.load()
    print(f"  kernels built by nvcc from linkpred_tpu_torch/kernels/csrc "
          f"and loaded in {time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(0)
    print("phase 2: K1 fused_tail against its twin")
    k1 = phase_k1(device, rng)
    print("phase 3: K2 pack_survivors against its twin")
    k2 = phase_k2(device, rng)
    print("phase 4: end to end, cuda against cpu")
    phase_end_to_end(device)
    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 19
    print("phase 5: main path")
    launches = phase_main_path(device, scale)

    record = {"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=launches[name], **stats)
        for (name, src, rep), stats in zip(KERNELS, (k1, k2))]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
