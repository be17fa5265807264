"""The port-side examples and scripts, on the CPU, held against the JAX
package (``linkpred_tpu``) from the same numpy seeds:

1. ``scripts/verify_torch.py --device cpu``: the dense-oracle drive;
2. ``examples/serving/run_torch.py``: three requests through one
   ``PlanCache`` against ``linkpred_tpu.predict_links`` + ``top_per_source``;
3. ``examples/ihub_vs_lhub/run_torch.py``'s ``run_one`` against the JAX
   example's ``run_one`` (loaded from ``examples/ihub_vs_lhub/run.py``) on a
   planted-partition graph, IHub and LHub;
4. ``run_torch.py 8 --device cpu --out-dir DIR``: its own files, merged only
   with its own CSV, the JAX example's TPU table untouched;
5. ``examples/multihost_sim/run_torch.py`` with two CPU ranks, and a rank
   that fails;
6. ``scripts/bench_table_torch.py 8 9``: a fresh bench process a row.

Tolerances: Adamic-Adar sums at rtol 1e-5 (C7: summed in another order),
pairs compared only above the k-th score widened by that rtol, where ties
may pick other pairs; F1 within what the pairs tied at the k-th score can
move (``test_run_one_matches_the_jax_example``).  Every entry point raises
without a card unless it is given the CPU.
"""
import contextlib
import csv
import hashlib
import importlib.util
import io
import os
import runpy
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AA_RTOL = 1e-5


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows_match(got_u, got_v, got_s, want_u, want_v, want_s, rtol):
    """Equal lengths, scores within ``rtol`` lane for lane after sorting,
    and the same pairs above the smallest score widened by ``rtol``."""
    assert len(got_s) == len(want_s)
    np.testing.assert_allclose(np.sort(got_s), np.sort(want_s), rtol=rtol)
    if not len(want_s):
        return
    cut = want_s.min() * (1 + 2 * rtol)

    def above(u, v, s):
        return {(int(a), int(b)) for a, b, c in zip(u, v, s) if c > cut}

    assert above(got_u, got_v, got_s) == above(want_u, want_v, want_s)


def test_verify_torch_on_the_cpu(capsys):
    mod = _load("scripts/verify_torch.py", "verify_torch")
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "device: cpu (CPU, plain kernels)"
    assert out[1].startswith("OK: jaccard 500 rows oracle-exact")
    assert out[2] == "OK: adamic_adar 500 rows oracle-exact on this device"


def test_serving_matches_the_reference(monkeypatch, capsys):
    import linkpred_tpu as ref
    from linkpred_tpu.ops.transform import (remove_self_loops as r_rsl,
                                            symmetrize as r_sym)
    from linkpred_tpu_torch.predict import api

    n, m, users = 300, 1800, 16
    built = []
    real = api.build_plan
    monkeypatch.setattr(api, "build_plan",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    mod = _load("examples/serving/run_torch.py", "serving_torch")
    results = mod.main(n=n, m=m, users=users, device="cpu")
    out = capsys.readouterr().out
    assert len(results) == 3 and len(built) == 1, built  # requests 1, 2 reuse
    assert out.count("[plan cached]") == 2
    assert "OK: per-user top-5 lists" in out

    rng = np.random.default_rng(7)
    g = r_rsl(r_sym(ref.from_edges(rng.integers(0, n, m),
                                   rng.integers(0, n, m), n=n)))
    srcs = np.sort(rng.choice(n, size=users, replace=False)).astype(np.int64)
    want = ref.predict_links(g, metric="adamic_adar", min_degree1=64,
                             sources=srcs,
                             options=ref.PredictOptions(max_edges=64 * 50))
    assert len(want) > 0
    for res in results:
        _rows_match(res.u, res.v, res.score, np.asarray(want.u),
                    np.asarray(want.v), np.asarray(want.score), AA_RTOL)
    from linkpred_tpu_torch import top_per_source

    got5, want5 = top_per_source(results[-1], 5), ref.top_per_source(want, 5)
    for s in srcs:
        a, b = got5.u == s, np.asarray(want5.u) == s
        _rows_match(got5.u[a], got5.v[a], got5.score[a],
                    np.asarray(want5.u)[b], np.asarray(want5.v)[b],
                    np.asarray(want5.score)[b], AA_RTOL)


@pytest.mark.parametrize("min_degree1", [0, 64])
def test_run_one_matches_the_jax_example(min_degree1):
    """F1 of the port's ``run_one`` equals the JAX example's, or differs by
    at most what the pairs tied at the k-th score can move: each tied pair
    swapped moves the common count by at most 2 (both directions), so
    precision by 2t/|ins| and recall by 2t/|dels|, and F1, whose partial
    derivatives are at most 2, by 2 (dp + dr)."""
    from linkpred_tpu.bench import synth as r_synth
    from linkpred_tpu.ops import batch as r_batch
    from linkpred_tpu_torch import PredictOptions, predict_links
    from linkpred_tpu_torch.bench.synth import planted_partition_graph

    ref_ex = _load("examples/ihub_vs_lhub/run.py", "ihub_vs_lhub_jax")
    port_ex = _load("examples/ihub_vs_lhub/run_torch.py", "ihub_vs_lhub_torch")
    frac = 0.1
    g = planted_partition_graph(6, 50, 0.3, 0.01, seed=3)
    y, dels = port_ex.removal_batch(g, frac)
    rg = r_synth.planted_partition_graph(6, 50, 0.3, 0.01, seed=3)
    rng = np.random.default_rng(0)
    rdels = r_batch.generate_edge_deletions(
        rng, rg, int(frac * rg.size / 2), undirected=True)
    rdels, rins = r_batch.tidy_batch(rdels, np.empty((0, 2), np.int64), rg)
    ry = r_batch.apply_batch(rg, rdels, rins)
    assert np.array_equal(dels, rdels)
    assert np.array_equal(y.indices, np.asarray(ry.indices))

    _, f1 = port_ex.run_one(y, dels, min_degree1, 1, device="cpu")
    _, rf1 = ref_ex.run_one(ry, rdels, min_degree1, 1)
    assert rf1 > 0.05, rf1                 # planted: removed edges recover
    res = predict_links(y, port_ex.METRIC, min_degree1=min_degree1,
                        options=PredictOptions(
                            max_edges=max(dels.shape[0] // 2, 1)),
                        device="cpu")
    ties = int(np.sum(res.score == res.score.min()))
    tol = 2 * (2 * ties / (2 * len(res)) + 2 * ties / dels.shape[0])
    assert abs(f1 - rf1) <= tol, (f1, rf1, ties)


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def test_ihub_vs_lhub_writes_only_its_own_files(tmp_path, monkeypatch):
    here = os.path.join(REPO, "examples", "ihub_vs_lhub")
    tpu = [os.path.join(here, f) for f in ("speedup.csv", "speedup.md")]
    before = [_sha(p) for p in tpu]
    with open(tmp_path / "speedup_cuda.csv", "w", newline="") as f:
        f.write("scale,n,m_directed,fraction,ihub_ms,lhub_ms,speedup,"
                "ihub_f1,lhub_f1,device\n"
                "9,512,1,0.1,2.0,1.0,2.0,0.0,0.0,\"CPU, plain kernels\"\n"
                "8,256,1,0.1,2.0,1.0,2.0,0.0,0.0,\"CPU, plain kernels\"\n")
    monkeypatch.setattr(sys, "argv", [
        "run_torch.py", "8", "--device", "cpu", "--out-dir", str(tmp_path)])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        runpy.run_path(os.path.join(here, "run_torch.py"),
                       run_name="__main__")
    assert "IHub" in out.getvalue() and "LHub" in out.getvalue()
    with open(tmp_path / "speedup_cuda.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    # the scale-8 rows are this run's (both fractions), the scale-9 row kept
    assert [(r["scale"], r["fraction"]) for r in rows] == [
        ("8", "0.01"), ("8", "0.1"), ("9", "0.1")]
    assert all(int(r["m_directed"]) > 1 for r in rows[:2])
    assert {r["device"] for r in rows} == {"CPU, plain kernels"}
    md = (tmp_path / "speedup_cuda.md").read_text()
    assert "PyTorch port on CPU, plain kernels" in md and "TPU" not in md
    assert sorted(os.listdir(tmp_path)) == ["speedup_cuda.csv",
                                            "speedup_cuda.md"]
    assert [_sha(p) for p in tpu] == before


def test_multihost_sim_two_cpu_ranks(capsys):
    mod = _load("examples/multihost_sim/run_torch.py", "multihost_torch")
    assert mod.main(["2", "--device", "cpu", "--timeout", "240"]) == 0
    out = capsys.readouterr().out
    assert ("[rank 0] multihost_sim OK: 2 processes on cpu (gloo), 200 "
            "predictions, sharded == single-process") in out, out
    assert "sim: OK, 2 ranks" in out


def test_multihost_sim_a_failing_rank_fails_the_launcher(tmp_path,
                                                        monkeypatch, capsys):
    # rank 1 exits 3 at start-up (a sitecustomize on its path), before it
    # joins the group: rank 0 would wait for it until its deadline
    (tmp_path / "sitecustomize.py").write_text(
        "import sys\n"
        "a = sys.argv\n"
        "if '--rank' in a and a[a.index('--rank') + 1] == '1':\n"
        "    raise SystemExit(3)\n")
    monkeypatch.setenv("PYTHONPATH", str(tmp_path))
    mod = _load("examples/multihost_sim/run_torch.py", "multihost_torch")
    assert mod.main(["2", "--device", "cpu", "--timeout", "240"]) == 1
    out = capsys.readouterr().out
    assert "sim: FAILED (rank 1 exited" in out, out
    assert "multihost_sim OK" not in out


def test_bench_table_fresh_process_rows(tmp_path, monkeypatch, capsys):
    mod = _load("scripts/bench_table_torch.py", "bench_table_torch")
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_SAMPLES", "1")
    monkeypatch.setenv("BENCH_REPEAT", "1")
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path))
    assert mod.main(["8", "9"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("s8: ") and out[1].startswith("s9: ")
    assert out[2:5] == ["", "| graph | rate | vs reference headline |",
                        "|---|---|---|"]
    assert out[5].startswith("| RMAT-8 | ") and out[6].startswith("| RMAT-9 |")
    assert len(out) == 7
    assert sorted(os.listdir(tmp_path)) == [
        "rmat8_e16_s42_f0.1.npz", "rmat9_e16_s42_f0.1.npz"]

    monkeypatch.setenv("BENCH_KEY64", "0")
    assert mod.main(["8", "9"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] + ": " + line.split(": ")[1].split()[0]
            for line in out if line.startswith("s")] == [
        "s8: FAILED", "s9: FAILED"]
    assert not any(line.startswith("| RMAT") for line in out)


@pytest.mark.parametrize("rel,call", [
    ("scripts/verify_torch.py", lambda m: m.main([])),
    ("examples/serving/run_torch.py", lambda m: m.main(n=300, m=1800,
                                                       users=16)),
    ("examples/ihub_vs_lhub/run_torch.py", lambda m: m.main((8,))),
    ("examples/multihost_sim/run_torch.py", lambda m: m.main(["2"])),
    ("scripts/bench_table_torch.py", lambda m: m.main(["8"])),
], ids=["verify", "serving", "ihub_vs_lhub", "multihost", "bench_table"])
def test_entry_points_default_to_the_card(rel, call, monkeypatch,
                                          tmp_path):
    """Without a card, a call that names no device raises before any work;
    it never takes the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.chdir(tmp_path)
    mod = _load(rel, "default_" + os.path.basename(rel)[:-3])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        call(mod)
    assert os.listdir(tmp_path) == []
