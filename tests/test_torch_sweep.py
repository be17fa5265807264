"""The port's sweep runner and suite manifest against the JAX package's on
the CPU, with the same seeded inputs: ``_parse_synthetic``'s graphs;
``main([... "--device", "cpu"])`` against the JAX ``main`` on ``rmat:8:4``
and on a toy MTX (logs equal except the timestamps, the times, the thread
label and the backend tag; CSVs equal except the same fields; precision and
recall through the counts they are made of, equal up to the pairs tied
with the k-th score); ``--resume``; ``--suite reference --allow-missing``
and the error on a missing suite; the raise without ``--device cpu``; the
manifest field for field; ``resolve_suite``/``missing_report``;
``f1_score``/``f1_report`` on rows with the port's ``Cuda`` and
``CudaFused`` tags against the JAX functions on the same rows tagged
``Tpu``.
"""
import csv
import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from linkpred_tpu.bench import harness as ref_harness
from linkpred_tpu.bench import suite as ref_suite
from linkpred_tpu.bench import sweep as ref_sweep

from linkpred_tpu_torch.bench import harness, suite, sweep

from test_torch_harness import _assert_rows_match, _assert_same_csr, _Recorder

R_TS = re.compile(r"^\d+-\d+-\d+ \d+:\d+:\d+ ")
R_RESULT = re.compile(r"^\{-.+ batchf, .+ threads\} -> \{")
TIMES = ("total_time", "scoring_time", "num_threads", "omp_num_threads")
SWEEP = ["--metrics", "cn,jaccard,aa", "--degrees", "0,64",
         "--repeat-batch", "1", "--repeat-method", "1",
         "--deletions-begin", "0.1", "--deletions-end", "0.1",
         "--seed", "3", "--cap", str(1 << 14)]


# ----------------------------------------------------------------- synthetic

@pytest.mark.parametrize("spec", ["rmat:8:4", "rmat:7", "ppart:4:20",
                                  "ppart:3"])
def test_parse_synthetic_matches_reference(spec):
    name, g = sweep._parse_synthetic(spec)
    ref_name, ref = ref_sweep._parse_synthetic(spec)
    assert name == ref_name
    _assert_same_csr(g, ref)
    assert g.m > 0


def test_parse_synthetic_refuses_unknown_specs():
    for mod in (sweep, ref_sweep):
        with pytest.raises(ValueError, match="unknown synthetic spec"):
            mod._parse_synthetic("er:10")


# --------------------------------------------------------------------- sweep

def _toy_mtx(path, seed=4, n=70, m=300, symmetric=False):
    """A pattern/general MTX file: random edges, one direction each unless
    ``symmetric``."""
    rng = np.random.default_rng(seed)
    u, v = rng.integers(0, n, m), rng.integers(0, n, m)
    pairs = {(int(a), int(b)) for a, b in zip(u, v) if a != b}
    if symmetric:
        pairs |= {(b, a) for a, b in pairs}
    lines = [f"{a + 1} {b + 1}" for a, b in sorted(pairs)]
    path.write_text("%%MatrixMarket matrix coordinate pattern general\n"
                    f"{n} {n} {len(lines)}\n" + "\n".join(lines) + "\n")
    return path


def _log_lines(path):
    """The log's lines without timestamps, the thread label as N, result
    lines dropped (compared as rows)."""
    out = []
    for ln in path.read_text().splitlines():
        ln = R_TS.sub("", ln)
        if R_RESULT.match(ln):
            continue
        out.append(re.sub(r"OMP_NUM_THREADS=\d+", "OMP_NUM_THREADS=N", ln))
    return out


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _run_both(tmp_path, monkeypatch, args):
    """Port ``main`` with ``--device cpu`` and the JAX ``main`` on the same
    arguments, into out dirs of their own; each harness's predict calls
    recorded."""
    rec_p = _Recorder(monkeypatch, harness)
    rec_r = _Recorder(monkeypatch, ref_harness)
    out_p, out_r = tmp_path / "port", tmp_path / "ref"
    assert sweep.main([*args, "--out-dir", str(out_p),
                       "--device", "cpu"]) == 0
    assert ref_sweep.main([*args, "--out-dir", str(out_r)]) == 0
    return out_p, out_r, rec_p, rec_r


def _assert_sweeps_match(out_p, out_r, rec_p, rec_r, names):
    from linkpred_tpu_torch.bench.process import read_log

    assert _log_lines(out_p / "sweep.log") == _log_lines(out_r / "sweep.log")
    data_p = read_log(str(out_p / "sweep.log"))
    data_r = read_log(str(out_r / "sweep.log"))
    assert list(data_p) == list(data_r) == names
    got = [r for rows in data_p.values() for r in rows]
    want = [r for rows in data_r.values() for r in rows]
    # the log rounds precision and recall to 4 digits: compare the rows
    # through the counts they were printed from
    full_p = [dict(r, precision=c / max(i, 1), recall=c / max(d, 1))
              for r, (c, d, i) in zip(got, rec_p.counts)]
    full_r = [dict(r, precision=c / max(i, 1), recall=c / max(d, 1))
              for r, (c, d, i) in zip(want, rec_r.counts)]
    _assert_rows_match(full_p, full_r, rec_p, rec_r,
                       threads=(1, want[0]["num_threads"]))
    assert all(r["omp_num_threads"] == 1 for r in got)
    for a, b, cp, cr in zip(got, want, rec_p.counts, rec_r.counts):
        for f in ("graph", "order", "size", "batch_deletions_fraction",
                  "batch_insertions_fraction"):
            assert a[f] == b[f], f
        if cp[0] == cr[0]:
            assert (a["precision"], a["recall"]) == \
                (b["precision"], b["recall"])
    # the CSVs: the same columns and cells, apart from the same fields
    equal_counts = [cp[0] == cr[0] for cp, cr in zip(rec_p.counts,
                                                     rec_r.counts)]
    for name in ["sweep", *names]:
        rows_p = _csv_rows(out_p / f"{name}.csv")
        rows_r = _csv_rows(out_r / f"{name}.csv")
        off = 0 if name == "sweep" else sum(len(data_p[x]) for x in
                                            names[:names.index(name)])
        assert len(rows_p) == len(rows_r) > 0
        for i, (a, b) in enumerate(zip(rows_p, rows_r)):
            assert list(a) == list(b)
            assert a["technique"] == b["technique"].replace("Tpu", "Cuda")
            skip = {*TIMES, "technique"}
            if not equal_counts[off + i]:
                skip |= {"precision", "recall"}
            assert {k: v for k, v in a.items() if k not in skip} == \
                {k: v for k, v in b.items() if k not in skip}
    return got


@pytest.mark.parametrize("kind", ["synthetic", "mtx"])
def test_sweep_main_matches_reference(tmp_path, monkeypatch, capsys, kind):
    if kind == "synthetic":
        args, names = ["--synthetic", "rmat:8:4"], ["rmat_s8_e4"]
    else:
        path = _toy_mtx(tmp_path / "toy.mtx")
        args, names = ["--graphs", str(path)], ["toy"]
    out_p, out_r, rec_p, rec_r = _run_both(tmp_path, monkeypatch,
                                           [*args, *SWEEP])
    got = _assert_sweeps_match(out_p, out_r, rec_p, rec_r, names)
    assert len(got) == 3 * 2
    assert {r["technique"] for r in got} == {
        f"predictLinks{t}CudaFused{d}" for d in (0, 64)
        for t in ("CommonNeighbors", "JaccardCoefficient",
                  "AdamicAdarCoefficient")}
    assert (kind == "mtx") == ("(symmetrize)" in
                               (out_p / "sweep.log").read_text())
    capsys.readouterr()


def test_sweep_resume_skips_done_graphs(tmp_path, capsys):
    args = ["--synthetic", "rmat:8:4", "--out-dir", str(tmp_path),
            "--device", "cpu", "--resume", *SWEEP]
    assert sweep.main(args) == 0
    n_lines = len((tmp_path / "sweep.log").read_text().splitlines())
    capsys.readouterr()
    assert sweep.main(args) == 0
    assert "skipping rmat_s8_e4" in capsys.readouterr().out
    assert len((tmp_path / "sweep.log").read_text().splitlines()) == n_lines
    assert len(_csv_rows(tmp_path / "rmat_s8_e4.csv")) == 6


def test_suite_sweep_allow_missing(tmp_path, monkeypatch, capsys):
    """``--suite reference --allow-missing`` runs the present subset with
    the manifest's symmetric flag (coAuthorsDBLP: already symmetric, not
    symmetrized again) and writes the F1 report, as the JAX sweep does."""
    data = tmp_path / "data"
    data.mkdir()
    _toy_mtx(data / "coAuthorsDBLP.mtx", seed=3, n=60, m=240,
             symmetric=True)
    args = ["--suite", "reference", "--data-dir", str(data),
            "--allow-missing", "--metrics", "jaccard_coefficient",
            "--degrees", "0,8", "--repeat-batch", "1", "--repeat-method",
            "1", "--deletions-begin", "0.1", "--deletions-end", "0.1",
            "--cap", "2048"]
    out_p, out_r, rec_p, rec_r = _run_both(tmp_path, monkeypatch, args)
    err = capsys.readouterr().err
    assert "missing reference-suite graphs" in err and "asia_osm" in err
    _assert_sweeps_match(out_p, out_r, rec_p, rec_r, ["coAuthorsDBLP"])
    log = (out_p / "sweep.log").read_text()
    assert "coAuthorsDBLP" in log and "(symmetrize)" not in log
    rep = json.loads((out_p / "f1_report.json").read_text())
    ref = json.loads((out_r / "f1_report.json").read_text())
    assert set(rep) == set(ref) == {"ihub@0.1", "lhub@0.1"}
    for key, v in rep.items():
        assert set(v) == {"measured", "published", "ok"}
        assert v["published"] == ref[key]["published"]
    if [c[0] for c in rec_p.counts] == [c[0] for c in rec_r.counts]:
        assert rep == ref


def test_suite_sweep_errors_on_missing(tmp_path, capsys):
    with pytest.raises(SystemExit):
        sweep.main(["--suite", "reference", "--data-dir", str(tmp_path),
                    "--out-dir", str(tmp_path / "r"), "--device", "cpu"])
    assert "17 suite graphs missing" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        sweep.main(["--out-dir", str(tmp_path / "r"), "--device", "cpu"])
    assert not (tmp_path / "r").exists()


def test_sweep_needs_the_card_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            sweep.main(["--synthetic", "rmat:8:4", "--out-dir", str(out),
                        *SWEEP, *extra])
    g = sweep._parse_synthetic("rmat:7")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        sweep.run_sweep([g], harness.ExperimentConfig(), str(out))
    assert not out.exists()           # raised before any work


def test_sweep_defaults_match_reference(monkeypatch):
    """The same flags and defaults, plus ``--device`` (default cuda)."""
    seen = {}
    for mod, key in ((sweep, "port"), (ref_sweep, "ref")):
        monkeypatch.setattr(mod, "run_sweep",
                            lambda g, cfg, *a, k=key, **kw:
                            seen.setdefault(k, (cfg, a, kw)) and "x")
        monkeypatch.setattr(mod, "read_log", lambda p: {})
        monkeypatch.setattr(mod, "write_csv", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert sweep.main(["--graphs", "a.mtx"]) == 0
    assert ref_sweep.main(["--graphs", "a.mtx"]) == 0
    (cfg_p, a_p, kw_p), (cfg_r, a_r, kw_r) = seen["port"], seen["ref"]
    assert cfg_p.device == "cuda"
    got = dataclasses.asdict(cfg_p)
    got.pop("device")
    assert got == dataclasses.asdict(cfg_r)
    assert (a_p, kw_p) == (a_r, kw_r)


# --------------------------------------------------------------------- suite

def test_manifest_matches_reference():
    assert len(suite.REFERENCE_SUITE) == len(ref_suite.REFERENCE_SUITE) == 17
    for g, r in zip(suite.REFERENCE_SUITE + (suite.HEADLINE_GRAPH,),
                    ref_suite.REFERENCE_SUITE + (ref_suite.HEADLINE_GRAPH,)):
        assert dataclasses.asdict(g) == dataclasses.asdict(r)
        assert g.url == r.url and g.path("/d") == r.path("/d")
    assert suite.PUBLISHED_F1 == ref_suite.PUBLISHED_F1
    assert suite.__all__ == ref_suite.__all__


@pytest.mark.parametrize("present,headline", [
    ((), False), (("web-Google", "asia_osm"), False),
    (("coAuthorsDBLP", "sk-2005"), True), (("sk-2005",), False)])
def test_resolve_suite_and_missing_report_match_reference(tmp_path, present,
                                                          headline):
    for name in present:
        (tmp_path / f"{name}.mtx").write_text("%%MatrixMarket stub\n")
    got = suite.resolve_suite(str(tmp_path), include_headline=headline)
    want = ref_suite.resolve_suite(str(tmp_path), include_headline=headline)
    for a, b in zip(got, want):
        assert [(p, dataclasses.asdict(g)) for p, g in a] == \
            [(p, dataclasses.asdict(g)) for p, g in b]
    assert suite.missing_report(got[1]) == ref_suite.missing_report(want[1])
    assert len(got[0]) + len(got[1]) == 17 + headline


def _f1_rows(tags, seed):
    """Result rows over fractions 0.01 and 0.1 (and one with no published
    bracket), IHub and LHub thresholds, F1 near and far from the brackets."""
    rng = np.random.default_rng(seed)
    rows = []
    for frac in (1e-2, 0.1, 1e-3, 0.010000000001):
        for deg in (0, 4, 64, 10, 100):
            for t in tags:
                p, r = rng.random(2) * (0.3 if deg else 0.15)
                rows.append(dict(
                    technique=f"predictLinksJaccardCoefficient{t}{deg}",
                    batch_insertions_fraction=frac, precision=p, recall=r))
    rows.append(dict(technique="predictLinksCommonNeighborsCuda0",
                     batch_insertions_fraction=0.1, precision=0.0,
                     recall=0.0))
    return rows


@pytest.mark.parametrize("tags", [("Cuda",), ("CudaFused",),
                                  ("Cuda", "CudaFused")])
@pytest.mark.parametrize("tol", [0.5, 0.05])
def test_f1_report_matches_reference(tags, tol):
    rows = _f1_rows(tags, seed=len(tags))
    ref_rows = [dict(r, technique=r["technique"].replace("Cuda", "Tpu"))
                for r in rows]
    got = suite.f1_report(rows, rel_tolerance=tol)
    assert got == ref_suite.f1_report(ref_rows, rel_tolerance=tol)
    assert set(got) == {("ihub", 1e-2), ("ihub", 1e-1), ("lhub", 1e-2),
                        ("lhub", 1e-1)}
    # ...Cuda0 and ...CudaFused0 read as IHub: its mean is over those rows
    ihub = [suite.f1_score(r["precision"], r["recall"]) for r in rows
            if r["technique"].endswith(("Cuda0", "CudaFused0"))
            and abs(r["batch_insertions_fraction"] - 0.1) < 1e-7]
    assert got[("ihub", 1e-1)]["measured"] == pytest.approx(
        sum(ihub) / len(ihub), rel=1e-12)


def test_f1_score_matches_reference():
    for p, r in ((0.0, 0.0), (0.5, 0.5), (0.1, 0.3), (1.0, 0.0), (2e-3, 1.0)):
        assert suite.f1_score(p, r) == ref_suite.f1_score(p, r)
    assert suite.f1_score(0.5, 0.5) == 0.5
