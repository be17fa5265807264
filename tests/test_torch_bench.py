"""The port's bench leg against the JAX package's on the CPU, with the same
seeded inputs: the roofline model (``packed_pass_min_bytes`` on the full
grid of its arguments, ``roofline_report``, the peak table), the bench row
of ``python -m linkpred_tpu_torch.bench.run`` against ``bench.py``'s
(``BENCH_DEVICE=cpu``, RMAT-10, one sample of one pass: the same keys,
metric, engine, samples and model bytes; the plan's slot total; the graph
cache read across the packages), what raises; npz graph files written by
one package and read by the other; the profiler helper on a CPU op.

``bench.py`` is loaded from its file, read and never edited.  Rates and
times are the CPU's and are not compared.
"""
import importlib.util
import itertools
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import linkpred_tpu as lp
from linkpred_tpu.io import npz as ref_npz
from linkpred_tpu.predict.plan import build_plan as ref_build_plan
from linkpred_tpu.utils import roofline as ref_roofline

import linkpred_tpu_torch as lt
from linkpred_tpu_torch.bench import run
from linkpred_tpu_torch.io import npz
from linkpred_tpu_torch.predict.plan import build_plan
from linkpred_tpu_torch.utils import profiling, roofline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = {"metric", "value", "unit", "vs_baseline", "engine", "samples",
            "rate_min", "rate_max", "hbm_model_bytes",
            "achieved_gbps_min_model"}
SMALL_BENCH = dict(BENCH_DEVICE="cpu", BENCH_SCALE="10", BENCH_SAMPLES="1",
                   BENCH_REPEAT="1")


def _bench_py():
    spec = importlib.util.spec_from_file_location(
        "bench_reference", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ roofline

@pytest.mark.parametrize(
    "num_metrics,weighted,key64,deg16,fused,sel_pack",
    list(itertools.product((1, 9), (0, 1), *[(False, True)] * 4)))
def test_packed_pass_min_bytes_matches_reference(num_metrics, weighted, key64,
                                                 deg16, fused, sel_pack):
    kw = dict(num_metrics=num_metrics, weighted=weighted, key64=key64,
              deg16=deg16, fused=fused, sel_pack=sel_pack)
    for slots in (0, 1, 1000, 16_336_236, (1 << 31) - 1):
        assert roofline.packed_pass_min_bytes(slots, **kw) == \
            ref_roofline.packed_pass_min_bytes(slots, **kw)


def test_packed_pass_min_bytes_main_path():
    """The main path's model: 99.375 B a slot (deg16, key64, unweighted,
    fused, pack, one metric)."""
    assert roofline.packed_pass_min_bytes(16_336_236) == 1_623_413_452
    assert roofline.packed_pass_min_bytes(8) == 795


@pytest.mark.parametrize("peak", [3350.0, 819.0, None])
@pytest.mark.parametrize("nbytes,ms", [(1_623_413_452, 10.0), (795, 1e-12),
                                       (0, 3.0)])
def test_roofline_report_matches_reference(peak, nbytes, ms):
    got = roofline.roofline_report(nbytes, ms, peak_gbps=peak)
    want = ref_roofline.roofline_report(nbytes, ms, peak_gbps=peak)
    assert got == want
    # no card here and the JAX package on the CPU: no peak, no peak keys
    assert ("frac_of_peak" in got) == (peak is not None)


def test_roofline_report_zero_peak_has_no_peak_fields():
    assert set(roofline.roofline_report(1000, 1.0, peak_gbps=0.0)) == {
        "hbm_model_bytes", "achieved_gbps_min_model"}


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 3350.0),
    ("NVIDIA H100 SXM5 80GB", 3350.0),
    ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA H100 NVL", 3900.0),
    ("NVIDIA A100-SXM4-80GB", None),
    ("TPU v5 lite", None),
])
def test_device_peak_gbps_by_card_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert roofline.device_peak_gbps("cuda") == peak
    assert roofline.device_peak_gbps(torch.device("cuda", 0)) == peak
    # the default device is the first card where there is one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert roofline.device_peak_gbps() == peak
    assert roofline.device_peak_gbps("cpu") is None


def test_device_peak_gbps_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert roofline.device_peak_gbps() is None
    assert roofline.device_peak_gbps("cpu") is None
    assert ref_roofline.device_peak_gbps() is None      # jax on the CPU


# ------------------------------------------------------------------ bench row

def _rows(monkeypatch, capsys, tmp_path):
    """``bench.py``'s row and the port's, each with a cache dir of its
    own."""
    for k, v in SMALL_BENCH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_KEY64", raising=False)
    import json

    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path / "port"))
    assert run.main() == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path / "ref"))
    assert _bench_py()._run() == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return got, want


def test_bench_row_matches_reference(monkeypatch, capsys, tmp_path):
    got, want = _rows(monkeypatch, capsys, tmp_path)
    assert list(got) == list(want)
    assert set(got) == ROW_KEYS          # no peak on the CPU in either
    for k in ("metric", "unit", "engine", "samples", "hbm_model_bytes"):
        assert got[k] == want[k], k
    assert got["metric"] == "lhub_jaccard_coefficient_deg64_rmat10_rate"
    assert got["engine"] == "key64" and got["samples"] == 1
    assert got["rate_min"] == got["value"] == got["rate_max"] > 0
    assert got["vs_baseline"] == round(got["value"] / 38.1e6, 4)
    # both caches hold the same graph and deletions, array for array
    with np.load(run.cache_path(str(tmp_path / "port"), 10)) as a, \
            np.load(run.cache_path(str(tmp_path / "ref"), 10)) as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])


def test_bench_plan_matches_reference(tmp_path):
    """The slot total the roofline prices, the deg16 flag and the model
    bytes of the port's plan equal the JAX plan's on the bench graph."""
    y, deletions = run.bench_graph(10, str(tmp_path))
    yr = lp.CSRGraph(offsets=y.offsets, indices=y.indices,
                     degrees=y.degrees, weights=None, n=y.n, m=y.m)
    plan = build_plan(y, 64, cap=None, device="cpu")
    ref = ref_build_plan(yr, 64, cap=None)
    assert plan.packed and ref.packed
    assert int(plan.tile_slot_start[-1]) == int(ref.tile_slot_start[-1]) \
        == plan.total_slots > 0
    assert plan.deg16 == ref.deg16
    assert plan.cap == ref.cap
    assert deletions.shape[0] // 2 > 0


def _forbid(monkeypatch, mod):
    def no(*a, **k):
        raise AssertionError("the graph was made, not read from the cache")

    monkeypatch.setattr(mod, "rmat_graph", no)


def test_bench_cache_cross_loads(monkeypatch, capsys, tmp_path):
    """A cache file written by one package loads in the other as the same
    graph and deletions (neither makes the graph again)."""
    import linkpred_tpu.bench.synth as ref_synth
    from linkpred_tpu_torch.bench import synth

    for k, v in SMALL_BENCH.items():
        monkeypatch.setenv(k, v)
    made, made_del = run.bench_graph(10, str(tmp_path / "port"))
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path / "ref"))
    assert _bench_py()._run() == 0
    capsys.readouterr()
    _forbid(monkeypatch, synth)
    got, got_del = run.bench_graph(10, str(tmp_path / "ref"))
    for f in ("offsets", "indices", "degrees"):
        np.testing.assert_array_equal(getattr(got, f), getattr(made, f))
    assert (got.n, got.m, got.weights) == (made.n, made.m, None)
    np.testing.assert_array_equal(got_del, made_del)
    # bench.py reads the port's file
    _forbid(monkeypatch, ref_synth)
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path / "port"))
    assert _bench_py()._run() == 0
    assert '"metric": "lhub_jaccard_coefficient_deg64_rmat10_rate"' in \
        capsys.readouterr().out


def test_bench_bad_cache_file_is_made_again(monkeypatch, capsys, tmp_path):
    path = run.cache_path(str(tmp_path), 10)
    os.makedirs(tmp_path, exist_ok=True)
    with open(path, "w") as f:
        f.write("not an npz file")
    y, deletions = run.bench_graph(10, str(tmp_path))
    want, want_del = run.bench_graph(10, str(tmp_path))   # now the cache
    np.testing.assert_array_equal(y.indices, want.indices)
    np.testing.assert_array_equal(deletions, want_del)


def test_bench_key64_0_raises(monkeypatch):
    for k, v in SMALL_BENCH.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_KEY64", "0")
    with pytest.raises(NotImplementedError, match="u32 engine"):
        run.main()


def test_bench_needs_the_card_unless_cpu(monkeypatch, tmp_path):
    """Without ``BENCH_DEVICE=cpu`` the run targets the card; with no card
    it raises before any work (no cache file is written)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_SCALE", "10")
    monkeypatch.setenv("BENCH_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run.main()
    monkeypatch.setenv("BENCH_DEVICE", "cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run.main()
    assert not os.listdir(tmp_path)


# ----------------------------------------------------------------------- npz

def _graph_pair(weighted, values):
    rng = np.random.default_rng(5)
    src, dst = rng.integers(0, 90, 400), rng.integers(0, 90, 400)
    w = rng.random(400).astype(np.float32) if weighted else None
    vals = rng.random(90) if values else None
    return (lt.from_edges(src, dst, n=90, weights=w, vertex_values=vals),
            lp.from_edges(src, dst, n=90, weights=w, vertex_values=vals))


def _assert_same_graph(got, want):
    got, want = got.host(), want.host()
    assert (got.n, got.m) == (want.n, want.m)
    for f in ("offsets", "indices", "degrees", "weights", "values"):
        a, b = getattr(got, f), getattr(want, f)
        if b is None:
            assert a is None, f
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("weighted,values", list(itertools.product(
    (False, True), (False, True))))
def test_npz_round_trip_and_cross_load(tmp_path, weighted, values):
    port, ref = _graph_pair(weighted, values)
    _assert_same_graph(port, ref)
    npz.save_graph(port, tmp_path / "port.npz")
    ref_npz.save_graph(ref, tmp_path / "ref.npz")
    _assert_same_graph(npz.load_graph(tmp_path / "port.npz"), port)
    _assert_same_graph(npz.load_graph(tmp_path / "ref.npz"), port)
    _assert_same_graph(ref_npz.load_graph(tmp_path / "port.npz"), ref)
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "ref.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])


def test_npz_saves_a_graph_on_a_device(tmp_path):
    port, _ = _graph_pair(True, False)
    npz.save_graph(port.to("cpu"), str(tmp_path / "t.npz"))
    _assert_same_graph(npz.load_graph(str(tmp_path / "t.npz")), port)


# ----------------------------------------------------------------- profiling

def _trace_dirs(tmp_path):
    return [f for f in os.listdir(tmp_path) if f.startswith("linkpred_trace_")]


def test_profile_fn_on_a_cpu_op(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    a = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)
    result, summary = profiling.profile_fn(torch.mm, a, a, top=5)
    assert torch.equal(result, a @ a)
    assert 0 < len(summary) <= 5
    ms = [t for _, t, _ in summary]
    assert ms == sorted(ms, reverse=True) and all(t >= 0 for t in ms)
    assert ("aten::mm", False) in {(name, dev) for name, _, dev in summary}
    assert not any(dev for _, _, dev in summary), "no card, no device row"
    # the trace profile_fn wrote is gone with its directory
    assert _trace_dirs(tmp_path) == []


def test_summarize_trace_reads_what_trace_wrote(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.as_tensor(np.random.default_rng(0).random(4096))
    with profiling.trace(str(tmp_path / "tr")) as d:
        torch.sort(x)
    assert d == str(tmp_path / "tr")
    assert any(f.endswith(".trace.json.gz") for f in os.listdir(d))
    summary = profiling.summarize_trace(d)
    assert ("aten::sort", False) in {(name, dev) for name, _, dev in summary}
    ms = [t for _, t, _ in summary]
    assert ms == sorted(ms, reverse=True)
    assert len(profiling.summarize_trace(d, top=2)) == 2
    # a host op and a kernel of one name are two rows, each its own sum
    with open(os.path.join(d, "card.trace.json"), "w") as fh:
        json.dump({"traceEvents": [
            {"ph": "X", "cat": "cpu_op", "name": "twin", "dur": 1000},
            {"ph": "X", "cat": "kernel", "name": "twin", "dur": 3000},
            {"ph": "X", "cat": "kernel", "name": "twin", "dur": 2000},
            {"ph": "X", "cat": "gpu_memset", "name": "twin", "dur": 500}]},
            fh)
    rows = {(name, dev): t for name, t, dev in
            profiling.summarize_trace(d, top=1000) if name == "twin"}
    assert rows == {("twin", False): 1.0, ("twin", True): 5.5}


def test_profile_fn_raises_without_device_rows_on_a_card(monkeypatch,
                                                          tmp_path):
    """Where a card is reported, a trace with no device event raises rather
    than return a host-only table, and leaves no trace behind."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    a = torch.ones(8, 8)
    with pytest.raises(RuntimeError, match="no device event"):
        profiling.profile_fn(torch.mm, a, a)
    assert _trace_dirs(tmp_path) == []
