"""The port's experiment driver against the JAX package's on the CPU, with
the same seeded inputs: the batch generators (pairs and the generator's
state after each call), ``run_batches`` callback by callback, the pair
helpers, ``run_experiment(device="cpu")`` row by row (fused and unfused,
JSON lines, an insertion fraction > 0) and the CLI (fused and
``--unfused``), which must raise without ``--device cpu`` where there is
no card.

Rows must be equal field for field, except the times and the backend tag
(``Tpu``/``TpuFused`` in the JAX package, ``Cuda``/``CudaFused`` in the
port).  Precision and recall are equal, or differ by at most what the pairs
tied at the k-th score allow: both packages return the same pairs above
that score, and may pick other pairs among those tied with it.
"""
import json

import numpy as np
import pytest
import torch

import linkpred_tpu as lp
from linkpred_tpu import cli as ref_cli
from linkpred_tpu.bench import harness as ref_harness
from linkpred_tpu.bench.process import read_log as ref_read_log
from linkpred_tpu.ops import batch as ref_batch
from linkpred_tpu.ops.transform import remove_self_loops as ref_rsl
from linkpred_tpu.ops.transform import symmetrize as ref_sym

import linkpred_tpu_torch as lt
from linkpred_tpu_torch import cli
from linkpred_tpu_torch.bench import harness
from linkpred_tpu_torch.bench.process import read_log
from linkpred_tpu_torch.ops import batch
from linkpred_tpu_torch.ops.transform import remove_self_loops, symmetrize

METRICS3 = ("common_neighbors", "jaccard_coefficient", "adamic_adar")
SMALL = dict(repeat_batch=1, repeat_method=1, deletions_begin=0.05,
             deletions_end=0.05, degrees=(0, 64), cap=1 << 14)


def _edges(seed, n_comm=6, size=22, p_in=0.5, p_out=0.01):
    """Directed edge arrays of a planted-partition graph (dense
    communities, so removed edges are recoverable)."""
    rng = np.random.default_rng(seed)
    n = n_comm * size
    blocks = []
    for c in range(n_comm):
        u, v = np.nonzero(rng.random((size, size)) < p_in)
        blocks.append(np.stack([c * size + u, c * size + v], axis=1))
    m_out = int(p_out * n * n)
    blocks.append(rng.integers(0, n, (m_out, 2)))
    e = np.concatenate(blocks)
    return e[:, 0], e[:, 1], n


def _graphs(seed=1, **kw):
    """The same community graph in both packages, symmetric, no self-loops."""
    src, dst, n = _edges(seed, **kw)
    ref = ref_rsl(ref_sym(lp.from_edges(src, dst, n=n)))
    port = remove_self_loops(symmetrize(lt.from_edges(src, dst, n=n)))
    _assert_same_csr(port, ref)
    return port, ref


def _assert_same_csr(got, want):
    got, want = got.host(), want.host()
    assert (got.n, got.m) == (want.n, want.m)
    for f in ("offsets", "indices", "degrees"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    if want.weights is None:
        assert got.weights is None
    else:
        np.testing.assert_array_equal(got.weights, want.weights)


# ------------------------------------------------------------ batch generators

def _assert_same_state(rng_a, rng_b):
    assert rng_a.bit_generator.state == rng_b.bit_generator.state
    assert rng_a.integers(0, 1 << 62) == rng_b.integers(0, 1 << 62)


@pytest.mark.parametrize("batch_size", [0, -3, 1, 57])
@pytest.mark.parametrize("undirected", [True, False])
def test_generate_edge_insertions_bit_equal(batch_size, undirected):
    port, ref = _graphs()
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(3):      # state carried across calls, as in a sweep
        got = batch.generate_edge_insertions(a, port, batch_size, undirected)
        want = ref_batch.generate_edge_insertions(b, ref, batch_size,
                                                  undirected)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        assert a.bit_generator.state == b.bit_generator.state
    _assert_same_state(a, b)


def test_generate_edge_insertions_empty_graph_draws_nothing():
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    empty_p = lt.from_edges(np.empty(0, np.int64), np.empty(0, np.int64), n=0)
    empty_r = lp.from_edges(np.empty(0, np.int64), np.empty(0, np.int64), n=0)
    got = batch.generate_edge_insertions(a, empty_p, 10)
    want = ref_batch.generate_edge_insertions(b, empty_r, 10)
    assert got.shape == want.shape == (0, 2)
    assert a.bit_generator.state == np.random.default_rng(5).bit_generator.state
    _assert_same_state(a, b)


@pytest.mark.parametrize("batch_size", [0, 1, 40])
def test_generate_edge_deletions_bit_equal(batch_size):
    port, ref = _graphs()
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        got = batch.generate_edge_deletions(a, port, batch_size)
        want = ref_batch.generate_edge_deletions(b, ref, batch_size)
        np.testing.assert_array_equal(got, want)
        assert a.bit_generator.state == b.bit_generator.state
    _assert_same_state(a, b)


@pytest.mark.parametrize("ins_begin,ins_end", [(0.0, 0.0), (0.01, 0.05)])
def test_run_batches_callback_by_callback(ins_begin, ins_end):
    port, ref = _graphs()
    cfg = dict(repeat_batch=2, batch_length=2, deletions_begin=1e-2,
               deletions_end=1e-1, deletions_step=3.0,
               insertions_begin=ins_begin, insertions_end=ins_end,
               insertions_step=3.0)
    calls = {"port": [], "ref": []}

    def record(side):
        def fn(y, d, dels, i, ins, seq, ep):
            calls[side].append((y, d, dels, i, ins, seq, ep))
        return fn

    a, b = np.random.default_rng(11), np.random.default_rng(11)
    harness.run_batches(port, a, record("port"),
                        harness.ExperimentConfig(**cfg))
    ref_harness.run_batches(ref, b, record("ref"),
                            ref_harness.ExperimentConfig(**cfg))
    # fractions 0.01, 0.03, 0.09, 0.1: 4 epochs x 2 repeats x 2 sequences
    assert len(calls["port"]) == len(calls["ref"]) == 4 * 2 * 2
    for got, want in zip(calls["port"], calls["ref"]):
        _assert_same_csr(got[0], want[0])
        assert got[1] == want[1] and got[3] == want[3]      # fractions
        assert got[5:] == want[5:]                          # sequence, epoch
        for x, y in ((got[2], want[2]), (got[4], want[4])):  # the batch
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert [c[6] for c in calls["port"]] == sorted(list(range(4)) * 4)
    assert [c[5] for c in calls["port"]] == [0, 1] * 8
    assert any(c[4].shape[0] for c in calls["port"]) == (ins_end > 0)
    _assert_same_state(a, b)


# ------------------------------------------------------------- pair helpers

@pytest.mark.parametrize("pairs,undirected", [
    (np.array([[3, 1], [0, 2], [3, 1]]), True),
    (np.array([[3, 1], [0, 2], [3, 1]]), False),
    (np.empty((0, 2), np.int64), True),
    (np.array([[5, 5]]), True),
    (np.array([2, 7, 7, 2]), False),
    (np.array([[1, 2], [2, 1], [1, 2], [0, 9]], np.int32), True),
])
def test_directed_pairs_matches_reference(pairs, undirected):
    got = harness.directed_pairs(pairs, undirected)
    want = ref_harness.directed_pairs(pairs, undirected)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("a,b,count", [
    ([[0, 1], [1, 0], [2, 3]], [[1, 0], [2, 3], [4, 5]], 2),
    ([[0, 1]], [], 0),
    ([], [[0, 1]], 0),
    ([[0, 7], [7, 0]], [[0, 7], [7, 0]], 2),
    ([[0, 1], [1, 0]], [[0, 2], [2, 0]], 0),
])
def test_common_pair_count_matches_reference(a, b, count):
    a = np.asarray(a, np.int64).reshape(-1, 2)
    b = np.asarray(b, np.int64).reshape(-1, 2)
    assert harness.common_pair_count(a, b) == \
        ref_harness.common_pair_count(a, b) == count


# ------------------------------------------------------------ run_experiment

class _Recorder:
    """Wraps a harness module's predict calls and ``common_pair_count`` to
    record, row by row, how many predicted pairs tie with the k-th score
    and the counts that precision and recall are made of."""

    def __init__(self, monkeypatch, mod):
        self.ties, self.counts = [], []
        multi, single, common = (mod.predict_links_multi, mod.predict_links,
                                 mod.common_pair_count)

        def ties(res, k):
            score = np.asarray(res.score)
            if not len(score) or len(score) < k:
                return 0
            return int(np.count_nonzero(score <= score[-1] * (1 + 1e-5)))

        def rec_multi(g, metrics, **kw):
            out = multi(g, metrics, **kw)
            self.ties += [ties(out[m], kw["options"].max_edges)
                          for m in metrics]
            return out

        def rec_single(g, metric, **kw):
            out = single(g, metric=metric, **kw)
            self.ties.append(ties(out, kw["options"].max_edges))
            return out

        def rec_common(a, b):
            c = common(a, b)
            self.counts.append((c, a.shape[0], b.shape[0]))
            return c

        monkeypatch.setattr(mod, "predict_links_multi", rec_multi)
        monkeypatch.setattr(mod, "predict_links", rec_single)
        monkeypatch.setattr(mod, "common_pair_count", rec_common)


def _assert_rows_match(got, want, rec_got, rec_want, threads=None):
    """Rows equal except the times and the tag; precision/recall up to
    the pairs tied at the k-th score."""
    assert len(got) == len(want) == len(rec_got.counts) == \
        len(rec_want.counts) == len(rec_got.ties) == len(rec_want.ties) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g["technique"] == w["technique"].replace("Tpu", "Cuda")
        assert "Tpu" not in g["technique"] and "Cuda" in g["technique"]
        for f in ("batch_deletions_fraction", "batch_insertions_fraction"):
            assert g[f] == w[f], f
        if threads is None:
            assert g["num_threads"] == w["num_threads"]
        else:
            assert (g["num_threads"], w["num_threads"]) == threads
        assert g["total_time"] >= g["scoring_time"] >= 0
        (cg, dg, ig), (cw, dw, iw) = rec_got.counts[i], rec_want.counts[i]
        assert (dg, ig) == (dw, iw), g["technique"]
        assert abs(cg - cw) <= 2 * max(rec_got.ties[i], rec_want.ties[i]), \
            (g["technique"], cg, cw, rec_got.ties[i])
        assert g["precision"] == cg / max(ig, 1)
        assert g["recall"] == cg / max(dg, 1)
        if cg == cw:
            assert (g["precision"], g["recall"]) == \
                (w["precision"], w["recall"])


@pytest.mark.parametrize("kw", [
    dict(metrics=METRICS3, fused_metrics=True),
    dict(metrics=METRICS3, fused_metrics=False),
    dict(metrics=("jaccard",), fused_metrics=True),
    dict(metrics=("cn", "ra"), insertions_begin=0.02, insertions_end=0.02,
         deletions_begin=0.02, deletions_end=0.1, deletions_step=5.0),
], ids=["fused", "unfused", "one-metric", "insertions"])
def test_run_experiment_rows_match_reference(monkeypatch, kw):
    port, ref = _graphs()
    cfg = dict(SMALL, seed=3, num_threads=4)
    cfg.update(kw)
    rec_p = _Recorder(monkeypatch, harness)
    rec_r = _Recorder(monkeypatch, ref_harness)
    lines_p, lines_r = [], []
    got = harness.run_experiment(
        port, harness.ExperimentConfig(device="cpu", **cfg), lines_p.append)
    want = ref_harness.run_experiment(
        ref, ref_harness.ExperimentConfig(**cfg), lines_r.append)
    _assert_rows_match(got, want, rec_p, rec_r)
    tags = {r["technique"][len("predictLinks"):].rstrip("0123456789")
            for r in got}
    amortized = kw["fused_metrics"] if "fused_metrics" in kw else True
    amortized = amortized and len(cfg["metrics"]) > 1
    assert all(t.endswith("CudaFused" if amortized else "Cuda")
               for t in tags), tags
    assert len(lines_p) == len(got)
    assert max(r["recall"] for r in got) > 0.1


def test_run_experiment_jsonl_matches_reference(monkeypatch):
    port, ref = _graphs(seed=2)
    cfg = dict(SMALL, seed=4, metrics=("cn", "salton"), jsonl=True)
    rec_p = _Recorder(monkeypatch, harness)
    rec_r = _Recorder(monkeypatch, ref_harness)
    lines_p, lines_r = [], []
    got = harness.run_experiment(
        port, harness.ExperimentConfig(device="cpu", **cfg), lines_p.append)
    want = ref_harness.run_experiment(
        ref, ref_harness.ExperimentConfig(**cfg), lines_r.append)
    parsed_p = [json.loads(x) for x in lines_p]
    parsed_r = [json.loads(x) for x in lines_r]
    assert parsed_p == got and parsed_r == want
    assert list(parsed_p[0]) == list(parsed_r[0])     # same keys, same order
    # the label is the count of devices of the type asked for: 1 CPU here
    _assert_rows_match(got, want, rec_p, rec_r,
                       threads=(1, want[0]["num_threads"]))


def test_run_experiment_needs_the_card_unless_cpu(monkeypatch):
    port, _ = _graphs()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(harness, "run_batches",
                        lambda *a, **k: called.append(1))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        harness.run_experiment(port, harness.ExperimentConfig(**SMALL))
    assert not called        # raised before any batch work
    assert harness.ExperimentConfig().device == "cuda"


# ----------------------------------------------------------------------- CLI

CLI_ARGS = ["--metrics", "cn,aa", "--degrees", "0,32", "--repeat-batch", "1",
            "--repeat-method", "1", "--deletions-begin", "0.05",
            "--deletions-end", "0.05", "--seed", "7", "--cap", str(1 << 14)]


@pytest.mark.parametrize("extra", [[], ["--unfused"]], ids=["fused",
                                                             "unfused"])
def test_cli_rows_match_reference(tmp_path, capsys, monkeypatch, extra):
    port, _ = _graphs(seed=6, n_comm=4, size=15, p_in=0.6)
    path = tmp_path / "toy.mtx"
    lt.write_mtx(port, str(path))
    rec_p = _Recorder(monkeypatch, harness)
    rec_r = _Recorder(monkeypatch, ref_harness)
    logs = {}
    for side, main, args in (("port", cli.main, ["--device", "cpu"]),
                             ("ref", ref_cli.main, [])):
        assert main([str(path), "1", "0", *CLI_ARGS, *extra, *args]) == 0
        logs[side] = tmp_path / f"{side}.log"
        logs[side].write_text(capsys.readouterr().out)
    got = read_log(str(logs["port"]))["toy"]
    want = read_log(str(logs["ref"]))["toy"]
    assert ref_read_log(str(logs["port"])) == {"toy": got}
    assert len(got) == 4
    n_ref = want[0]["num_threads"]
    for g, w in zip(got, want):
        assert (g["omp_num_threads"], g["num_threads"]) == (1, 1)
        assert w["omp_num_threads"] == w["num_threads"] == n_ref
        assert (g["graph"], g["order"], g["size"]) == \
            (w["graph"], w["order"], w["size"]) == ("toy", port.n, port.m)
    # the log rounds precision and recall to 4 digits: compare the rows
    # through the counts they were printed from
    rows = [dict(r, precision=c / max(i, 1), recall=c / max(d, 1))
            for r, (c, d, i) in zip(got, rec_p.counts)]
    rows_r = [dict(r, precision=c / max(i, 1), recall=c / max(d, 1))
              for r, (c, d, i) in zip(want, rec_r.counts)]
    _assert_rows_match(rows, rows_r, rec_p, rec_r, threads=(1, n_ref))
    for r, full in zip(got, rows):
        assert f"{r['precision']:.3e}" == f"{full['precision']:.3e}"
    techniques = {r["technique"] for r in got}
    tag = "Cuda" if extra else "CudaFused"
    assert techniques == {f"predictLinksCommonNeighbors{tag}0",
                          f"predictLinksCommonNeighbors{tag}32",
                          f"predictLinksAdamicAdarCoefficient{tag}0",
                          f"predictLinksAdamicAdarCoefficient{tag}32"}


def test_cli_defaults_match_reference():
    got = vars(cli.build_parser().parse_args(["g.mtx"]))
    want = vars(ref_cli.build_parser().parse_args(["g.mtx"]))
    assert got.pop("device") == "cuda"
    assert got == want
    assert got["cap"] == 1 << 20 and got["seed"] is None


def test_cli_raises_without_a_card(tmp_path, monkeypatch):
    port, _ = _graphs()
    path = tmp_path / "toy.mtx"
    lt.write_mtx(port, str(path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main([str(path), "1", "0", *CLI_ARGS])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main([str(path), "1", "0", *CLI_ARGS, "--device", "cuda"])


def test_technique_names_match_reference():
    from linkpred_tpu.predict.metrics import TECHNIQUE_NAMES as ref_names

    from linkpred_tpu_torch.predict.metrics import TECHNIQUE_NAMES

    assert TECHNIQUE_NAMES == ref_names
    assert set(TECHNIQUE_NAMES) == set(lt.METRICS)
