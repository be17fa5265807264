"""The port's log → CSV post-processor and log grammar against the JAX
package's: the reference's own log (``tests/fixtures/reference_run.log``)
must give ``tests/fixtures/reference_run.csv`` byte for byte, in file and in
directory mode; ``_js_repr`` must stringify as the JAX package's does; the
grammar's lines must be the same strings.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from linkpred_tpu.bench import process as ref_process
from linkpred_tpu.utils import logging as ref_logging

from linkpred_tpu_torch.bench import process
from linkpred_tpu_torch.utils import logging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(REPO, "tests", "fixtures")
LOG = os.path.join(FIXDIR, "reference_run.log")
CSV = os.path.join(FIXDIR, "reference_run.csv")


def test_fixture_csv_byte_equal(tmp_path):
    out = tmp_path / "ours.csv"
    ref_out = tmp_path / "ref.csv"
    assert process.main(["csv", LOG, str(out)]) == 0
    assert ref_process.main(["csv", LOG, str(ref_out)]) == 0
    assert out.read_bytes() == open(CSV, "rb").read() == ref_out.read_bytes()


def test_fixture_csv_dir_mode_byte_equal(tmp_path):
    out = tmp_path / "by_graph"
    ref_out = tmp_path / "ref_by_graph"
    assert process.main(["csv", LOG, str(out)]) == 0
    assert ref_process.main(["csv", LOG, str(ref_out)]) == 0
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref_out)) \
        == ["fixture_graph.csv"]
    got = (out / "fixture_graph.csv").read_bytes()
    assert got == (ref_out / "fixture_graph.csv").read_bytes()
    assert got == open(CSV, "rb").read()


def test_module_entry_point(tmp_path):
    out = tmp_path / "cli.csv"
    r = subprocess.run([sys.executable, "-m", "linkpred_tpu_torch.bench.process",
                        "csv", LOG, str(out)], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert out.read_bytes() == open(CSV, "rb").read()
    r = subprocess.run([sys.executable, "-m", "linkpred_tpu_torch.bench.process",
                        "csv", LOG], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 2 and "usage" in r.stderr


def test_unknown_command(tmp_path):
    assert process.main(["json", LOG, str(tmp_path / "x.csv")]) == \
        ref_process.main(["json", LOG, str(tmp_path / "y.csv")]) == 2


def test_read_log_matches_reference():
    assert process.read_log(LOG) == ref_process.read_log(LOG)


def _float_grid():
    rng = np.random.default_rng(0)
    exps = np.arange(-25, 26, dtype=np.float64)
    grid = [0.0, -0.0, 1.0, -1.0, 0.1, 4.0, 1e21, 1e-7, 1.5e-7, 123456789.0,
            1e20, 9.999e20, 1e-6, 2.5e-6, 0.3 - 0.1, float("nan"),
            float("inf"), float("-inf")]
    grid += list(rng.random(40) * 10.0 ** rng.choice(exps, 40))
    grid += list(-rng.random(20) * 10.0 ** rng.choice(exps, 20))
    grid += [np.float32(x) for x in rng.random(20)]
    # the parsed cells are Python floats
    return [float(x) for x in grid]


def test_js_repr_matches_reference():
    for v in _float_grid() + [3, "predictLinksJaccardCoefficientCuda64",
                              "fixture_graph"]:
        assert process._js_repr(v) == ref_process._js_repr(v), v


@pytest.mark.parametrize("args", [
    (0.0, 1e-3, 8, 1234.5, 1000.25, 0.125, 0.5,
     "predictLinksJaccardCoefficientCuda64"),
    (0.0, 0.1, 1, 0.04, 0.0, 0.0, 0.0, "predictLinksCommonNeighborsCuda0"),
    (0.0, 1e-4, 123, 9876543.21, 12.345678, 1.0, 3.3333e-5,
     "predictLinksResourceAllocationScoreCudaFused1024"),
])
def test_result_line_matches_reference(args):
    assert logging.result_line(*args) == ref_logging.result_line(*args)


@pytest.mark.parametrize("n,m,directed", [(400, 1089, True), (0, 0, False),
                                          (262144, 7610426, True)])
def test_graph_line_matches_reference(n, m, directed):
    assert logging.graph_line(n, m, directed) == \
        ref_logging.graph_line(n, m, directed)


def test_log_line_grammar_parses(tmp_path, capsys):
    logging.log("OMP_NUM_THREADS=1")
    logging.log("Loading graph /data/web-Stanford.mtx ...")
    logging.log(logging.graph_line(281903, 3985272))
    line = logging.result_line(0.0, 1e-3, 1, 12.5, 10.25, 0.125, 0.5,
                               "predictLinksJaccardCoefficientCuda64")
    text = capsys.readouterr().out + line + "\n"
    path = tmp_path / "t.log"
    path.write_text(text)
    (row,) = process.read_log(str(path))["web-Stanford"]
    assert row == ref_process.read_log(str(path))["web-Stanford"][0]
    assert (row["omp_num_threads"], row["order"], row["size"]) == \
        (1, 281903, 3985272)
    assert row["technique"] == "predictLinksJaccardCoefficientCuda64"
