"""The port's MTX reader and writer against ``linkpred_tpu.io.mtx`` on the
same files: the reference fixture and generated files (pattern and real
fields; general, symmetric and skew-symmetric headers; comments; the third
column read or ignored; paths and file-like inputs; the native C++ body
parser and the NumPy tokenizer).  Graphs must be equal field for field
(offsets, indices, degrees, weights, n, m); written files byte for byte.
"""
import io
import os

import numpy as np
import pytest

from linkpred_tpu import from_edges as ref_from_edges
from linkpred_tpu.io import mtx as ref_mtx
from linkpred_tpu.io import native as ref_native

import linkpred_tpu_torch as lt
from linkpred_tpu_torch.io import mtx, native

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "fixture_graph.mtx")


def _assert_same_graph(got, want):
    got, want = got.host(), want.host()
    assert (got.n, got.m) == (want.n, want.m)
    for field in ("offsets", "indices", "degrees"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    if want.weights is None:
        assert got.weights is None
    else:
        assert got.weights.dtype == want.weights.dtype
        np.testing.assert_array_equal(got.weights, want.weights)


def _mtx_text(rng, field, symmetry, comments, n=40, m=120):
    """An MTX file of ``m`` random 1-indexed entries (duplicates and
    self-loops included)."""
    rows = rng.integers(1, n + 1, m)
    cols = rng.integers(1, n + 3, m)       # cols > rows: n = max(rows, cols)
    lines = [f"%%MatrixMarket matrix coordinate {field} {symmetry}"]
    if comments:
        lines += ["% a comment", "%", "%-- another"]
    lines.append(f"{n} {n + 2} {m}")
    for i, (r, c) in enumerate(zip(rows, cols)):
        if field == "pattern":
            lines.append(f"{r} {c}")
        else:
            lines.append(f"{r} {c} {rng.random() * 10 - 2:.6g}")
        if comments and i == m // 2:
            lines.append("% a comment inside the body")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_fixture_matches_reference(use_native, weighted):
    got = mtx.read_mtx(FIXTURE, weighted=weighted, use_native=use_native)
    want = ref_mtx.read_mtx(FIXTURE, weighted=weighted, use_native=use_native)
    _assert_same_graph(got, want)
    assert got.n == 400


@pytest.mark.parametrize("symmetrize,remove_self_loops",
                         [(True, False), (False, True), (True, True)])
def test_fixture_transforms_match_reference(symmetrize, remove_self_loops):
    kw = dict(symmetrize=symmetrize, remove_self_loops=remove_self_loops)
    _assert_same_graph(mtx.read_mtx(FIXTURE, **kw),
                       ref_mtx.read_mtx(FIXTURE, **kw))


@pytest.mark.parametrize("source", ["path", "text"])
@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("field,symmetry,comments", [
    ("pattern", "general", False),
    ("pattern", "symmetric", True),
    ("real", "general", True),
    ("real", "symmetric", False),
    ("real", "skew-symmetric", True),
    ("integer", "general", False),
])
def test_generated_files_match_reference(tmp_path, field, symmetry, comments,
                                         weighted, use_native, source):
    text = _mtx_text(np.random.default_rng(len(field) * 7 + len(symmetry)),
                     field, symmetry, comments)
    path = tmp_path / "g.mtx"
    path.write_text(text)

    def read(module, native_parser):
        arg = str(path) if source == "path" else io.StringIO(text)
        try:
            return module.read_mtx(arg, weighted=weighted,
                                   use_native=native_parser)
        except ValueError:
            return ValueError

    got, want = read(mtx, use_native), read(ref_mtx, use_native)
    # the in-memory NumPy tokenizer takes no comment inside the body: it
    # raises in both packages
    if source == "text" and comments and not use_native:
        assert got is want is ValueError
        return
    _assert_same_graph(got, want)
    assert got.n == 42
    other = read(mtx, not use_native)
    if other is not ValueError:
        _assert_same_graph(other, got)


def test_native_parser_is_built_and_matches_reference():
    assert native.native_lib() is not None
    assert native._SO.startswith(native.BUILD_DIR)
    body = b"1 2 0.5\n3 4 1e3\n% c\n5 6 -2\n"
    for weighted in (False, True):
        got = native.parse_mtx_body(body, 3, weighted)
        want = ref_native.parse_mtx_body(body, 3, weighted)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix array real general\n3 3\n1\n2\n3\n",
    "%%MatrixMarket vector coordinate real general\n3 3 1\n1 1 1\n",
    "",
])
def test_non_coordinate_is_empty_graph(tmp_path, text):
    path = tmp_path / "e.mtx"
    path.write_text(text)
    got = mtx.read_mtx(str(path))
    _assert_same_graph(got, ref_mtx.read_mtx(str(path)))
    assert (got.n, got.m) == (0, 0)


def test_header_matches_reference(tmp_path):
    text = _mtx_text(np.random.default_rng(1), "real", "skew-symmetric", True)
    path = tmp_path / "h.mtx"
    path.write_text(text)
    for arg in (str(path), io.StringIO(text)):
        h = mtx.read_mtx_header(arg)
        r = ref_mtx.read_mtx_header(str(path))
        assert (h.symmetric, h.rows, h.cols, h.size, h.field) == \
            (r.symmetric, r.rows, r.cols, r.size, r.field) == \
            (True, 40, 42, 120, "real")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("sink", ["path", "buffer"])
def test_write_mtx_byte_equal(tmp_path, weighted, sink):
    rng = np.random.default_rng(3)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    # quarters print exactly under write_mtx's %g, so the file reads back
    w = (rng.integers(1, 16, 300) / 4).astype(np.float32)
    g_port = lt.from_edges(src, dst, n=55, weights=w if weighted else None)
    g_ref = ref_from_edges(src, dst, n=55, weights=w if weighted else None)
    if sink == "path":
        mtx.write_mtx(g_port, str(tmp_path / "a.mtx"), weighted=weighted)
        ref_mtx.write_mtx(g_ref, str(tmp_path / "b.mtx"), weighted=weighted)
        got = (tmp_path / "a.mtx").read_bytes()
        want = (tmp_path / "b.mtx").read_bytes()
    else:
        a, b = io.StringIO(), io.StringIO()
        mtx.write_mtx(g_port, a, weighted=weighted)
        ref_mtx.write_mtx(g_ref, b, weighted=weighted)
        got, want = a.getvalue(), b.getvalue()
    assert got == want
    # and it reads back as the same graph
    back = mtx.read_mtx(io.StringIO(got if isinstance(got, str)
                                    else got.decode()), weighted=weighted)
    _assert_same_graph(back, g_port)
