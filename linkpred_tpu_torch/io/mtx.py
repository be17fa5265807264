"""Matrix Market (.mtx) reader and writer (counterpart of
``linkpred_tpu/io/mtx.py``).

The reference reader's rules:

* header grammar ``%%MatrixMarket matrix coordinate <field> <symmetry>``;
  a file that is not ``matrix coordinate`` gives an empty graph;
* ``symmetric`` / ``skew-symmetric`` headers add the reverse edge of every
  body line;
* vertices are 1-indexed in the file and 0-based here, with
  ``n = max(rows, cols)``;
* ``weighted=False`` ignores any third column.

Paths are mmapped and parsed by the native C++ body parser
(``native/src/mtx_native.cpp``, built by :mod:`linkpred_tpu_torch.io.native`)
or, without it, by a chunked NumPy tokenizer; file-like inputs are parsed in
memory.  Graph construction is host work: the result has NumPy leaves.
"""
from __future__ import annotations

import io
import os
from typing import TextIO, Union

import numpy as np

from ..graph import CSRGraph, from_edges, edge_list

__all__ = ["read_mtx", "read_mtx_header", "write_mtx", "MtxHeader"]


class MtxHeader:
    __slots__ = ("symmetric", "rows", "cols", "size", "field", "object")

    def __init__(self, symmetric: bool, rows: int, cols: int, size: int,
                 field: str = "real", object_: str = "matrix") -> None:
        self.symmetric = symmetric
        self.rows = rows
        self.cols = cols
        self.size = size
        self.field = field
        self.object = object_

    def __repr__(self) -> str:  # pragma: no cover
        return (f"MtxHeader(symmetric={self.symmetric}, rows={self.rows}, "
                f"cols={self.cols}, size={self.size}, field={self.field!r})")


def _read_text(path_or_buf: Union[str, os.PathLike, TextIO]) -> str:
    if hasattr(path_or_buf, "read"):
        data = path_or_buf.read()
        return data.decode() if isinstance(data, bytes) else data
    with open(path_or_buf, "rb") as f:
        return f.read().decode("utf-8", errors="replace")


def _parse_header(text: str) -> tuple[MtxHeader, int]:
    """Parse comments + size line; return (header, offset of body start)."""
    h1 = h2 = h3 = h4 = ""
    pos = 0
    line = ""
    while pos < len(text):
        nl = text.find("\n", pos)
        if nl < 0:
            nl = len(text)
        line = text[pos:nl]
        if not line.startswith("%"):
            break
        if line.startswith("%%"):
            parts = line.split()
            # "%%MatrixMarket matrix coordinate real general"
            h1 = parts[1] if len(parts) > 1 else ""
            h2 = parts[2] if len(parts) > 2 else ""
            h3 = parts[3] if len(parts) > 3 else ""
            h4 = parts[4] if len(parts) > 4 else ""
        pos = nl + 1
    if h1 != "matrix" or h2 != "coordinate":
        return MtxHeader(False, 0, 0, 0, field=h3 or "real"), len(text)
    sym = h4 in ("symmetric", "skew-symmetric")
    parts = line.split()
    rows, cols, size = (int(parts[0]), int(parts[1]), int(parts[2])) if len(parts) >= 3 else (0, 0, 0)
    nl = text.find("\n", pos)
    body = len(text) if nl < 0 else nl + 1
    return MtxHeader(sym, rows, cols, size, field=h3 or "real"), body


def read_mtx_header(path_or_buf: Union[str, os.PathLike, TextIO]) -> MtxHeader:
    """The header only (the reference's ``readMtxHeader``)."""
    if hasattr(path_or_buf, "read"):
        text = _read_text(path_or_buf)
    else:
        # Headers are tiny; read a bounded prefix.
        with open(path_or_buf, "rb") as f:
            text = f.read(1 << 20).decode("utf-8", errors="replace")
    header, _ = _parse_header(text)
    return header


def read_mtx(
    path_or_buf: Union[str, os.PathLike, TextIO],
    weighted: bool = False,
    symmetrize: bool = False,
    remove_self_loops: bool = False,
    use_native: bool = True,
) -> CSRGraph:
    """Read an MTX file into a :class:`CSRGraph`.

    ``symmetrize`` / ``remove_self_loops`` fold the driver's post-load
    transforms into the one construction.

    Path inputs are mmapped: the native body parser walks the page cache
    directly, so no in-memory copy of the text exists (multi-GB files must
    never be held as one Python string).  Without the native library, a
    chunked NumPy tokenizer bounds the transient text copy to ``_CHUNK``
    bytes.  File-like inputs use the in-memory path.
    """
    if not hasattr(path_or_buf, "read"):
        return _read_mtx_mmap(path_or_buf, weighted, symmetrize,
                              remove_self_loops, use_native)
    text = _read_text(path_or_buf)
    header, body = _parse_header(text)
    n = max(header.rows, header.cols)
    if n == 0:
        return from_edges(np.empty(0, np.int64), np.empty(0, np.int64), n=0)

    if use_native and header.size > 0:
        from .native import parse_mtx_body

        parsed = parse_mtx_body(
            text[body:].encode("utf-8", errors="replace"), header.size, weighted)
        if parsed is not None:
            psrc, pdst, pw = parsed
            return _finish(psrc - 1, pdst - 1,
                           None if not weighted else (
                               pw.astype(np.float32) if pw is not None
                               else np.ones(psrc.shape[0], np.float32)),
                           n, header.symmetric, symmetrize, remove_self_loops)

    # Tokenize the whole body at once; rows have 2 (pattern) or 3+ columns.
    tokens = text[body:].split()
    flat = np.array(tokens, dtype=np.float64) if tokens else np.empty(0)
    ncol = 0
    if header.size > 0 and flat.size:
        if flat.size % header.size == 0:
            ncol = flat.size // header.size
        else:
            # Trailing junk / short file: infer from first line.
            first_nl = text.find("\n", body)
            ncol = len(text[body:first_nl].split())
    if ncol not in (2, 3, 4):
        ncol = 3 if flat.size % 3 == 0 and flat.size % 2 != 0 else 2
    nrows = flat.size // ncol if ncol else 0
    table = flat[: nrows * ncol].reshape(nrows, ncol) if nrows else np.empty((0, 2))

    src = table[:, 0].astype(np.int64) - 1
    dst = table[:, 1].astype(np.int64) - 1
    w = table[:, 2].astype(np.float32) if (weighted and ncol >= 3) else (
        np.ones(nrows, dtype=np.float32) if weighted else None)
    return _finish(src, dst, w, n, header.symmetric, symmetrize, remove_self_loops)


# Transient text bound of the chunked NumPy tokenizer (bytes per block).
_CHUNK = 64 << 20


def _read_mtx_mmap(path, weighted, symmetrize, remove_self_loops,
                   use_native) -> CSRGraph:
    import mmap

    with open(path, "rb") as f:
        try:
            # ACCESS_COPY (private CoW) keeps the buffer ctypes-viewable for the
            # zero-copy native parse; nothing ever writes, so no pages copy.
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        except ValueError:  # empty file
            return from_edges(np.empty(0, np.int64), np.empty(0, np.int64), n=0)
    try:
        # Header is ASCII near the top; latin-1 keeps str offsets == byte
        # offsets.  Grow the decoded prefix if a pathological comment block
        # pushes the size line past it.
        pref = 1 << 20
        while True:
            head = mm[: min(pref, mm.size())].decode("latin-1")
            header, body = _parse_header(head)
            if body < len(head) or pref >= mm.size():
                break
            pref *= 4
        n = max(header.rows, header.cols)
        if n == 0:
            return from_edges(np.empty(0, np.int64), np.empty(0, np.int64), n=0)

        if use_native and header.size > 0:
            from .native import parse_mtx_buffer

            parsed = parse_mtx_buffer(mm, body, mm.size() - body,
                                      header.size, weighted)
            if parsed is not None:
                psrc, pdst, pw = parsed
                return _finish(psrc - 1, pdst - 1,
                               None if not weighted else (
                                   pw.astype(np.float32) if pw is not None
                                   else np.ones(psrc.shape[0], np.float32)),
                               n, header.symmetric, symmetrize,
                               remove_self_loops)

        # Chunked NumPy fallback: tokenize _CHUNK-sized blocks split on line
        # boundaries; peak transient memory is one block + numeric columns.
        cols = []
        pos = body
        ncol = 0
        while pos < mm.size():
            end = min(pos + _CHUNK, mm.size())
            if end < mm.size():
                end = mm.rfind(b"\n", pos, end) + 1
                if end <= pos:
                    end = min(pos + _CHUNK, mm.size())
            block = mm[pos:end].decode("latin-1")
            pos = end
            if "%" in block:
                block = "\n".join(ln for ln in block.splitlines()
                                  if not ln.lstrip().startswith("%"))
            tokens = block.split()
            if not tokens:
                continue
            if ncol == 0:
                first = block.lstrip().split("\n", 1)[0]
                ncol = len(first.split())
                if ncol not in (2, 3, 4):
                    ncol = 2
            flat = np.array(tokens, dtype=np.float64)
            nrows = flat.size // ncol
            cols.append(flat[: nrows * ncol].reshape(nrows, ncol))
        table = np.concatenate(cols) if cols else np.empty((0, 2))
        src = table[:, 0].astype(np.int64) - 1
        dst = table[:, 1].astype(np.int64) - 1
        w = table[:, 2].astype(np.float32) if (weighted and ncol >= 3) else (
            np.ones(table.shape[0], dtype=np.float32) if weighted else None)
        return _finish(src, dst, w, n, header.symmetric, symmetrize,
                       remove_self_loops)
    finally:
        try:
            mm.close()
        except BufferError:
            # the ctypes view handed to the native parser is freed via a GC
            # cycle; collect, then unmap
            import gc

            gc.collect()
            mm.close()


def _finish(src, dst, w, n, header_symmetric, symmetrize, remove_self_loops) -> CSRGraph:
    if header_symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if w is not None:
            w = np.concatenate([w, w])
    if symmetrize:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        if w is not None:
            w = np.concatenate([w, w])
    if remove_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        if w is not None:
            w = w[keep]
    return from_edges(src, dst, n=n, weights=w)


def write_mtx(g: CSRGraph, path_or_buf: Union[str, os.PathLike, TextIO], weighted: bool = False) -> None:
    """Write a graph as 1-indexed general coordinate MTX (the reference's
    ``writeGraph``)."""
    g = g.host()
    src, dst = edge_list(g)
    field = "real" if weighted else "pattern"
    buf = io.StringIO()
    buf.write(f"%%MatrixMarket matrix coordinate {field} general\n")
    buf.write(f"{g.n} {g.n} {g.m}\n")
    if weighted:
        w = np.asarray(g.weights[: g.m]) if g.weights is not None else np.ones(g.m, np.float32)
        for u, v, x in zip(src + 1, dst + 1, w):
            buf.write(f"{u} {v} {x:g}\n")
    else:
        np.savetxt(buf, np.stack([src + 1, dst + 1], axis=1), fmt="%d")
    data = buf.getvalue()
    if hasattr(path_or_buf, "write"):
        path_or_buf.write(data)
    else:
        with open(path_or_buf, "w") as f:
            f.write(data)
