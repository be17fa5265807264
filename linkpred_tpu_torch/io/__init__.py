"""The MTX reader and writer, npz graph files, and the loader of the native
host helpers."""
from .mtx import MtxHeader, read_mtx, read_mtx_header, write_mtx
from .npz import load_graph, save_graph

__all__ = ["MtxHeader", "read_mtx", "read_mtx_header", "write_mtx",
           "load_graph", "save_graph"]
