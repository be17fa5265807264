"""Binary graph persistence in NumPy's .npz (counterpart of
``linkpred_tpu/io/npz.py``).

The CSR arrays round-trip exactly, padding included, with the JAX package's
keys and its ``savez_compressed``: a file that either package writes loads
in the other, field for field.
"""
from __future__ import annotations

import os
from typing import Union

import numpy as np

from ..graph import CSRGraph

__all__ = ["save_graph", "load_graph"]


def save_graph(g: CSRGraph, path: Union[str, os.PathLike]) -> None:
    g = g.host()
    payload = dict(
        offsets=np.asarray(g.offsets),
        indices=np.asarray(g.indices),
        degrees=np.asarray(g.degrees),
        n=np.int64(g.n),
        m=np.int64(g.m),
    )
    if g.weights is not None:
        payload["weights"] = np.asarray(g.weights)
    if g.values is not None:
        payload["values"] = np.asarray(g.values)
    np.savez_compressed(path, **payload)


def load_graph(path: Union[str, os.PathLike]) -> CSRGraph:
    with np.load(path) as d:
        return CSRGraph(
            offsets=d["offsets"],
            indices=d["indices"],
            degrees=d["degrees"],
            weights=d["weights"] if "weights" in d.files else None,
            n=int(d["n"]),
            m=int(d["m"]),
            values=d["values"] if "values" in d.files else None,
        )
