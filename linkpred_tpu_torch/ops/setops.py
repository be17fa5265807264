"""Set operations on sorted key arrays (counterpart of
``linkpred_tpu/ops/setops.py``): host NumPy, one sort or mask pass each,
with the reference's last-wins rule on duplicate keys."""
from __future__ import annotations

import numpy as np

__all__ = ["set_union_last", "set_difference", "set_intersection",
           "unique_last", "non_adjacent_find"]


def _as1d(x):
    return np.asarray(x).reshape(-1)


def unique_last(keys, values=None):
    """Sorted ``keys`` without duplicates, each keeping its LAST
    occurrence's value."""
    keys = _as1d(keys)
    if keys.size == 0:
        return (keys, values) if values is not None else keys
    last = np.empty(keys.shape[0], dtype=bool)
    last[:-1] = keys[1:] != keys[:-1]
    last[-1] = True
    if values is not None:
        return keys[last], _as1d(values)[last]
    return keys[last]


def set_union_last(a_keys, b_keys, a_values=None, b_values=None):
    """Union of two sorted key sets; on a shared key the second set's value
    wins."""
    a_keys, b_keys = _as1d(a_keys), _as1d(b_keys)
    keys = np.concatenate([a_keys, b_keys])
    order = np.argsort(keys, kind="stable")   # b after a on equal keys
    if a_values is None:
        return np.unique(keys[order])
    values = np.concatenate([_as1d(a_values), _as1d(b_values)])
    return unique_last(keys[order], values[order])


def set_difference(a_keys, b_keys, a_values=None):
    """Sorted ``a`` without the keys of ``b`` (and their values)."""
    a_keys, b_keys = _as1d(a_keys), _as1d(b_keys)
    keep = ~np.isin(a_keys, b_keys)
    if a_values is not None:
        return a_keys[keep], _as1d(a_values)[keep]
    return a_keys[keep]


def set_intersection(a_keys, b_keys):
    """Keys common to both sets, sorted."""
    return np.intersect1d(_as1d(a_keys), _as1d(b_keys), assume_unique=False)


def non_adjacent_find(x, equal=None):
    """Index of the first adjacent pair that is not equal under ``equal``
    (default ``==``), or ``len(x)`` if there is none."""
    x = _as1d(x)
    if x.size < 2:
        return x.size
    if equal is None:
        neq = x[1:] != x[:-1]
    else:
        neq = ~np.fromiter(
            (equal(x[i], x[i + 1]) for i in range(x.size - 1)),
            dtype=bool, count=x.size - 1)
    hits = np.nonzero(neq)[0]
    return int(hits[0]) if hits.size else int(x.size)
