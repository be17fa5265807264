"""State carried across from the reference package.

The heuristic engine has no weights: its state is the graph and the tile
plan.  These helpers turn the reference's ``CSRGraph`` and ``TilePlan``
arrays, handed over as NumPy (for instance ``dataclasses.asdict`` of a
reference plan), into the port's types, without importing the reference.
Pushing the reference's own plan through the port's scorer isolates the
device engine from the port's planner.  The GraphSAGE model's parameters,
the one learned state of the reference, cross by
:func:`sage_params_from_jax`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .graph import CSRGraph
from .predict.plan import TilePlan

__all__ = ["graph_from_arrays", "plan_from_fields", "sage_params_from_jax"]

_PLAN_FIELDS = {f.name for f in dataclasses.fields(TilePlan)} - {"_device"}


def graph_from_arrays(offsets, indices, degrees, n: int,
                      m: int) -> CSRGraph:
    """A port graph (unweighted) from the reference graph's CSR arrays."""
    return CSRGraph(offsets=np.asarray(offsets), indices=np.asarray(indices),
                    degrees=np.asarray(degrees), weights=None, n=int(n),
                    m=int(m))


def plan_from_fields(**fields) -> TilePlan:
    """A port plan from the reference plan's fields (arrays as NumPy,
    sub-plans as nested field dicts).  Fields the port's plan does not hold
    (the reference's device-copy memo) are ignored."""
    kw = {}
    for name, value in fields.items():
        if name not in _PLAN_FIELDS:
            continue
        if name in ("huge_plan", "side_plan"):
            if isinstance(value, dict):
                value = plan_from_fields(**value)
        elif value is not None and not np.isscalar(value) \
                and not isinstance(value, (int, bool)):
            value = np.asarray(value)
        kw[name] = value
    return TilePlan(**kw)


def sage_params_from_jax(params, device="cuda"):
    """The port's ``SageModel`` on ``device`` from the reference's
    GraphSAGE parameters ``{"l1": {"w", "b"}, "l2": {"w", "b"}}`` (arrays
    as NumPy): the layout is the same, so each array is copied as it is,
    in float32."""
    import torch

    from .models.gnn import SageLayer, SageModel
    from .utils.device import resolve_device

    device = resolve_device(device)

    def layer(p):
        return SageLayer(*(torch.tensor(np.asarray(p[name], np.float32),
                                        device=device)
                           for name in ("w", "b")))

    return SageModel(layer(params["l1"]), layer(params["l2"]))
