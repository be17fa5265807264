"""The nine neighbourhood-similarity metrics (counterpart of
``linkpred_tpu/predict/metrics.py``).

A leaf module (numpy and torch only), so ``ops/`` imports it without a cycle.
Each metric is a score of (|N(u) ∩ N(v)|, deg(u), deg(v)); Adamic–Adar and
Resource Allocation instead sum a per-intermediate weight (``1/log(deg(mid))``,
``1/deg(mid)``) and return the sum.  ``xp=torch`` computes in float32 on
tensors (the device paths); ``xp=np`` in float64 (the oracle).  The CUDA
fused tail (``kernels/csrc/fused_tail.cu``) states the same formulas again
and must stay equal to these.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["METRICS", "MetricSpec", "TECHNIQUE_NAMES", "get_metric",
           "maxf2_mask"]


def maxf2_mask(du, dw, maxf2):
    """The reference's MAXFACTOR2 validity predicate as written: it compares
    deg(u) with maxf2*deg(u), a self-compare kept verbatim for parity."""
    return (du <= maxf2 * du) & (dw <= maxf2 * du)


class MetricSpec(NamedTuple):
    name: str
    needs_weight: bool  # True => sum mid-vertex weights (AA, RA)

    def weight_from_degree(self, deg, xp=torch):
        """Per-intermediate weight from deg(mid); 0 where deg(mid) <= 1
        (AA) or <= 0 (RA), so no inf or nan is produced."""
        if xp is torch:
            d = deg.to(torch.float32)
            if self.name == "adamic_adar":
                return torch.where(d > 1, 1.0 / torch.log(d.clamp(min=2.0)),
                                   0.0)
            if self.name == "resource_allocation":
                return torch.where(d > 0, 1.0 / d.clamp(min=1.0), 0.0)
        else:
            d = np.asarray(deg, dtype=np.float64)
            if self.name == "adamic_adar":
                return np.where(d > 1, 1.0 / np.log(np.maximum(d, 2.0)), 0.0)
            if self.name == "resource_allocation":
                return np.where(d > 0, 1.0 / np.maximum(d, 1.0), 0.0)
        raise AssertionError(self.name)

    def score(self, cnt, acc, deg_u, deg_v, xp=torch):
        """Similarity score from the common-neighbour count ``cnt`` and, for
        AA/RA, the summed weight ``acc``."""
        if xp is torch:
            nuv = cnt.to(torch.float32)
            du = deg_u.to(torch.float32)
            dv = deg_v.to(torch.float32)
        else:
            nuv = np.asarray(cnt, dtype=np.float64)
            du = np.asarray(deg_u, dtype=np.float64)
            dv = np.asarray(deg_v, dtype=np.float64)
        n = self.name
        if n == "common_neighbors":
            return nuv
        if n == "jaccard_coefficient":
            return nuv / (du + dv - nuv)
        if n == "sorensen_index":
            return nuv / (du + dv)
        if n == "salton_cosine_similarity":
            if xp is torch:
                # correctly rounded float32 sqrt on every device (CPU torch's
                # vectorized sqrt is not, for ~0.5% of inputs): the float64
                # root rounded to float32 is exact, as 53 >= 2*24 + 2, and
                # equals the CUDA kernel's __fsqrt_rn
                return nuv / torch.sqrt((du * dv).double()).float()
            return nuv / np.sqrt(du * dv)
        if n == "hub_promoted":
            return nuv / xp.minimum(du, dv)
        if n == "hub_depressed":
            return nuv / xp.maximum(du, dv)
        if n == "leicht_holme_nerman":
            return nuv / (du * dv)
        if n in ("adamic_adar", "resource_allocation"):
            return acc
        raise AssertionError(n)


# Order fixes each metric's code in the CUDA fused tail.
METRICS = {
    s.name: s
    for s in [
        MetricSpec("common_neighbors", False),
        MetricSpec("jaccard_coefficient", False),
        MetricSpec("sorensen_index", False),
        MetricSpec("salton_cosine_similarity", False),
        MetricSpec("hub_promoted", False),
        MetricSpec("hub_depressed", False),
        MetricSpec("leicht_holme_nerman", False),
        MetricSpec("adamic_adar", True),
        MetricSpec("resource_allocation", True),
    ]
}

# Technique-name stems of the result-log lines: the reference's labels,
# derived from its function names; the harness appends the backend tag and
# the hub threshold.
TECHNIQUE_NAMES = {
    "common_neighbors": "predictLinksCommonNeighbors",
    "jaccard_coefficient": "predictLinksJaccardCoefficient",
    "sorensen_index": "predictLinksSorensenIndex",
    "salton_cosine_similarity": "predictLinksSaltonCosineSimilarity",
    "hub_promoted": "predictLinksHubPromoted",
    "hub_depressed": "predictLinksHubDepressed",
    "leicht_holme_nerman": "predictLinksLeichtHolmeNermanScore",
    "adamic_adar": "predictLinksAdamicAdarCoefficient",
    "resource_allocation": "predictLinksResourceAllocationScore",
}


def get_metric(name: str) -> MetricSpec:
    key = name.lower()
    aliases = {
        "cn": "common_neighbors",
        "jaccard": "jaccard_coefficient",
        "sorensen": "sorensen_index",
        "salton": "salton_cosine_similarity",
        "cosine": "salton_cosine_similarity",
        "hpi": "hub_promoted",
        "hdi": "hub_depressed",
        "lhn": "leicht_holme_nerman",
        "aa": "adamic_adar",
        "ra": "resource_allocation",
    }
    key = aliases.get(key, key)
    if key not in METRICS:
        raise KeyError(f"unknown metric {name!r}; one of {sorted(METRICS)}")
    return METRICS[key]
