"""Heuristic link-prediction models (counterpart of
``linkpred_tpu/models/heuristic.py``): the model-zoo face of the metric
engine.

The reference exposes its predictors as free functions, one per metric;
here each (metric, hub threshold) pair is a ``HeuristicPredictor`` with one
``predict(graph)`` interface, so sweeps and serving code compose over one
API.  A predictor scores on its ``device``: the CUDA card unless the caller
names the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..graph import CSRGraph
from ..predict.api import PlanCache, PredictOptions, PredictResult, predict_links
from ..predict.metrics import METRICS, TECHNIQUE_NAMES, get_metric

__all__ = ["HeuristicPredictor", "IHub", "LHub", "all_models"]


@dataclasses.dataclass
class HeuristicPredictor:
    """One similarity metric with an optional LHub hub threshold.

    ``min_degree1 = 0`` is IHub (scan all intermediates); > 0 is LHub.
    ``device`` is passed to ``predict_links``, as
    ``ExperimentConfig.device`` is.
    """
    metric: str = "jaccard_coefficient"
    min_degree1: int = 4
    max_factor2: int = 0
    cap: int = 1 << 20
    plan_cache: Optional[PlanCache] = None
    device: str = "cuda"

    def __post_init__(self) -> None:
        self.metric = get_metric(self.metric).name

    @property
    def name(self) -> str:
        # the implementation's tag, as the experiment harness's rows carry it
        return f"{TECHNIQUE_NAMES[self.metric]}Cuda{self.min_degree1}"

    def predict(self, g: CSRGraph, max_edges: Optional[int] = None,
                min_score: float = 0.0, repeat: int = 1,
                mesh=None, sources=None) -> PredictResult:
        return predict_links(
            g, metric=self.metric, min_degree1=self.min_degree1,
            max_factor2=self.max_factor2,
            options=PredictOptions(repeat=repeat, max_edges=max_edges,
                                   min_score=min_score),
            cap=self.cap, plan_cache=self.plan_cache, mesh=mesh,
            sources=sources, device=self.device,
        )


def IHub(metric: str = "jaccard_coefficient", **kw) -> HeuristicPredictor:
    """Improved-baseline predictor: score all second-order pairs."""
    return HeuristicPredictor(metric=metric, min_degree1=0, **kw)


def LHub(metric: str = "jaccard_coefficient", min_degree1: int = 64,
         **kw) -> HeuristicPredictor:
    """Hub-skipping predictor: skip intermediates of degree > min_degree1."""
    return HeuristicPredictor(metric=metric, min_degree1=min_degree1, **kw)


def all_models(degrees=(0, 4, 64), plan_cache: Optional[PlanCache] = None,
               device: str = "cuda"):
    """The full 9-metric x threshold zoo, on ``device``."""
    cache = plan_cache or PlanCache()
    return [
        HeuristicPredictor(metric=m, min_degree1=d, plan_cache=cache,
                           device=device)
        for m in METRICS for d in degrees
    ]
