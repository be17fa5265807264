"""Predictor model zoo: the heuristic metrics (IHub/LHub) and the
GraphSAGE family (the learned and hybrid predictors)."""
from .heuristic import HeuristicPredictor, IHub, LHub, all_models
from .gnn import (
    GNNPredictor,
    HybridPredictor,
    sage_encode,
    sage_encode_sampled,
    sage_init,
    sample_neighbors,
    sddmm_scores,
    train_sage,
)

__all__ = [
    "HeuristicPredictor", "IHub", "LHub", "all_models",
    "GNNPredictor", "HybridPredictor",
    "sage_init", "sage_encode", "sage_encode_sampled", "sample_neighbors",
    "sddmm_scores", "train_sage",
]
