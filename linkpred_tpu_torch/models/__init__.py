"""Predictor model zoo: the heuristic metrics (IHub/LHub)."""
from .heuristic import HeuristicPredictor, IHub, LHub, all_models

__all__ = ["HeuristicPredictor", "IHub", "LHub", "all_models"]
