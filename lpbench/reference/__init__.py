"""The plain reference the benchmark judges the program against: torch
operations only, nothing of the program."""
from .linkpred import (METRICS, WEIGHTED, candidate_blocks, served_topk,
                       source_candidates, top_per_source, whole_graph_topks)

__all__ = ["METRICS", "WEIGHTED", "candidate_blocks", "whole_graph_topks",
           "source_candidates", "top_per_source", "served_topk"]
