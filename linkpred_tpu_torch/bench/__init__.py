"""Synthetic graphs, the experiment harness, the log post-processor, the
bench row (``run``), the sweep runner and the reference suite's manifest."""
from .harness import ALL_DEGREES, ExperimentConfig, run_batches, run_experiment
from .synth import rmat_graph

__all__ = ["ALL_DEGREES", "ExperimentConfig", "run_batches", "run_experiment",
           "rmat_graph"]
