"""linkpred_tpu_torch — the PyTorch/CUDA port of linkpred_tpu.

Neighbourhood link prediction (IHub/LHub, nine similarity metrics) on an
NVIDIA H100, held against the JAX package ``linkpred_tpu``, which stays the
reference.  It imports torch and numpy, never jax.

Layout (module paths mirror the reference's):
  graph      — CSR graph (NumPy leaves; ``to(device)`` for tensors) and
               its builder
  convert    — the reference's graph/plan arrays into the port's types
  cli        — the experiment driver (``python -m linkpred_tpu_torch``)
  io         — the MTX reader and writer, npz graph files, and the ctypes
               loader of the native C++ helpers (MTX body parser, plan
               helpers)
  ops        — transforms, batch updates, BFS/DFS, graph properties, set
               operations, scans and vector helpers, segmented scans, top-k,
               and the modules of the two CUDA kernels (fused_tail, compact)
  kernels    — the CUDA C++ sources (``csrc/``) and their nvcc builder
  predict    — metrics, host plan, scoring engine, public API
  models     — the heuristic model zoo (IHub/LHub predictors) and the
               GraphSAGE family (encoder, SDDMM decoder, training, the GNN
               and hybrid predictors)
  parallel   — the sharded pass over torch.distributed (mesh, process
               group, ``python -m linkpred_tpu_torch.parallel.sim N``)
  bench      — synthetic graphs, the experiment harness, the log → CSV
               post-processor, the bench row (``python -m
               linkpred_tpu_torch.bench.run``), the sweep runner and the
               reference suite's manifest
  utils      — device memory budgets, timing, the reference's log grammar,
               build modes and assertions, xorshift32, prime helpers, the
               memory roofline, the profiler helper
"""

from .graph import (CSRGraph, GraphBuilder, edge_list, from_dense,
                    from_edges, to_dense)
from .io.mtx import read_mtx, read_mtx_header, write_mtx
from .predict.api import (PlanCache, PredictOptions, PredictResult,
                          predict_links, predict_links_multi, top_per_source)
from .predict.metrics import METRICS, get_metric

__all__ = [
    "CSRGraph", "GraphBuilder", "from_edges", "from_dense", "to_dense",
    "edge_list",
    "PredictOptions", "PredictResult", "predict_links", "predict_links_multi",
    "top_per_source", "PlanCache",
    "METRICS", "get_metric",
    "read_mtx", "read_mtx_header", "write_mtx",
]
