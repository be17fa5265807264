"""Graph transforms, batch updates, traversal, graph properties, segmented
scans, top-k, and the two kernels' modules (``fused_tail``, ``compact``).
Importing it touches no device."""
from .transform import (
    add_self_loops, count_self_loops, duplicate, duplicate_if,
    remove_self_loops, symmetrize, transpose)
from .batch import (
    apply_batch, generate_edge_deletions, generate_edge_insertions, tidy_batch)
from .traverse import bfs_levels, bfs_visited, dfs_order, dfs_visited
from .properties import (
    communities, communities_disconnected, community_size, community_vertices,
    degrees, edge_weight, modularity, modularity_by, vertex_keys)

__all__ = [
    "symmetrize", "remove_self_loops", "add_self_loops", "count_self_loops",
    "transpose", "duplicate", "duplicate_if",
    "generate_edge_deletions", "generate_edge_insertions", "tidy_batch",
    "apply_batch",
    "bfs_levels", "bfs_visited", "dfs_order", "dfs_visited",
    "vertex_keys", "degrees", "edge_weight", "modularity", "modularity_by",
    "communities", "community_size", "community_vertices",
    "communities_disconnected",
]
