"""Multi-device scaling over ``torch.distributed`` (counterpart of
``linkpred_tpu/parallel``)."""
from .mesh import Mesh, make_mesh, pad_tiles_for_mesh, score_tiles_sharded

__all__ = ["Mesh", "make_mesh", "pad_tiles_for_mesh", "score_tiles_sharded"]
