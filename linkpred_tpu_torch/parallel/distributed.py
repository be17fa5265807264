"""Process-group wiring: ``torch.distributed`` behind the mesh API
(counterpart of ``linkpred_tpu/parallel/distributed.py``).

The model: one process per rank, :func:`init_distributed` once at start-up,
then :func:`make_global_mesh`, a 1-D mesh over every rank.  The layers
above are rank-count agnostic: each rank builds and uploads only its block
of the stream (``mesh.shard_stream``), the merge is one all-gather of
``[M, k]`` buffers, and every rank computes the same result.

``python -m linkpred_tpu_torch.parallel.sim N`` starts N coordinated rank
processes on one host and holds the sharded result against the
single-process pass.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["init_distributed", "default_backend", "make_global_mesh",
           "process_info"]

DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def default_backend(world_size: int, device_type: Optional[str] = None) -> str:
    """``nccl`` when each rank of this host owns a card, else ``gloo`` (on
    the CPU, or when ranks share one card: NCCL refuses two ranks on one
    device).  Decided from what the host has, never by trying one and
    falling back.  ``device_type="cpu"`` names the CPU."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if (device_type != "cpu" and torch.cuda.is_available()
            and torch.cuda.device_count() >= local):
        return "nccl"
    return "gloo"


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Initialize the process group (once, before any collective).

    With no arguments it reads ``torchrun``'s ``RANK``/``WORLD_SIZE`` (and
    ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``), and initializes
    only when ``WORLD_SIZE > 1``: no ``WORLD_SIZE``, or ``WORLD_SIZE=1``,
    is a single process.  ``backend`` defaults to
    :func:`default_backend`.  A signalled init that fails RAISES: going on
    as independent single processes would break the total/D memory
    contract and give D copies of the answer with no error.  Every wait
    is bounded by ``timeout``."""
    if init_method is None and world_size is None:
        env = os.environ.get("WORLD_SIZE")
        if env is None or int(env) <= 1:
            return
        init_method, world_size = "env://", int(env)
        rank = int(os.environ["RANK"]) if rank is None else rank
    if world_size is None or rank is None:
        raise ValueError("init_distributed: give world_size and rank with "
                         "init_method")
    dist.init_process_group(backend or default_backend(world_size),
                            init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timeout)


def make_global_mesh(axis: str = "workers", device=None):
    """A 1-D mesh over every rank of the process group (see
    ``mesh.make_mesh`` for ``device``)."""
    from .mesh import make_mesh

    return make_mesh(axis=axis, device=device)


def process_info() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
