"""Multi-process simulation on one host for the PyTorch port: N coordinated
rank processes (the port of ``examples/multihost_sim/run.py``).

Each process is one rank: it joins the ``torch.distributed`` process group
(``parallel.distributed.init_distributed``), builds the same graph + plan,
and runs the stream-sharded scoring, each rank uploading only its block.
Process 0 re-runs the single-process pass and checks that the sharded
result reproduces it exactly (the score multiset, and the pairs up to ties
at the k-th score).

The ranks meet through a ``file://`` store in a fresh temporary directory,
so runs side by side cannot collide on a port; each rank has a deadline,
and the launcher stops every rank and exits non-zero as soon as one fails.
On one card the ranks take gloo (NCCL refuses two ranks on one device).

Launch:  python examples/multihost_sim/run_torch.py [nprocs] [--device cpu]
             [--timeout SECONDS]         (default 2 ranks on the CUDA card)
Rank:    (started by the launcher with --rank, --world and --init-method)
"""
import argparse
import datetime
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", ".."))


def worker(rank: int, nprocs: int, init_method: str, device: str,
           timeout: float) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from linkpred_tpu_torch import PredictOptions, from_edges, predict_links
    from linkpred_tpu_torch.ops.transform import remove_self_loops, symmetrize
    from linkpred_tpu_torch.parallel.distributed import (
        default_backend, init_distributed, make_global_mesh, process_info)
    from linkpred_tpu_torch.parallel.sim import same_result

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // nprocs))
    init_distributed(init_method, nprocs, rank,
                     backend=default_backend(nprocs, device),
                     timeout=datetime.timedelta(seconds=timeout))
    try:
        pid, pcount = process_info()
        if pcount != nprocs:
            raise AssertionError((pid, pcount))

        rng = np.random.default_rng(7)
        n, m = 300, 1800
        g = remove_self_loops(symmetrize(from_edges(
            rng.integers(0, n, m), rng.integers(0, n, m), n=n)))

        mesh = make_global_mesh(device="cpu" if device == "cpu" else None)
        opts = PredictOptions(max_edges=200)
        res = predict_links(g, metric="jaccard_coefficient", min_degree1=8,
                            options=opts, cap=2048, mesh=mesh)
        if pid == 0:
            ref = predict_links(g, metric="jaccard_coefficient",
                                min_degree1=8, options=opts, cap=2048,
                                device=mesh.device)
            if not len(res) == len(ref) > 0:
                raise AssertionError((len(res), len(ref)))
            same_result(res, ref, "multihost_sim")
            print(f"multihost_sim OK: {pcount} processes on {mesh.device} "
                  f"({mesh.backend}), {len(res)} predictions, sharded == "
                  "single-process", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("nprocs", nargs="?", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        worker(args.rank, args.world, args.init_method, args.device,
               args.timeout)
        return 0
    from linkpred_tpu_torch.parallel.sim import launch
    from linkpred_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)      # raises here without a card
    return launch(args.nprocs, ["--device", args.device,
                                "--timeout", str(args.timeout)],
                  args.timeout, command=[sys.executable,
                                         os.path.abspath(__file__)])


if __name__ == "__main__":
    sys.exit(main())
