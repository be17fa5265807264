"""What every design probe of this package shares: its command line, its
device, its JSON lines, its clock and its checks.

A probe's sizes are flags named after the JAX probe's environment variables
(``BENCH_SCALE`` is ``--bench-scale``); where the JAX probe reads the
variable, the flag's default is read from it too, else the JAX probe's
constant.  ``--device`` defaults to the card; without one, resolving it
raises.  A probe prints one JSON object a line: first the card's name and
power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them (``null`` on the CPU), then its rows.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import tempfile

import numpy as np
import torch

from ..parallel.sim import same_result
from ..utils.timing import measure_duration

__all__ = ["parser", "card_line", "Rows", "ms",
           "profiled",
           "cache_dir", "bench_graph", "tile_fn_of", "passes", "pass_runner",
           "host_rows", "plan_result", "same_result", "top_result",
           "same_keys", "JACCARD"]

# The metric of every graph probe (the bench's).
JACCARD = "jaccard_coefficient"


def parser(doc: str, sizes: dict, graph: bool = False
           ) -> argparse.ArgumentParser:
    """``--device`` (default ``cuda``) and one flag a size.  ``sizes`` maps
    an environment name to ``(default, type, read_env)``: the flag's
    default is the environment's value where ``read_env``, else
    ``default``.  ``graph`` adds ``--cache-dir`` (:func:`cache_dir`)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                    "versions)")
    if graph:
        ap.add_argument("--cache-dir", default=None,
                        help="the bench graph cache (BENCH_CACHE_DIR)")
    for name, (default, typ, read_env) in sizes.items():
        if read_env and name in os.environ:
            default = typ(os.environ[name])
        # LANES_LOG2 is --lanes-log2
        ap.add_argument("--" + name.lower().replace("_", "-"), type=typ,
                        default=default, dest=name.lower())
    return ap


def card_line(device):
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


class Rows:
    """A probe's JSON lines: the header (the card) at creation, then one
    line a row; ``rows`` keeps them all, the header first."""

    def __init__(self, probe: str, device, **header) -> None:
        self.probe = probe
        self.rows: list = []
        self.emit(card=card_line(device), device=str(device), **header)

    def emit(self, **row) -> dict:
        row = {"probe": self.probe, **row}
        print(json.dumps(row), flush=True)
        self.rows.append(row)
        return row


def ms(fn, device, repeat: int = 3) -> float:
    """Mean milliseconds of ``fn`` over ``repeat`` calls after one untimed
    call: CUDA events on the card, the host clock on the CPU."""
    return measure_duration(fn, repeat, device=device)[0]


def profiled(fn, *args, top: int = 30, tries: int = 3, **kwargs):
    """``utils.profiling.profile_fn``: ``(result, per-op table)``.  A
    profiler session that recorded no device event (seen on the card)
    raises there; a fresh session is tried, and after ``tries`` such
    sessions the error stands."""
    from ..utils.profiling import profile_fn

    for attempt in range(tries):
        try:
            return profile_fn(fn, *args, top=top, **kwargs)
        except RuntimeError as e:
            if "no device event" not in str(e) or attempt == tries - 1:
                raise


def cache_dir(path=None) -> str:
    """The bench graph cache: ``path``, else ``BENCH_CACHE_DIR``, else
    ``linkpred_bench_cache`` in the temporary directory (``bench.run``'s
    rule)."""
    return path or os.environ.get(
        "BENCH_CACHE_DIR",
        os.path.join(tempfile.gettempdir(), "linkpred_bench_cache"))


def bench_graph(scale: int, path=None, removal: bool = True):
    """R-MAT-``scale`` at the bench protocol through ``bench.run``'s cache:
    (the graph after the 0.1|E| removal, the tidied deletions); with
    ``removal=False`` the generator's graph itself and no deletions."""
    if not removal:
        from ..bench.synth import rmat_graph

        return rmat_graph(scale, edge_factor=16, seed=42), None
    from ..bench.run import bench_graph as cached

    return cached(scale, cache_dir(path))


def tile_fn_of(y, p, device, metric_names=(JACCARD,)):
    """The tile scorer of pass ``p`` of graph ``y`` on ``device``, as
    ``predict_links`` builds it (an edge plan also uploads the CSR)."""
    from ..predict import api, scoring

    indices = degrees = None
    if not p.packed:
        indices, degrees = api._upload_csr(y, device)
    return scoring.tile_scorer(p.device_stream(device),
                               metric_names=metric_names, n=y.n,
                               indices=indices, degrees=degrees,
                               **api._pass_kwargs(p))


def passes(plan):
    """``[(label, pass)]``: the main plan, then its sub-plans in
    ``predict_links``'s order, each labelled by its path (``side``,
    ``huge``, ``huge.side``)."""
    out = [("main", plan)]

    def walk(p, prefix):
        for name, q in (("side", p.side_plan), ("huge", p.huge_plan)):
            if q is not None:
                out.append((prefix + name, q))
                walk(q, prefix + name + ".")

    walk(plan, "")
    return out


def pass_runner(y, p, k: int, device):
    """A thunk that scores pass ``p`` of ``y`` alone, Jaccard, as
    ``predict_links`` runs it (``scoring.score_tiles``, the top ``k``);
    it returns the pass's ``TopK``."""
    from ..predict import api, scoring

    indices = degrees = None
    if not p.packed:
        indices, degrees = api._upload_csr(y, device)
    stream = p.device_stream(device)
    kw = dict(metric_names=(JACCARD,), k=k, device=device, n=y.n, maxf2=0,
              indices=indices, degrees=degrees, **api._pass_kwargs(p))
    return lambda: scoring.score_tiles(stream, p.tile_start, 0.0, **kw)


def host_rows(y, plan, k: int, min_degree1: int):
    """The mega-hub sources of ``plan`` scored on the host, Jaccard, as
    ``predict_links`` scores them: ``(scores, u, v)``."""
    from ..predict.metrics import METRICS
    from ..predict.scoring import score_huge_sources_host_multi

    return score_huge_sources_host_multi(
        y, plan.host_src, (METRICS[JACCARD],), min_degree1, 0, 0.0,
        k=k, upper_only=plan.upper_only)[JACCARD]


def plan_result(y, plan, k: int, device, min_degree1: int, main_top=None):
    """The top ``k`` of every pass of ``plan`` and its host-scored hubs,
    merged as ``predict_links`` merges them; ``main_top`` (a ``TopK``)
    stands for the main pass where given."""
    parts = []
    for label, p in passes(plan):
        top = main_top if label == "main" and main_top is not None \
            else pass_runner(y, p, k, device)()
        parts.append((top.scores[0], top.u[0], top.v[0]))
    if plan.host_src.size:
        parts.append(host_rows(y, plan, k, min_degree1))
    return top_result(parts, k)


def top_result(parts, k: int):
    """The top ``k`` of ``parts``, a list of ``(scores, u, v)`` (tensors or
    arrays), as ``predict_links`` orders them: finite scores, descending,
    stable.  Returns a ``PredictResult`` with zero times."""
    from ..predict.api import PredictResult

    parts = [tuple(np.asarray(a.cpu() if torch.is_tensor(a) else a)
                   .reshape(-1) for a in p) for p in parts]
    scores, us, vs = (np.concatenate(x) for x in zip(*parts))
    ok = np.isfinite(scores)
    scores, us, vs = scores[ok], us[ok], vs[ok]
    order = np.argsort(-scores, kind="stable")[:k]
    return PredictResult(u=us[order].astype(np.int32),
                         v=vs[order].astype(np.int32),
                         score=scores[order].astype(np.float32),
                         time_ms=0.0, scoring_ms=0.0)


def same_keys(key, arms: dict, kk: int, where: str):
    """Hold selection arms equal over the int32 ``key`` they selected
    from: each arm's ``(keys, lanes)`` has ``kk`` entries, its keys are
    ``key[lanes]``, sorted, the same multiset in every arm, and the lanes
    with a key below the kk-th key the same set (lanes may differ only
    within the ties at the kk-th key).  Returns the kk-th key."""
    key = key.cpu()
    first = None
    for name, (keys, lanes) in arms.items():
        keys, lanes = keys.cpu().to(torch.int64), lanes.cpu().to(torch.int64)
        if keys.shape[0] != kk or lanes.shape[0] != kk:
            raise AssertionError(f"{where}: arm {name} selected "
                                 f"{keys.shape[0]} lanes, want {kk}")
        if not torch.equal(key[lanes].to(torch.int64), keys):
            raise AssertionError(f"{where}: arm {name}'s keys are not its "
                                 "lanes' keys")
        if not bool((keys[1:] >= keys[:-1]).all()):
            raise AssertionError(f"{where}: arm {name}'s keys not sorted")
        strict = set(lanes[keys < keys[-1]].tolist())
        if first is None:
            first = (name, keys, strict)
            continue
        if not torch.equal(keys, first[1]):
            raise AssertionError(f"{where}: arms {name} and {first[0]} "
                                 "select other keys")
        if strict != first[2]:
            raise AssertionError(f"{where}: arms {name} and {first[0]} "
                                 "select other lanes above the kk-th key")
    return int(first[1][-1])
