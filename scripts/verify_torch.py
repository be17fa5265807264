"""End-to-end oracle drive of the PyTorch port on the card (the port of
``scripts/verify_tpu.py``).

The unit tests run the port on the CPU; this script is the
verify-on-hardware companion: dense-oracle-exact jaccard + adamic_adar
(the float32 log of the degree weights) on a 200-vertex ER graph.  It
prints the device it ran on and exits non-zero on any mismatch.

    python scripts/verify_torch.py                 # the CUDA card
    python scripts/verify_torch.py --device cpu    # the kernels' plain versions
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import linkpred_tpu_torch as lp  # noqa: E402
from linkpred_tpu_torch.utils.device import resolve_device  # noqa: E402


def check(cond, msg) -> None:
    if not cond:
        raise AssertionError(msg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    device = resolve_device(ap.parse_args(argv).device)
    import torch

    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "CPU, plain kernels")
    print(f"device: {device} ({name})")

    rng = np.random.default_rng(7)
    n = 200
    A = rng.random((n, n)) < 0.08
    A = np.triu(A, 1)
    A = A | A.T
    src, dst = np.nonzero(A)
    g = lp.from_edges(src, dst)
    deg = A.sum(1)

    res = lp.predict_links(g, metric="jaccard_coefficient", min_degree1=0,
                           options=lp.PredictOptions(max_edges=500),
                           device=device)
    CN = A.astype(np.int64) @ A.astype(np.int64)
    want = {}
    for u in range(n):
        for v in range(u + 1, n):
            if A[u, v]:
                continue
            c = CN[u, v]
            if c <= 0:
                continue
            want[(u, v)] = c / (deg[u] + deg[v] - c)
    check(len(res) > 0, "jaccard: no rows")
    for u, v, s in zip(res.u, res.v, res.score):
        key = (min(int(u), int(v)), max(int(u), int(v)))
        check(key in want and np.isclose(s, want[key], rtol=1e-5), (key, s))
    top = sorted(want.values(), reverse=True)[:len(res)]
    check(np.allclose(sorted(res.score.tolist(), reverse=True), top,
                      rtol=1e-5), "jaccard: not the oracle's top scores")
    print(f"OK: jaccard {len(res)} rows oracle-exact on this device; "
          f"top {res.score[0]:.4f}")

    res2 = lp.predict_links(g, metric="adamic_adar", min_degree1=0,
                            options=lp.PredictOptions(max_edges=500),
                            device=device)
    wantAA = {}
    for u in range(n):
        for v in range(u + 1, n):
            if A[u, v]:
                continue
            mids = np.nonzero(A[u] & A[v])[0]
            mids = mids[deg[mids] > 1]
            if mids.size == 0:
                continue
            s = float(np.sum(1.0 / np.log(deg[mids].astype(np.float64))))
            if s > 0:
                wantAA[(u, v)] = s
    check(len(res2) > 0, "adamic_adar: no rows")
    for u, v, s in zip(res2.u, res2.v, res2.score):
        key = (min(int(u), int(v)), max(int(u), int(v)))
        check(key in wantAA and np.isclose(s, wantAA[key], rtol=1e-5),
              (key, s, wantAA.get(key)))
    print(f"OK: adamic_adar {len(res2)} rows oracle-exact on this device")
    return 0


if __name__ == "__main__":
    sys.exit(main())
