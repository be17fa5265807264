"""On the card: the generator and the reference agree with themselves
across devices' kinds of work (run there with ``python -m pytest
lpbench/tests -m cuda``)."""
import pytest
import torch

from lpbench import graph500
from lpbench.reference import whole_graph_topks


@pytest.mark.cuda
def test_the_card_makes_a_sound_graph_and_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = dict(scale=10, edge_factor=16, a=0.57, b=0.19, c=0.19,
               removed_fraction=0.1)
    g, k = graph500.make_graph(cfg, 2 ** 31 + 9, "cuda")
    h, kh = graph500.make_graph(cfg, 2 ** 31 + 9, "cuda")
    assert k == kh and torch.equal(g.indices, h.indices)
    keys = g.keys()
    u, v = keys // g.n, keys % g.n
    assert torch.equal(torch.sort(v * g.n + u).values, keys)
    host = graph500.Graph(g.offsets.cpu(), g.indices.cpu(), g.n)
    a = whole_graph_topks(g, ["jaccard_coefficient"], 0, k)[
        "jaccard_coefficient"]
    b = whole_graph_topks(host, ["jaccard_coefficient"], 0, k)[
        "jaccard_coefficient"]
    assert torch.equal(a[2].cpu(), b[2])
