"""The plain reference against a dense brute force at n <= 300, every one
of the nine metrics, and the control (the reference in bfloat16 in the
program's place) failing the judge where the program passes, on the
CPU."""
import numpy as np
import pytest
import torch

from lpbench import control, graph500, judge
from lpbench.reference import (METRICS, candidate_blocks, served_topk,
                               source_candidates, whole_graph_topks)

CFG = dict(scale=8, edge_factor=16, a=0.57, b=0.19, c=0.19,
           removed_fraction=0.1)


def _dense(g, metric, d1):
    """``(score [n, n], candidate [n, n])`` by dense algebra, float64."""
    n = g.n
    a = np.zeros((n, n))
    keys = g.keys().numpy()
    a[keys // n, keys % n] = 1.0
    deg = a.sum(1)
    ok = deg > 0
    if d1:
        ok &= deg <= d1
    cnt = (a * ok[None, :]) @ a
    du, dv = deg[:, None], deg[None, :]
    if metric in ("adamic_adar", "resource_allocation"):
        with np.errstate(divide="ignore"):
            wt = 1.0 / (np.log(deg) if metric == "adamic_adar" else deg)
        wt = np.where(ok & (deg > 1), wt, 0.0)
        score = (a * wt[None, :]) @ a
    else:
        with np.errstate(invalid="ignore", divide="ignore"):
            score = {
                "common_neighbors": lambda: cnt,
                "jaccard_coefficient": lambda: cnt / (du + dv - cnt),
                "sorensen_index": lambda: cnt / (du + dv),
                "salton_cosine_similarity": lambda: cnt / np.sqrt(du * dv),
                "hub_promoted": lambda: cnt / np.minimum(du, dv),
                "hub_depressed": lambda: cnt / np.maximum(du, dv),
                "leicht_holme_nerman": lambda: cnt / (du * dv),
            }[metric]()
    cand = (cnt > 0) & (a == 0) & ~np.eye(n, dtype=bool)
    cand &= np.nan_to_num(score) > 0
    return score, cand


@pytest.fixture(scope="module")
def graph():
    return graph500.make_graph(CFG, 11, "cpu")[0]


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d1", [0, 6])
def test_whole_graph_candidates_match_dense(graph, metric, d1):
    score, cand = _dense(graph, metric, d1)
    cand = np.triu(cand, 1)
    keys, got = [], []
    # small blocks: every block boundary must keep a pair's triples together
    for lo, hi, k, s in candidate_blocks(graph, [metric], d1, block=64):
        assert torch.all((k // graph.n >= lo) & (k // graph.n < hi))
        keys.append(k)
        got.append(s[0])
    keys, got = torch.cat(keys).numpy(), torch.cat(got).numpy()
    u, v = np.nonzero(cand)
    np.testing.assert_array_equal(keys, u * graph.n + v)
    np.testing.assert_allclose(got, score[u, v], rtol=1e-12)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [40, 100000])
def test_whole_graph_topk_matches_dense(graph, metric, k):
    score, cand = _dense(graph, metric, 0)
    want = np.sort(score[np.triu(cand, 1)])[::-1][:k]
    u, v, s = whole_graph_topks(graph, [metric], 0, k, block=100)[metric]
    np.testing.assert_allclose(s.numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(score[u.numpy(), v.numpy()], s.numpy(),
                               rtol=1e-12)
    assert np.all(u.numpy() < v.numpy())


@pytest.mark.parametrize("metric", METRICS)
def test_served_matches_dense(graph, metric):
    score, cand = _dense(graph, metric, 0)
    users = torch.tensor([3, 17, 40, 99, 200])
    keys, s = source_candidates(graph, metric, 0, users)
    mask = np.zeros_like(cand)
    mask[users.numpy()] = True
    uu, vv = np.nonzero(cand & mask)
    np.testing.assert_array_equal(keys.numpy(), uu * graph.n + vv)
    np.testing.assert_allclose(s.numpy(), score[uu, vv], rtol=1e-12)
    # the top 12 of the request, then each user's best 2
    u, v, t = served_topk(graph, metric, 0, users, 12, 2)
    top = np.sort(score[uu, vv])[::-1][:12]
    assert np.all(t.numpy() >= top[-1] - 1e-12) and len(t) <= 12
    for x in users.tolist():
        mine = np.sort(score[x][cand[x]])[::-1]
        got = t.numpy()[u.numpy() == x]
        assert len(got) <= 2
        np.testing.assert_allclose(got, mine[: len(got)], rtol=1e-12)


@pytest.mark.parametrize("d1", [0, 6])
def test_one_pass_of_nine_metrics_equals_nine_passes(graph, d1):
    together = list(candidate_blocks(graph, METRICS, d1, block=64))
    for i, metric in enumerate(METRICS):
        alone = list(candidate_blocks(graph, [metric], d1, block=64))
        assert len(alone) == len(together)
        for (lo, hi, k, s), (lo2, hi2, k2, s2) in zip(alone, together):
            assert (lo, hi) == (lo2, hi2) and torch.equal(k, k2)
            assert torch.equal(s[0], s2[i])
    tops = whole_graph_topks(graph, METRICS, d1, 50, block=100)
    for metric in METRICS:
        one = whole_graph_topks(graph, [metric], d1, 50, block=100)[metric]
        for a, b in zip(tops[metric], one):
            assert torch.equal(a, b)


def test_judge_passes_the_reference_itself(graph):
    u, v, s = whole_graph_topks(graph, ["jaccard_coefficient"], 0,
                                300)["jaccard_coefficient"]
    nums = judge.judge_whole_graph(
        graph, {"metric": "jaccard_coefficient"}, 0, 300,
        [{"jaccard_coefficient": (u.numpy(), v.numpy(), s.numpy())}])
    assert nums == dict(score_gap=0.0, rank_gap=0.0, invalid_rows=0,
                        count_off=0)
    tops = whole_graph_topks(graph, METRICS, 0, 300)
    nums = judge.judge_whole_graph(
        graph, {"metrics": list(METRICS)}, 0, 300,
        [{m: tuple(x.numpy() for x in t) for m, t in tops.items()}])
    assert nums == {f"{n}.{m}": 0 for m in METRICS for n in judge.PER_METRIC}


@pytest.mark.parametrize("cell", ["lhub", "ihub", "serve"])
def test_control_fails_where_the_program_passes(cell, lhub_cfg, ihub_cfg,
                                                batch_traffic,
                                                serve_traffic):
    cfg, traffic = {"lhub": (lhub_cfg, batch_traffic),
                    "ihub": (ihub_cfg, batch_traffic),
                    "serve": (ihub_cfg, serve_traffic)}[cell]
    limits = traffic["limits"]
    cpu = torch.device("cpu")
    prog = control.program_readings(cfg, traffic, 21, cpu, requests=4)
    ctrl = control.control_readings(cfg, traffic, 21, cpu, requests=4)
    prog["missing"] = ctrl["missing"] = 0
    assert judge.verdict(prog, limits)[0], prog
    assert not judge.verdict(ctrl, limits)[0], ctrl


def test_the_bfloat16_control_fails_each_non_count_metric(lhub_cfg,
                                                          allmetrics):
    """The program passes every metric's limits; the control fails at
    least one number of each metric but CN, whose counts bfloat16 holds
    exactly at this size (all under 256), so it reads 0 there."""
    limits = judge.flat_limits(allmetrics)
    cpu = torch.device("cpu")
    prog = control.program_readings(lhub_cfg, allmetrics, 21, cpu)
    ctrl = control.control_readings(lhub_cfg, allmetrics, 21, cpu)
    prog["missing"] = ctrl["missing"] = 0
    assert judge.verdict(prog, limits)[0], prog
    for m in METRICS:
        failed = [n for n in judge.PER_METRIC
                  if ctrl[f"{n}.{m}"] > limits[f"{n}.{m}"]]
        if m == "common_neighbors":
            assert not failed and ctrl[f"score_gap.{m}"] == 0.0
        else:
            assert failed, (m, ctrl)
