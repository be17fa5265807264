"""The comparison that decides ``correct``: the program's answers against the
plain reference (``reference/``), worked out again from the graph and the
request.

Numbers compared (each against its limit in the traffic file):

* ``score_gap``: the widest gap, relative to the reference's score, between
  an answered row's score and the reference's score of that pair;
* ``rank_gap``: the widest relative gap between the answer's i-th best
  score and the reference's i-th best (the whole graph's top k, or each
  user's best rows); ties at the k-th score make any of the tied pairs
  right, so the scores are compared by rank and not the pairs;
* ``invalid_rows``: answered rows that are no candidate (an edge, ``u ==
  v``, no common neighbour, a pair outside the request) or repeat a row;
* ``count_off``: rows missing or in excess: the whole graph's answer holds
  ``min(k, candidates)`` rows; a user holds as many rows as the
  reference's top ``max_edges`` leaves it, up to ``per_user``, where ties
  within the ``rank_gap`` limit of the last score may go either way;
* ``missing``: calls that raised or never returned an answer.

A whole-graph answer holds one answer a metric of the traffic
(:func:`metric_names`), each judged against its own reference.  Where the
traffic names several ``metrics``, its numbers are named
``<number>.<metric>`` (``score_gap.adamic_adar``), beside one ``missing``,
and its ``limits`` may map a metric's name to that metric's own limits
(:func:`flat_limits`); where it names one ``metric``, the numbers keep
their own names.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import candidate_blocks, source_candidates

__all__ = ["metric_names", "judge_whole_graph", "judge_served", "verdict",
           "flat_limits", "PER_METRIC"]

# The numbers judged for each metric of an answer.
PER_METRIC = ("score_gap", "rank_gap", "invalid_rows", "count_off")


def metric_names(traffic: dict) -> tuple:
    """The metrics a traffic mix scores: its ``metrics``, or its one
    ``metric``."""
    return tuple(traffic["metrics"]) if "metrics" in traffic \
        else (traffic["metric"],)


def _check(traffic: dict, number: str, metric: str) -> str:
    """A whole-graph check's name: ``<number>.<metric>`` where the traffic
    names several ``metrics``, the number's own where it names one."""
    return f"{number}.{metric}" if "metrics" in traffic else number


def _rel(a, b):
    """The widest ``|a - b| / |b|``; a gap to a reference of 0 reads as
    1e300 (JSON has no infinity)."""
    if not a.numel():
        return 0.0
    gap = ((a - b).abs() / b.abs()).max().item()
    return gap if np.isfinite(gap) else 1e300


def _answer_set(u, v, s, n: int, dev) -> dict:
    key = torch.as_tensor(np.asarray(u, np.int64) * n
                          + np.asarray(v, np.int64), device=dev)
    score = torch.as_tensor(np.asarray(s, np.float64), device=dev)
    key, order = torch.sort(key)
    dup = int((key[1:] == key[:-1]).sum()) if key.numel() else 0
    return dict(key=key, score=score[order], desc=score,
                ref=torch.full_like(score, float("nan")), dup=dup)


def judge_whole_graph(g, traffic: dict, min_degree1: int, k: int, answers,
                      block: int = 1 << 27) -> dict:
    """Numbers of whole-graph answers ``[{metric: (u, v, score)}]`` (host
    arrays), one answer a metric of ``traffic``.  One pass over the
    reference's candidates judges every metric, each with its own running
    top k."""
    names = metric_names(traffic)
    dev = g.indices.device
    n = g.n
    sets = [[_answer_set(*a[m], n, dev) for a in answers] for m in names]
    best = torch.empty((len(names), 0), dtype=torch.float64, device=dev)
    n_cand = 0
    for lo, hi, keys, score in candidate_blocks(g, names, min_degree1,
                                                block=block):
        n_cand += int(keys.shape[0])
        for row, answered in zip(score, sets):
            for a in answered:
                i0 = int(torch.searchsorted(a["key"], lo * n))
                i1 = int(torch.searchsorted(a["key"], hi * n))
                if i1 <= i0 or keys.numel() == 0:
                    continue
                q = a["key"][i0:i1]
                p = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
                hit = keys[p] == q
                a["ref"][i0:i1] = torch.where(hit, row[p],
                                              torch.full_like(row[p],
                                                              float("nan")))
        best = torch.cat([best, score], 1)
        del score
        if best.shape[1] > k:
            best = torch.topk(best, k, dim=1, sorted=False).values
    best = torch.sort(best, dim=1, descending=True).values
    want = min(k, n_cand)
    out = {}
    for m, ref_best, answered in zip(names, best, sets):
        nums = dict(score_gap=0.0, rank_gap=0.0, invalid_rows=0, count_off=0)
        for a in answered:
            found = ~torch.isnan(a["ref"])
            nums["invalid_rows"] = max(nums["invalid_rows"],
                                       int((~found).sum()) + a["dup"])
            nums["score_gap"] = max(nums["score_gap"],
                                    _rel(a["score"][found], a["ref"][found]))
            got = torch.sort(a["desc"], descending=True).values
            c = min(got.shape[0], want)
            nums["rank_gap"] = max(nums["rank_gap"],
                                   _rel(got[:c], ref_best[:c]))
            nums["count_off"] = max(nums["count_off"],
                                    abs(got.shape[0] - want))
        out.update((_check(traffic, name, m), v) for name, v in nums.items())
    return out


def _per_user(users, u, score, per_user: int):
    """``(best [U, per_user] NaN-padded, rows [U])``: each user's best
    scores, descending, and its row count."""
    n_users = users.shape[0]
    idx = torch.searchsorted(users, u)
    order = torch.sort(score, descending=True, stable=True).indices
    order = order[torch.sort(idx[order], stable=True).indices]
    iu, sc = idx[order], score[order]
    rows = torch.bincount(iu, minlength=n_users)
    start = torch.cumsum(rows, 0) - rows
    rank = torch.arange(iu.shape[0], device=iu.device) - start[iu]
    best = torch.full((n_users, per_user), float("nan"), dtype=sc.dtype,
                      device=sc.device)
    keep = rank < per_user
    best[iu[keep], rank[keep]] = sc[keep]
    return best, rows


def judge_served(g, metric: str, min_degree1: int, requests, *,
                 max_edges: int, per_user: int, band: float) -> dict:
    """Numbers of served answers ``[(users, (u, v, score))]``: each request
    is worked out again by the reference from its users."""
    dev = g.indices.device
    n = g.n
    out = dict(score_gap=0.0, rank_gap=0.0, invalid_rows=0, count_off=0)
    for users, (u, v, s) in requests:
        users = torch.sort(torch.as_tensor(np.asarray(users, np.int64),
                                           device=dev)).values
        keys, score = source_candidates(g, metric, min_degree1, users)
        if score.shape[0] > max_edges:
            cut = torch.topk(score, max_edges).values[-1].item()
        else:
            cut = float("-inf")
        ru = keys // n
        ref_best, _ = _per_user(users, ru, score, per_user)
        n_hi = torch.bincount(torch.searchsorted(
            users, ru[score > cut * (1 + band)]), minlength=users.shape[0])
        n_lo = torch.bincount(torch.searchsorted(
            users, ru[score >= cut * (1 - band)]), minlength=users.shape[0])
        au = torch.as_tensor(np.asarray(u, np.int64), device=dev)
        av = torch.as_tensor(np.asarray(v, np.int64), device=dev)
        asc = torch.as_tensor(np.asarray(s, np.float64), device=dev)
        akey = au * n + av
        sk = torch.sort(akey).values
        dup = int((sk[1:] == sk[:-1]).sum()) if sk.numel() else 0
        if keys.numel():
            p = torch.searchsorted(keys, akey).clamp(max=keys.shape[0] - 1)
            hit = keys[p] == akey
            ref = score[p]
        else:
            hit = torch.zeros_like(akey, dtype=torch.bool)
            ref = asc
        out["invalid_rows"] += int((~hit).sum()) + dup
        out["score_gap"] = max(out["score_gap"], _rel(asc[hit], ref[hit]))
        au, asc = au[hit], asc[hit]
        got_best, got_rows = _per_user(users, au, asc, per_user)
        have = ~torch.isnan(got_best)
        out["rank_gap"] = max(out["rank_gap"], _rel(
            got_best[have], torch.nan_to_num(ref_best[have], nan=0.0)))
        lo = torch.clamp(n_hi, max=per_user)
        hi = torch.clamp(n_lo, max=per_user)
        out["count_off"] += int(((got_rows < lo) | (got_rows > hi)).sum())
    return out


def flat_limits(traffic: dict) -> dict:
    """``{check: limit}`` of a traffic mix, the checks named as the judge
    names its numbers: each metric's limits from ``limits[metric]`` where
    it gives them, else from the shared ``limits[<number>]``, then
    ``missing``."""
    limits = traffic["limits"]
    out = {}
    for m in metric_names(traffic):
        own = limits.get(m, {})
        for name in PER_METRIC:
            out[_check(traffic, name, m)] = own[name] if name in own \
                else limits[name]
    out["missing"] = limits["missing"]
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit."""
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
