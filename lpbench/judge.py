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
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import candidate_blocks, source_candidates

__all__ = ["judge_whole_graph", "judge_served", "verdict"]


def _rel(a, b):
    """The widest ``|a - b| / |b|``; a gap to a reference of 0 reads as
    1e300 (JSON has no infinity)."""
    if not a.numel():
        return 0.0
    gap = ((a - b).abs() / b.abs()).max().item()
    return gap if np.isfinite(gap) else 1e300


def judge_whole_graph(g, metric: str, min_degree1: int, k: int, answers,
                      block: int = 1 << 27) -> dict:
    """Numbers of whole-graph answers ``[(u, v, score)]`` (host arrays)."""
    dev = g.indices.device
    n = g.n
    sets = []
    for u, v, s in answers:
        key = torch.as_tensor(np.asarray(u, np.int64) * n
                              + np.asarray(v, np.int64), device=dev)
        score = torch.as_tensor(np.asarray(s, np.float64), device=dev)
        key, order = torch.sort(key)
        dup = int((key[1:] == key[:-1]).sum()) if key.numel() else 0
        sets.append(dict(key=key, score=score[order], desc=score,
                         ref=torch.full_like(score, float("nan")), dup=dup))
    best = torch.empty(0, dtype=torch.float64, device=dev)
    n_cand = 0
    for lo, hi, keys, score in candidate_blocks(g, metric, min_degree1,
                                                block=block):
        n_cand += int(keys.shape[0])
        for a in sets:
            i0 = int(torch.searchsorted(a["key"], lo * n))
            i1 = int(torch.searchsorted(a["key"], hi * n))
            if i1 <= i0 or keys.numel() == 0:
                continue
            q = a["key"][i0:i1]
            p = torch.searchsorted(keys, q).clamp(max=keys.shape[0] - 1)
            hit = keys[p] == q
            a["ref"][i0:i1] = torch.where(hit, score[p],
                                          torch.full_like(score[p],
                                                          float("nan")))
        best = torch.cat([best, score])
        if best.shape[0] > k:
            best = torch.topk(best, k, sorted=False).values
    best = torch.sort(best, descending=True).values
    want = min(k, n_cand)
    out = dict(score_gap=0.0, rank_gap=0.0, invalid_rows=0, count_off=0)
    for a in sets:
        found = ~torch.isnan(a["ref"])
        out["invalid_rows"] = max(out["invalid_rows"],
                                  int((~found).sum()) + a["dup"])
        out["score_gap"] = max(out["score_gap"],
                               _rel(a["score"][found], a["ref"][found]))
        got = torch.sort(a["desc"], descending=True).values
        m = min(got.shape[0], want)
        out["rank_gap"] = max(out["rank_gap"], _rel(got[:m], best[:m]))
        out["count_off"] = max(out["count_off"], abs(got.shape[0] - want))
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


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: each number beside its limit."""
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
