"""Top-k container, its merge helpers, and the selection-key transforms
(counterpart of ``linkpred_tpu/ops/topk.py`` and of
``scoring._desc_score_key`` / ``_desc_key_score``).

Top k.  ``lax.top_k`` puts the lower index first among equal scores;
``torch.topk`` on a card promises no order, so the helpers take a stable
descending ``torch.sort``, which keeps the reference's tie rule.

Selection keys.  The reference's keys are u32 whose ascending order is the
scores' descending order.  PyTorch's uint32 support is partial (no shifts on
the CPU), so the port carries each key as int32 with the sign bit flipped
(``u ^ 0x80000000`` reinterpreted), which keeps the order: the reference's
u32 key is ``(key ^ INT32_MIN)`` viewed as uint32.  The pad sentinel, u32
max, becomes ``INT32_MAX`` and stays the largest key.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device

__all__ = ["TopK", "topk_init", "topk_from_candidates", "topk_merge",
           "DEAD_KEY", "desc_score_key", "desc_key_score", "spread_invalid"]

NEG_INF = float("-inf")

# The pad sentinel (the reference's 0xFFFFFFFF): sorts after every real key.
DEAD_KEY = 0x7FFFFFFF
# Invalid (-inf) lanes OR their lane index under this mask into the key:
# bit 0 stays clear so no spread key reaches DEAD_KEY.
SPREAD_MASK = 0x7FFFFE


class TopK(NamedTuple):
    scores: torch.Tensor  # float32[..., k], -inf = empty slot
    u: torch.Tensor       # int32[..., k]
    v: torch.Tensor       # int32[..., k]


def topk_init(k: int, device="cuda") -> TopK:
    """An empty buffer of ``k`` slots on ``device``."""
    device = resolve_device(device)
    return TopK(torch.full((k,), NEG_INF, dtype=torch.float32, device=device),
                torch.zeros(k, dtype=torch.int32, device=device),
                torch.zeros(k, dtype=torch.int32, device=device))


def topk_from_candidates(scores, u, v, k: int) -> TopK:
    """The ``k`` best of a candidate set (invalid lanes carry -inf), best
    first, the lower lane first among equal scores; padded with empty
    slots up to ``k``.  Runs on the candidates' device."""
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    out = TopK(scores[order], u[order], v[order])
    pad = k - order.shape[0]
    if pad > 0:
        empty = topk_init(pad, scores.device)
        out = TopK(*(torch.cat([a, b]) for a, b in zip(out, empty)))
    return out


def topk_merge(a: TopK, b: TopK) -> TopK:
    """The ``k = len(a.scores)`` best of two buffers, by one descending
    sort (the reference's is unstable, so which of equal scores at the
    k-th place survives is not part of the contract)."""
    k = a.scores.shape[0]
    s2, u2, v2 = (torch.cat([x, y]) for x, y in zip(a, b))
    order = torch.sort(s2, descending=True, stable=True).indices[:k]
    return TopK(s2[order], u2[order], v2[order])


def desc_score_key(x: torch.Tensor) -> torch.Tensor:
    """int32 key whose ascending order is the float32 scores' descending
    order (-inf sinks to the end)."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, b & 0x7FFFFFFF, ~b)


def desc_key_score(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`desc_score_key`; a spread invalid key decodes to a
    NaN, mapped back to -inf here."""
    b = torch.where(key < 0, ~key, key | torch.iinfo(torch.int32).min)
    x = b.view(torch.float32)
    return torch.where(torch.isnan(x), float("-inf"), x)


def spread_invalid(key: torch.Tensor, score: torch.Tensor,
                   lane: torch.Tensor) -> torch.Tensor:
    """OR each -inf lane's index (masked) into its key: a constant duplicate
    mass of keys makes sorts slow, and the spread keeps invalid lanes after
    every real one."""
    return torch.where(torch.isneginf(score), key | (lane & SPREAD_MASK), key)
