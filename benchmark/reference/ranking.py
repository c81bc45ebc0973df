"""Top-N rankings judged against float64 scores.

A list is judged position by position: the score, under the float64
product ``a . B^T``, of the item it puts at rank ``r`` against the
``r``-th best score among the items allowed, as a share of the best
score.  A repeated item, a missing one (``-1``) or a left-out item
reads infinite.  Two lists that differ only where scores tie read 0.
"""

from __future__ import annotations

from typing import Optional

import torch


def rank_gap(A: torch.Tensor, B: torch.Tensor, got: torch.Tensor,
             seen: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per query, the widest gap of ``got`` [Q, n] (item ids) below the
    best scores of ``A`` [Q, k] against ``B`` [n_items, k], with
    ``seen`` [Q, n_items] (bool, True = left out) masked first."""
    scores = A.to(torch.float64) @ B.to(torch.float64).t()
    if seen is not None:
        scores = scores.masked_fill(seen, -torch.inf)
    n = got.shape[1]
    best = torch.topk(scores, n, dim=1).values
    ok = (got >= 0) & (got < scores.shape[1])
    at = torch.where(ok, got, 0)
    mine = torch.where(ok, scores.gather(1, at), -torch.inf)
    srt = torch.sort(at, dim=1).values
    dup = (srt[:, 1:] == srt[:, :-1]).any(1)
    scale = best[:, :1].abs().clamp_min(1e-30)
    gap = ((best - mine) / scale).amax(1)
    return torch.where(dup, torch.inf, gap)


def topn_lowp(A: torch.Tensor, B: torch.Tensor, n: int,
              dtype: torch.dtype, seen: Optional[torch.Tensor] = None):
    """The ranking computed in ``dtype`` (the control's): (scores, ids)."""
    scores = (A.to(dtype) @ B.to(dtype).t())
    if seen is not None:
        scores = scores.masked_fill(seen, -torch.inf)
    vals, idx = torch.topk(scores, n, dim=1)
    return vals.to(torch.float64), idx
