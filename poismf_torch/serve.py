"""Serving surface: pointwise prediction and top-N ranking (plain PyTorch).

Counterparts of ``predict_pairs``, ``top_n`` and ``top_n_batched`` in
``poismf_tpu/serve.py``: a gather-dot, and a matvec (or matmul) plus
``torch.topk``.  No kernel of the JAX package is involved.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def predict_pairs(A: torch.Tensor, B: torch.Tensor, ixA: torch.Tensor,
                  ixB: torch.Tensor) -> torch.Tensor:
    """out[t] = <A[ixA[t]], B[ixB[t]]>."""
    return (A[ixA] * B[ixB]).sum(-1)


def top_n(
    a_vec: torch.Tensor,
    B: torch.Tensor,
    n_top: int = 10,
    include_ix: Optional[np.ndarray] = None,
    exclude_ix: Optional[np.ndarray] = None,
    n_items: Optional[int] = None,
    output_score: bool = False,
):
    """Top-N highest-score items for one user vector, as host arrays.

    Include and exclude lists are mutually exclusive; ``n_items`` masks
    out padded B rows.  Like the reference, it refuses rather than return
    a short list when too few candidates remain."""
    n = B.shape[0] if n_items is None else n_items
    if include_ix is not None and exclude_ix is not None:
        raise ValueError("Can pass only one of 'include' or 'exclude'.")
    if n_top <= 0:
        raise ValueError("'n_top' must be positive.")
    if include_ix is not None:
        inc = torch.as_tensor(np.asarray(include_ix, dtype=np.int64),
                              device=B.device)
        if n_top > inc.shape[0]:
            raise ValueError("'n_top' is larger than the include list.")
        vals, pos = torch.topk(B[inc] @ a_vec, n_top)
        idx = inc[pos]
    else:
        if n_top > n:
            raise ValueError("'n_top' is larger than the number of items.")
        scores = B @ a_vec
        mask = torch.zeros((B.shape[0],), dtype=torch.bool, device=B.device)
        mask[n:] = True  # padded item rows
        if exclude_ix is not None:
            excl = np.asarray(exclude_ix, dtype=np.int64)
            if np.unique(excl).shape[0] > n - n_top:
                raise ValueError(
                    "Too many excluded items: fewer than 'n_top' candidates "
                    "remain."
                )
            mask[torch.as_tensor(excl, device=B.device)] = True
        scores = torch.where(mask, -torch.inf, scores)
        vals, idx = torch.topk(scores, n_top)
    if output_score:
        return idx.cpu().numpy(), vals.cpu().numpy()
    return idx.cpu().numpy()


def top_n_batched(
    A_query: torch.Tensor,
    B: torch.Tensor,
    n_top: int,
    exclude_mask: Optional[torch.Tensor] = None,
    n_items: Optional[int] = None,
):
    """Full-catalog top-N for a batch of user vectors: one [Q, k] x [k, n]
    matmul + ``torch.topk``.  ``exclude_mask`` is an optional [Q, n] bool
    mask (True = forbidden); ``n_items`` masks padded B rows.  Positions
    whose candidate pool is exhausted return id ``-1`` with a ``-inf``
    score.  Returns (scores [Q, n_top], ids [Q, n_top]) on the device."""
    scores = A_query @ B.t()
    masked = False
    if n_items is not None and n_items < B.shape[0]:
        cols = torch.arange(B.shape[0], device=B.device)[None, :]
        scores = torch.where(cols >= n_items, -torch.inf, scores)
        masked = True
    if exclude_mask is not None:
        scores = torch.where(exclude_mask, -torch.inf, scores)
        masked = True
    vals, idx = torch.topk(scores, n_top, dim=1)
    if masked:
        idx = torch.where(vals == -torch.inf, -1, idx)
    return vals, idx
