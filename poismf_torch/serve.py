"""Serving surface: pointwise prediction, top-N ranking and out-of-sample
factors.

Counterparts of ``poismf_tpu/serve.py``: ``predict_pairs`` is a
gather-dot; ``top_n``, ``top_n_batched`` and ``top_n_batched_excl`` a
matvec (or matmul) plus ``torch.topk``.  ``factors_multiple`` and
``factors_single`` solve new rows against the fixed item factors, routed
as the JAX package routes them: a batch of more than
``ELL_SERVE_NNZ_THRESHOLD`` nonzeros of an ``layout="ell"`` model on the
planar ELL (the hand-written kernels on the card, planes in the fit's
``plane_dtype``), every smaller batch and every single row on the flat
COO against the factors themselves (:mod:`poismf_torch.ops.objective`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .ops import ell as ell_ops
from .ops import objective as obj
from .sparse import CountsMatrix, build_counts, dedupe_sum, to_device
from .solvers.cg import cg_update, cg_update_ell
from .solvers.pg import pg_update, pg_update_ell
from .solvers.tncg import tncg_update, tncg_update_ell
from .utils import profiling

# Batches of more nonzeros than this take the planar-ELL solvers (when
# the model's layout is "ell"); smaller ones the flat-COO solvers.
ELL_SERVE_NNZ_THRESHOLD = 100_000


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
        inc = profiling.to_device(np.asarray(include_ix, dtype=np.int64),
                                  B.device, "serve.upload")
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
            mask[profiling.to_device(excl, B.device, "serve.upload")] = True
        scores = torch.where(mask, -torch.inf, scores)
        vals, idx = torch.topk(scores, n_top)
    idx = profiling.host(idx, "serve.fetch").numpy()
    if output_score:
        return idx, profiling.host(vals, "serve.fetch").numpy()
    return idx


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


def exclude_items_(scores: torch.Tensor, items: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Set ``scores[q, items[q, j]]`` to ``-inf`` in place where
    ``valid[q, j]``: a scatter-min, in which a padding slot writes
    ``+inf`` (a no-op) at column 0."""
    upd = torch.where(valid, -torch.inf, torch.inf).to(scores.dtype)
    return scores.scatter_reduce_(1, torch.where(valid, items, 0), upd,
                                  reduce="amin")


def top_n_batched_excl(
    A_query: torch.Tensor,
    B: torch.Tensor,
    excl_items: torch.Tensor,
    excl_valid: torch.Tensor,
    n_top: int,
    n_items: Optional[int] = None,
):
    """``top_n_batched`` with per-user exclusion lists set to ``-inf`` on
    the device: ``excl_items`` [Q, L] padded item ids, ``excl_valid``
    [Q, L] marks the real ones (:func:`exclude_items_`).  The host sends only the lists, never a [Q, n_items]
    mask.  Exhausted candidate pools give id ``-1`` with a ``-inf`` score,
    as in ``top_n_batched``."""
    scores = A_query @ B.t()
    if n_items is not None and n_items < B.shape[0]:
        scores[:, n_items:] = -torch.inf
    exclude_items_(scores, excl_items, excl_valid)
    vals, idx = torch.topk(scores, n_top, dim=1)
    idx = torch.where(vals == -torch.inf, -1, idx)
    return vals, idx


# ---------------------------------------------------------------------------
# Out-of-sample factors
# ---------------------------------------------------------------------------


def factors_multiple(B: torch.Tensor, Bsum: torch.Tensor,
                     Amean: torch.Tensor, X_new: CountsMatrix, params,
                     reuse_mean: bool = True) -> torch.Tensor:
    """Factors of a batch of new rows with ``B`` fixed, by the training
    method (``params``, a :class:`~poismf_torch.train.FitParams`), from
    ``Amean`` on every row (tncg: from 1e-3 unless ``reuse_mean``):

    * pg: ``niter`` calls of ``maxupd`` steps, the step halved after each;
    * cg: one call of ``maxupd * niter`` iterations;
    * tncg: one pass (f-tolerance 0, the l2 penalty in f, the reference
      inner-CG cap).

    ``Bsum`` already holds the training l1.  A batch of more than
    ``ELL_SERVE_NNZ_THRESHOLD`` nonzeros of a ``layout="ell"`` model is
    solved on its planar ELL (planes in the fit's ``plane_dtype``), any
    other on the flat COO (``nnz_chunk`` as the fit's).  Returns
    ``[X_new.n_rows_pad, k]`` in ``X_new``'s row order, on ``B``'s
    device."""
    p = params.resolved()
    if p.layout == "ell" and X_new.nnz > ELL_SERVE_NNZ_THRESHOLD:
        return _factors_multiple_ell(B, Bsum, Amean, X_new, p, reuse_mean)
    X = to_device(X_new, B.device, B.dtype)
    A = Amean.to(B.dtype).expand(X.n_rows_pad, B.shape[1]).contiguous()
    bsum = Bsum.to(B.dtype)
    if p.w_mult != 1.0:
        bsum = obj.adjusted_bsum(B, bsum, X, p.w_mult)
    if p.method == "pg":
        step = p.initial_step
        for _ in range(p.niter):
            A = pg_update(A, B, X, bsum, p.l2_reg, step, w_mult=p.w_mult,
                          maxupd=p.maxupd, nnz_chunk=p.nnz_chunk)
            step *= 0.5
    elif p.method == "cg":
        A = cg_update(A, B, X, bsum, l2_reg=p.l2_reg, w_mult=p.w_mult,
                      maxupd=p.maxupd * p.niter, limit_step=p.limit_step,
                      nnz_chunk=p.nnz_chunk)
    else:
        A, _ = tncg_update(A, B, X, bsum, l2_reg=p.l2_reg, w_mult=p.w_mult,
                           maxupd=p.maxupd, reuse_prev=reuse_mean,
                           track_unchanged=False, nnz_chunk=p.nnz_chunk,
                           ftol=0.0, l2_in_f=True)
    return A


def _factors_multiple_ell(B, Bsum, Amean, X_new: CountsMatrix, p,
                          reuse_mean: bool) -> torch.Tensor:
    """:func:`factors_multiple` on the planar ELL of ``X_new`` (its
    columns B's rows), with ``Amean`` on every slot."""
    ell = ell_ops.ell_from_counts(X_new, device=B.device)
    planes = ell_ops.gather_planes(B, ell, ell_ops.torch_dtype(p.plane_dtype))
    A = Amean.to(B.dtype).expand(ell.n_rows_ell, B.shape[1]).contiguous()
    bsum = Bsum.to(B.dtype)
    if p.w_mult != 1.0:
        bsum = ell_ops.adjusted_bsum_ell(planes, ell, bsum, p.w_mult)
    if p.method == "pg":
        step = p.initial_step
        for _ in range(p.niter):
            A = pg_update_ell(A, planes, ell, bsum, p.l2_reg, step,
                              w_mult=p.w_mult, maxupd=p.maxupd)
            step *= 0.5
    elif p.method == "cg":
        A = cg_update_ell(A, planes, ell, bsum, l2_reg=p.l2_reg,
                          w_mult=p.w_mult, maxupd=p.maxupd * p.niter,
                          limit_step=p.limit_step)
    else:
        # serving solves: f-tolerance 0 (the reference's f-rescaled ftol
        # tightens toward zero near the optimum), the l2 penalty in f, the
        # reference inner-CG cap; ls_cand and bd_accum take their defaults
        A, _ = tncg_update_ell(A, planes, ell, bsum, l2_reg=p.l2_reg,
                               w_mult=p.w_mult, maxupd=p.maxupd,
                               reuse_prev=reuse_mean, track_unchanged=False,
                               ftol=0.0, l2_in_f=True)
    return ell_ops.permute_rows(A, ell.inv_perm)


def factors_single(B: torch.Tensor, Bsum: torch.Tensor, Amean: torch.Tensor,
                   item_ix: np.ndarray, counts: np.ndarray, *,
                   l2_reg: float, l1_new: float = 0.0, l1_old: float = 0.0,
                   w_mult: float = 1.0, maxupd: int = 1000,
                   reuse_mean: bool = True,
                   n_items: Optional[int] = None) -> torch.Tensor:
    """Factors ``[k]`` of ONE new row, always by tncg whatever the
    training method.  Duplicate items are summed first; ``Bsum`` is
    shifted by ``(w_mult - 1)`` times the sum of the row's B rows and by
    ``l1_new - l1_old`` when that is positive.  An empty row gives zeros.
    The row is solved by the flat-COO tncg, as in the JAX package."""
    k, dtype = B.shape[1], B.dtype
    item_ix = np.asarray(item_ix, dtype=np.int32).reshape(-1)
    counts = np.asarray(counts).reshape(-1)
    if item_ix.size == 0:
        return torch.zeros((k,), dtype=dtype, device=B.device)
    n = B.shape[0] if n_items is None else n_items
    np_dtype = np.dtype(str(dtype).replace("torch.", ""))
    # duplicates summed, so that the w_mult shift counts each item once
    _, item_ix, counts = dedupe_sum(np.zeros_like(item_ix), item_ix,
                                    counts.astype(np_dtype), n)
    X1 = to_device(build_counts(np.zeros_like(item_ix), item_ix, counts, 1,
                                n, dtype=np_dtype), B.device)
    bsum = Bsum.to(dtype)
    if w_mult != 1.0:
        rows = profiling.to_device(item_ix.astype(np.int64), B.device,
                                   "serve.upload")
        bsum = bsum + (w_mult - 1.0) * B[rows].sum(0)
    l1_delta = l1_new - l1_old
    if l1_delta > 0.0:
        bsum = bsum + l1_delta
    A0 = torch.zeros((X1.n_rows_pad, k), dtype=dtype, device=B.device)
    A0[0] = Amean.to(dtype)
    A, _ = tncg_update(A0, B, X1, bsum, l2_reg=float(l2_reg),
                       w_mult=float(w_mult), maxupd=int(maxupd),
                       reuse_prev=reuse_mean, track_unchanged=False,
                       ftol=0.0, l2_in_f=True)
    return A[0]
