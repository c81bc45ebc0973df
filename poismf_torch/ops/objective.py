"""Objective pieces shared by the solver and the model (plain PyTorch).

Counterparts of ``make_bsum``, ``combine_f_gtd``, ``ray_coef``,
``combine_f_ray``, ``combine_f_gtd_ray``, ``eval_llk_entries`` and
``eval_llk`` in ``poismf_tpu/ops/objective.py``.
"""

from __future__ import annotations

import torch

# Floor for log/division at near-zero predictions in the LL evaluation.
PRED_EPS = 1e-30

# Entries per LL chunk: bounds the [chunk, k] gather intermediates.
LLK_CHUNK = 4_194_304


def make_bsum(M: torch.Tensor, n_rows: int, l1_reg: float) -> torch.Tensor:
    """Colsums of the fixed matrix + l1; ``n_rows`` masks padded rows."""
    return M[:n_rows].sum(0) + l1_reg


def combine_f_gtd(nll, gud, A_trial, D, Bsum, l2_reg, w_mult, l2_in_f):
    """Fold a trial's data terms ``(nll, gud)`` with the linear and l2
    parts into ``(f, gtd)``.  With ``l2_in_f=False`` f omits the l2 term
    while gtd keeps ``2 l2 <trial, d>`` (the reference TNCG objective)."""
    if w_mult != 1.0:
        nll = w_mult * nll
        gud = w_mult * gud
    if Bsum.dim() == 1:
        lin = A_trial @ Bsum
        lin_d = D @ Bsum
    else:
        lin = (A_trial * Bsum).sum(-1)
        lin_d = (D * Bsum).sum(-1)
    if l2_in_f:
        lin = lin + l2_reg * (A_trial * A_trial).sum(-1)
    f = lin + nll
    gtd = lin_d + 2.0 * l2_reg * (A_trial * D).sum(-1) - gud
    return f, gtd


def ray_coef(x: torch.Tensor, D: torch.Tensor, Bsum: torch.Tensor):
    """Per-row coefficients of the exact quadratic linear/l2 part of ``f``
    along the ray ``x + a*D``, computed once per line search:

      lin(a) = bx + a*bdl
      |x + a*D|^2 = xx + 2a*xd + a^2*dd
    """
    if Bsum.dim() == 1:
        bx = x @ Bsum
        bdl = D @ Bsum
    else:
        bx = (x * Bsum).sum(-1)
        bdl = (D * Bsum).sum(-1)
    xx = (x * x).sum(-1)
    xd = (x * D).sum(-1)
    dd = (D * D).sum(-1)
    return (bx, bdl, xx, xd, dd)


def combine_f_ray(nll, alpha, coef, l2_reg, w_mult):
    """f-only tail of :func:`combine_f_gtd_ray` with the l2 penalty in f
    (the CG objective; its trials test only f)."""
    bx, bdl, xx, xd, dd = coef
    if w_mult != 1.0:
        nll = w_mult * nll
    lin = bx + alpha * bdl
    lin = lin + l2_reg * (xx + 2.0 * alpha * xd + alpha * alpha * dd)
    return lin + nll


def combine_f_gtd_ray(nll, gud, alpha, coef, l2_reg, w_mult, l2_in_f):
    """Fold a ray trial's data terms with the linear/l2 parts, which are
    exact polynomials in alpha through :func:`ray_coef`'s coefficients.
    ``nll``, ``gud`` and ``alpha`` may carry a leading candidate axis."""
    bx, bdl, xx, xd, dd = coef
    if w_mult != 1.0:
        nll = w_mult * nll
        gud = w_mult * gud
    lin = bx + alpha * bdl
    if l2_in_f:
        lin = lin + l2_reg * (xx + 2.0 * alpha * xd + alpha * alpha * dd)
    f = lin + nll
    gtd = bdl + 2.0 * l2_reg * (xd + alpha * dd) - gud
    return f, gtd


def _ll_terms(A, B, rows, cols, vals, full_llk: bool, with_pred: bool):
    pred = (A[rows] * B[cols]).sum(-1)
    safe = torch.clamp_min(pred, PRED_EPS)
    valid = vals > 0
    term = vals * torch.log(safe)
    if with_pred:
        term = term - pred
    ll = torch.where(valid, term, 0.0).sum()
    if full_llk:
        ll = ll - torch.where(valid, torch.lgamma(vals + 1.0), 0.0).sum()
    return ll


def eval_llk_entries(A, B, rows, cols, vals, full_llk: bool = False):
    """Sum over the given entries of the Poisson log-likelihood
    ``x*log(pred) - pred`` (minus ``lgamma(x+1)`` when ``full_llk``)."""
    return _ll_terms(A, B, rows, cols, vals, full_llk, with_pred=True)


def eval_llk(A, B, X, full_llk: bool = False,
             include_missing: bool = False):
    """Poisson LL over the entries of the host CountsMatrix ``X``, in
    chunks of LLK_CHUNK entries on ``A``'s device.  With
    ``include_missing`` the ``-pred`` term covers ALL user-item pairs,
    computed in O((m+n)k) as ``<colsum(A), colsum(B)>``."""
    rows, cols, vals = X.triplets()
    dev = A.device
    ll = torch.zeros((), dtype=A.dtype, device=dev)
    for s in range(0, X.nnz, LLK_CHUNK):
        sl = slice(s, s + LLK_CHUNK)
        r = torch.from_numpy(rows[sl].astype("int64")).to(dev)
        c = torch.from_numpy(cols[sl].astype("int64")).to(dev)
        v = torch.from_numpy(vals[sl]).to(dev, A.dtype)
        ll = ll + _ll_terms(A, B, r, c, v, full_llk,
                            with_pred=not include_missing)
    if include_missing:
        ll = ll - torch.dot(A[: X.n_rows].sum(0), B[: X.n_cols].sum(0))
    return ll
