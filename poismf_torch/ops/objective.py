"""Poisson objective over the flat COO stream, and the pieces the ELL
solvers share (plain PyTorch).

Counterpart of ``poismf_tpu/ops/objective.py``.  Every evaluation is a
few tensor programs over the whole nonzero stream of a
:class:`~poismf_torch.sparse.DeviceCounts`:

  * SDDMM:  ``pred[e] = <A[row(e)], B[col(e)]>``, a gather and a dot;
  * row sums of per-entry terms (the gradient's ``(x/pred) B[col]``, the
    log terms), by ``torch.segment_reduce`` over the rows' host-built
    offsets (:class:`~poismf_torch.sparse.Chunk`): one sequential loop a
    segment, so a row's sum comes out the same on the card and the CPU,
    run after run (CUDA's ``index_add_`` sums in no fixed order).

The per-row objective is ``f_r = <Bsum, a_r> + l2 ||a_r||^2 - w_mult
sum_i x_ri log <a_r, B_i>`` with ``Bsum = colsums(B) + l1`` (per row when
``w_mult != 1``, :func:`adjusted_bsum`).  Every op that takes
``nnz_chunk`` walks the stream in chunks of that many entries (a divisor
of the padded nnz), so its ``[chunk, k]`` gathers never reach the full
``[nnz, k]``, and adds each chunk's row sums to the running ones in
chunk order, as the JAX package's ``lax.scan`` does.  This layout
launches no hand-written kernel: its work is gathers and segment sums.
"""

from __future__ import annotations

from typing import Optional

import torch

# Floor for log/division at near-zero predictions.  Objective values keep
# the reference's Inf poisoning (log 0 = -inf, so f = +inf); gradient
# weights use this floor.
PRED_EPS = 1e-30

# Entries per LL chunk: bounds the [chunk, k] gather intermediates.
LLK_CHUNK = 4_194_304


def make_bsum(M: torch.Tensor, n_rows: int, l1_reg: float) -> torch.Tensor:
    """Colsums of the fixed matrix + l1; ``n_rows`` masks padded rows."""
    return M[:n_rows].sum(0) + l1_reg


# ---------------------------------------------------------------------------
# Flat-COO primitives
# ---------------------------------------------------------------------------


def _maybe_chunk(nnz_pad: int, nnz_chunk: Optional[int]) -> Optional[int]:
    """The chunk size an op walks the stream in: None (one pass) unless
    ``nnz_chunk`` is below ``nnz_pad``, which it must then divide."""
    if nnz_chunk is None or nnz_chunk >= nnz_pad:
        return None
    if nnz_pad % nnz_chunk != 0:
        raise ValueError(
            f"nnz_chunk ({nnz_chunk}) must divide padded nnz ({nnz_pad})"
        )
    return nnz_chunk


def _chunks(X, nnz_chunk):
    return X.chunks(_maybe_chunk(X.nnz_pad, nnz_chunk))


def sddmm(A: torch.Tensor, B: torch.Tensor, row_ids, col_ids) -> torch.Tensor:
    """pred[e] = <A[row_ids[e]], B[col_ids[e]]>; row ids beyond A's rows
    (padding) read its last row, whose entries carry no count."""
    a = A.index_select(0, torch.clamp_max(row_ids, A.shape[0] - 1))
    return (a * B.index_select(0, col_ids)).sum(-1)


def _row_sums(values: torch.Tensor, ch) -> torch.Tensor:
    """Sums of a chunk's per-entry ``values`` over rows ``[ch.r0, ch.r1)``
    (its padding entries dropped)."""
    out = torch.segment_reduce(values[:ch.n_real], "sum",
                               offsets=ch.piece_offsets, unsafe=True)
    if ch.row_offsets is not None:
        out = torch.segment_reduce(out, "sum", offsets=ch.row_offsets,
                                   unsafe=True)
    return out


def _add_rows(acc: torch.Tensor, values: torch.Tensor, ch,
              sign: float = 1.0) -> None:
    """acc[r] += sign * (the chunk's sum of ``values`` over row r)."""
    if ch.n_real:
        part = _row_sums(values, ch)
        acc[ch.r0:ch.r1] += part if sign > 0 else -part


def segment_rowsum(values: torch.Tensor, X) -> torch.Tensor:
    """Per-entry ``values`` [nnz_pad, ...] summed into per-row values
    [n_rows_pad, ...]; padding entries are dropped."""
    out = values.new_zeros((X.n_rows_pad,) + tuple(values.shape[1:]))
    _add_rows(out, values, X.chunks(None)[0])
    return out


def spmm(weights: torch.Tensor, B: torch.Tensor, X) -> torch.Tensor:
    """out[r] = sum_{e: row(e) = r} weights[e] * B[col(e)]: [n_rows_pad, k]."""
    return segment_rowsum(weights[:, None] * B.index_select(0, X.col_ids), X)


# ---------------------------------------------------------------------------
# Fused evaluations over a DeviceCounts
# ---------------------------------------------------------------------------


def poisson_data_terms(A, B, X, nnz_chunk: Optional[int] = None):
    """Per-row data terms of (f, grad) and the per-entry predictions:
    ``(neg_llk [R], grad_data [R, k], px [nnz_pad])`` with ``neg_llk[r] =
    - sum_i x_ri log pred_ri`` (log unfloored: a non-positive prediction at
    a positive count poisons the row's f) and ``grad_data[r] = - sum_i
    (x_ri / max(pred_ri, eps)) B_i``."""
    R, k = X.n_rows_pad, A.shape[1]
    neg_llk = A.new_zeros(R)
    grad = A.new_zeros((R, k))
    px = A.new_empty(X.nnz_pad)
    for ch in _chunks(X, nnz_chunk):
        b = B.index_select(0, ch.cols)
        pred = (A.index_select(0, ch.rows) * b).sum(-1)
        valid = ch.vals > 0
        log_term = torch.where(valid, ch.vals * torch.log(pred), 0.0)
        w = torch.where(valid, ch.vals / torch.clamp_min(pred, PRED_EPS),
                        0.0)
        _add_rows(neg_llk, log_term, ch, -1.0)
        _add_rows(grad, w[:, None] * b, ch, -1.0)
        px[ch.start:ch.stop] = pred
    return neg_llk, grad, px


def poisson_f_data(A, B, X, nnz_chunk: Optional[int] = None):
    """Only the per-row ``- sum x log(pred)`` term, unfloored (+inf at a
    non-positive prediction, the reference's poisoned trial)."""
    out = A.new_zeros(X.n_rows_pad)
    for ch in _chunks(X, nnz_chunk):
        pred = (A.index_select(0, ch.rows)
                * B.index_select(0, ch.cols)).sum(-1)
        log_term = torch.where(ch.vals > 0, ch.vals * torch.log(pred), 0.0)
        _add_rows(out, log_term, ch, -1.0)
    return out


def poisson_bdot(D, B, X) -> torch.Tensor:
    """Per-entry ``<B_col(e), d_row(e)>`` for a search direction D
    [R_pad, k], once per line search."""
    return (D.index_select(0, X.rows_safe)
            * B.index_select(0, X.col_ids)).sum(-1)


def _nll_gud(pred, vals, bd, valid):
    """A chunk's per-entry log terms and g.d ratios at a trial whose
    predictions are ``pred``."""
    log_term = torch.where(valid, vals * torch.log(pred), 0.0)
    ratio = torch.where(valid, vals * bd / torch.clamp_min(pred, PRED_EPS),
                        0.0)
    return log_term, ratio


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


def combine_f_ray(nll, alpha, coef, l2_reg, w_mult, l2_in_f: bool = True):
    """f-only tail of :func:`combine_f_gtd_ray` (CG trials test only f;
    the CG objective keeps the l2 penalty in f)."""
    bx, bdl, xx, xd, dd = coef
    if w_mult != 1.0:
        nll = w_mult * nll
    lin = bx + alpha * bdl
    if l2_in_f:
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


def _lin_terms(A, Bsum):
    """(<Bsum, a_r> per row, the gradient's linear term)."""
    if Bsum.dim() == 1:
        return A @ Bsum, Bsum[None, :]
    return (A * Bsum).sum(-1), Bsum


def poisson_f_gtd(A_trial, D, bd, B, X, Bsum, l2_reg: float,
                  w_mult: float = 1.0, nnz_chunk: Optional[int] = None,
                  l2_in_f: bool = True):
    """(f, g(trial).d) per row in one pass over the stream, with the
    per-entry ``<B, d>`` (``bd``) from :func:`poisson_bdot`; f keeps the
    +inf poisoning, the derivative a floored prediction."""
    nll = A_trial.new_zeros(X.n_rows_pad)
    gud = A_trial.new_zeros(X.n_rows_pad)
    for ch in _chunks(X, nnz_chunk):
        pred = (A_trial.index_select(0, ch.rows)
                * B.index_select(0, ch.cols)).sum(-1)
        log_term, ratio = _nll_gud(pred, ch.vals, bd[ch.start:ch.stop],
                                   ch.vals > 0)
        _add_rows(nll, log_term, ch, -1.0)
        _add_rows(gud, ratio, ch)
    return combine_f_gtd(nll, gud, A_trial, D, Bsum, l2_reg, w_mult,
                         l2_in_f)


def poisson_f_gtd_multi(alphas, x, D, bd, B, X, Bsum, l2_reg: float,
                        w_mult: float = 1.0, nnz_chunk: Optional[int] = None,
                        l2_in_f: bool = True):
    """(f, g(trial).d) at C projected trials ``max(0, x + alphas[c] d)``
    in one pass: the x, D and B gathers are shared by the candidates.
    ``alphas`` [C, R_pad] -> (f [C, R_pad], gtd [C, R_pad]).  No solver
    calls it (the JAX package keeps it for tests and reference)."""
    R, C = X.n_rows_pad, alphas.shape[0]
    nll = x.new_zeros((C, R))
    gud = x.new_zeros((C, R))
    for ch in _chunks(X, nnz_chunk):
        Xg, Dg = x.index_select(0, ch.rows), D.index_select(0, ch.rows)
        Bg = B.index_select(0, ch.cols)
        valid = ch.vals > 0
        for c in range(C):
            a_e = alphas[c].index_select(0, ch.rows)
            pred = (torch.clamp_min(Xg + a_e[:, None] * Dg, 0.0) * Bg).sum(1)
            log_term, ratio = _nll_gud(pred, ch.vals, bd[ch.start:ch.stop],
                                       valid)
            _add_rows(nll[c], log_term, ch, -1.0)
            _add_rows(gud[c], ratio, ch)
    fs, gs = [], []
    for c in range(C):
        trial = torch.clamp_min(x + alphas[c][:, None] * D, 0.0)
        f_c, g_c = combine_f_gtd(nll[c], gud[c], trial, D, Bsum, l2_reg,
                                 w_mult, l2_in_f)
        fs.append(f_c)
        gs.append(g_c)
    return torch.stack(fs), torch.stack(gs)


def _ray_terms(alphas, px, bd, X, nnz_chunk, want_gud: bool):
    """Per-row nll (and g.d ratio sums) at C ray trials ``px + alphas[c]
    bd`` from the cached per-entry predictions: [C, R_pad] each."""
    R, C = X.n_rows_pad, alphas.shape[0]
    nll = alphas.new_zeros((C, R))
    gud = alphas.new_zeros((C, R)) if want_gud else None
    for ch in _chunks(X, nnz_chunk):
        valid = ch.vals > 0
        px_c, bd_c = px[ch.start:ch.stop], bd[ch.start:ch.stop]
        for c in range(C):
            pred = px_c + alphas[c].index_select(0, ch.rows) * bd_c
            if want_gud:
                log_term, ratio = _nll_gud(pred, ch.vals, bd_c, valid)
                _add_rows(gud[c], ratio, ch)
            else:
                log_term = torch.where(valid, ch.vals * torch.log(pred), 0.0)
            _add_rows(nll[c], log_term, ch, -1.0)
    return nll, gud


def poisson_f_gtd_ray(alpha, coef, px, bd, X, l2_reg: float,
                      w_mult: float = 1.0, nnz_chunk: Optional[int] = None,
                      l2_in_f: bool = True):
    """(f, g.d) at one ray trial ``x + alpha d`` per row, from the cached
    predictions ``px`` (:func:`poisson_fgh`) and ``bd``; the linear and l2
    parts from :func:`ray_coef`'s coefficients."""
    nll, gud = _ray_terms(alpha[None], px, bd, X, nnz_chunk, True)
    return combine_f_gtd_ray(nll[0], gud[0], alpha, coef, l2_reg, w_mult,
                             l2_in_f)


def poisson_f_ray_multi(alphas, coef, px, bd, X, l2_reg: float,
                        w_mult: float = 1.0, nnz_chunk: Optional[int] = None,
                        l2_in_f: bool = True):
    """f at C ray trials per row in one pass over the cached px / bd
    streams: ``alphas`` [C, R_pad] -> f [C, R_pad]."""
    nll, _ = _ray_terms(alphas, px, bd, X, nnz_chunk, False)
    return torch.stack([
        combine_f_ray(nll[c], alphas[c], coef, l2_reg, w_mult, l2_in_f)
        for c in range(alphas.shape[0])
    ])


def poisson_f_gtd_ray_multi(alphas, coef, px, bd, X, l2_reg: float,
                            w_mult: float = 1.0,
                            nnz_chunk: Optional[int] = None,
                            l2_in_f: bool = True):
    """(f, g.d) at C ray trials per row in one pass over the cached px /
    bd streams: ``alphas`` [C, R_pad] -> (f, gtd), each [C, R_pad]."""
    nll, gud = _ray_terms(alphas, px, bd, X, nnz_chunk, True)
    return combine_f_gtd_ray(nll, gud, alphas, coef, l2_reg, w_mult,
                             l2_in_f)


def poisson_fg(A, B, X, Bsum, l2_reg: float, w_mult: float = 1.0,
               nnz_chunk: Optional[int] = None):
    """Per-row objective (l2 penalty in f), gradient and the per-entry
    predictions ``px`` (which seed the CG ray line search)."""
    neg_llk, grad_data, px = poisson_data_terms(A, B, X, nnz_chunk)
    if w_mult != 1.0:
        neg_llk = w_mult * neg_llk
        grad_data = w_mult * grad_data
    lin, g_lin = _lin_terms(A, Bsum)
    f = lin + l2_reg * (A * A).sum(-1) + neg_llk
    g = g_lin + 2.0 * l2_reg * A + grad_data
    return f, g, px


def poisson_f(A, B, X, Bsum, l2_reg: float, w_mult: float = 1.0,
              nnz_chunk: Optional[int] = None, l2_in_f: bool = True):
    """Per-row objective only; +inf for rows with a non-positive
    prediction at a positive count.  ``l2_in_f=False`` leaves the l2
    penalty out of f (the reference TNCG objective, whose gradient keeps
    it)."""
    neg_llk = poisson_f_data(A, B, X, nnz_chunk)
    if w_mult != 1.0:
        neg_llk = w_mult * neg_llk
    lin, _ = _lin_terms(A, Bsum)
    if l2_in_f:
        lin = lin + l2_reg * (A * A).sum(-1)
    return lin + neg_llk


def poisson_fgh(A, B, X, Bsum, l2_reg: float, w_mult: float = 1.0,
                nnz_chunk: Optional[int] = None, l2_in_f: bool = True):
    """Per-row objective, gradient, Hessian diagonal, and the per-entry HVP
    weights ``w2 = w_mult x / pred^2`` and predictions ``px``, from one
    SDDMM: ``(f [R], g [R, k], w2 [nnz_pad], diag [R, k], px [nnz_pad])``.
    ``l2_in_f=False`` omits the l2 penalty from f only."""
    R, k = X.n_rows_pad, A.shape[1]
    neg_llk = A.new_zeros(R)
    grad_data = A.new_zeros((R, k))
    diag_data = A.new_zeros((R, k))
    w2 = A.new_empty(X.nnz_pad)
    px = A.new_empty(X.nnz_pad)
    for ch in _chunks(X, nnz_chunk):
        b = B.index_select(0, ch.cols)
        pred = (A.index_select(0, ch.rows) * b).sum(-1)
        safe = torch.clamp_min(pred, PRED_EPS)
        valid = ch.vals > 0
        log_term = torch.where(valid, ch.vals * torch.log(safe), 0.0)
        w = torch.where(valid, ch.vals / safe, 0.0)
        w2_c = torch.where(valid, w_mult * ch.vals / (safe * safe), 0.0)
        _add_rows(neg_llk, log_term, ch, -1.0)
        _add_rows(grad_data, (-w)[:, None] * b, ch)
        _add_rows(diag_data, w2_c[:, None] * (b * b), ch)
        w2[ch.start:ch.stop] = w2_c
        px[ch.start:ch.stop] = pred
    if w_mult != 1.0:
        neg_llk = w_mult * neg_llk
        grad_data = w_mult * grad_data
    lin, g_lin = _lin_terms(A, Bsum)
    if l2_in_f:
        lin = lin + l2_reg * (A * A).sum(-1)
    f = lin + neg_llk
    g = g_lin + 2.0 * l2_reg * A + grad_data
    diag = 2.0 * l2_reg + diag_data
    return f, g, w2, diag, px


def poisson_hvp_weights(A, B, X, w_mult: float = 1.0) -> torch.Tensor:
    """``w2[e] = w_mult x_e / pred_e^2`` at a fixed iterate A."""
    pred = sddmm(A, B, X.rows_safe, X.col_ids)
    safe = torch.clamp_min(pred, PRED_EPS)
    return torch.where(X.vals > 0, w_mult * X.vals / (safe * safe), 0.0)


def poisson_hvp(V, B, X, w2, l2_reg: float,
                nnz_chunk: Optional[int] = None) -> torch.Tensor:
    """Exact Hessian-vector products, per row ``2 l2 v_r + sum_i w2_ri
    <B_i, v_r> B_i``, with the cached weights ``w2``."""
    data = V.new_zeros((X.n_rows_pad, V.shape[1]))
    for ch in _chunks(X, nnz_chunk):
        b = B.index_select(0, ch.cols)
        bv = (V.index_select(0, ch.rows) * b).sum(-1)
        _add_rows(data, (w2[ch.start:ch.stop] * bv)[:, None] * b, ch)
    return 2.0 * l2_reg * V + data


def poisson_hess_diag(B, X, w2, l2_reg: float,
                      nnz_chunk: Optional[int] = None) -> torch.Tensor:
    """Per-row Hessian diagonal ``2 l2 + sum_i w2_ri B_i^2``: [R_pad, k]."""
    data = B.new_zeros((X.n_rows_pad, B.shape[1]))
    for ch in _chunks(X, nnz_chunk):
        b = B.index_select(0, ch.cols)
        _add_rows(data, w2[ch.start:ch.stop][:, None] * (b * b), ch)
    return 2.0 * l2_reg + data


def adjusted_bsum(B, Bsum, X, w_mult: float) -> torch.Tensor:
    """Per-row weighted Bsum ``Bsum + (w_mult - 1) sum_{i in nnz(r)} B_i``
    (the reference's adjustment_Bsum): [R_pad, k]."""
    ones = torch.where(X.vals > 0, torch.ones_like(X.vals), 0.0)
    return Bsum[None, :] + (w_mult - 1.0) * spmm(ones, B, X)


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
