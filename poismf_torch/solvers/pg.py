"""Batched proximal-gradient solver (PyTorch), on the planar-ELL layout
and on the flat COO.

Counterpart of ``poismf_tpu/solvers/pg.py`` (``pg_update``,
``_pg_steps_ell``, ``pg_update_ell`` and ``pg_epoch_ell``).  Per step,
for every row a with
nonzeros (cols, x):

    a <- max(0, (a + step * sum_i (x_i / <a, B_i>) * B_i - step * Bsum)
                 * cnst_div),   cnst_div = 1 / (1 + 2 * l2 * div_step)

with ``step = step_size * w_mult``; rows without nonzeros are zeroed.
The reference halves the step BETWEEN the B half and the A half of an
epoch (poismf.c:532) and computes ``cnst_div`` once per epoch from the B
half's step (poismf.c:511), so the A half steps at s/2 with the stale
divisor of s: :func:`pg_epoch_ell` keeps both.  The scalars are held in
the factors' dtype, as the JAX package traces them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import ell as ell_ops
from ..ops import objective as obj
from ..utils import profiling


def _step_scalars(A, Bsum, l2_reg, step_size, w_mult, div_step):
    """(step, step * Bsum, cnst_div) in ``A``'s dtype."""
    def scalar(v):
        return profiling.to_device(torch.tensor(v, dtype=A.dtype), A.device,
                                   "solver.pg.scalars")

    l2, s = scalar(l2_reg), scalar(step_size)
    ds = s if div_step is None else scalar(div_step)
    return (s * w_mult,  # poismf.c:151
            s * (Bsum[None, :] if Bsum.dim() == 1 else Bsum),
            1.0 / (1.0 + 2.0 * l2 * ds))  # poismf.c:511


def pg_update(
    A: torch.Tensor,
    B: torch.Tensor,
    X,
    Bsum: torch.Tensor,
    l2_reg: float,
    step_size: float,
    *,
    w_mult: float = 1.0,
    maxupd: int = 10,
    nnz_chunk: Optional[int] = None,
    div_step: Optional[float] = None,
) -> torch.Tensor:
    """``maxupd`` PG steps on every row of ``A`` against ``B`` on the flat
    COO ``X`` (a :class:`~poismf_torch.sparse.DeviceCounts`), the JAX
    package's ``pg_update``: each step's data term ``sum_i (x_i / pred_i)
    B_i`` walks the stream in chunks of ``nnz_chunk``; ``div_step``
    overrides the step in the proximal divisor."""
    with profiling.span("solver.pg"):
        step, step_bsum, cnst_div = _step_scalars(A, Bsum, l2_reg, step_size,
                                                  w_mult, div_step)
        for _ in range(maxupd):
            gp = A.new_zeros(A.shape)
            for ch in obj._chunks(X, nnz_chunk):
                b = B.index_select(0, ch.cols)
                pred = (A.index_select(0, ch.rows) * b).sum(-1)
                w = torch.where(ch.vals > 0,
                                ch.vals / torch.clamp_min(pred,
                                                          obj.PRED_EPS),
                                0.0)
                obj._add_rows(gp, w[:, None] * b, ch)
            A = torch.clamp_min((A + step * gp - step_bsum) * cnst_div, 0.0)
        # rows with no nonzeros are zeroed (poismf.c:166-169)
        return torch.where((X.row_nnz > 0)[:, None], A, 0.0)


def pg_update_ell(
    A_perm: torch.Tensor,
    planes,
    ell: ell_ops.EllMatrix,
    Bsum: torch.Tensor,
    l2_reg: float,
    step_size: float,
    *,
    w_mult: float = 1.0,
    maxupd: int = 10,
    div_step: Optional[float] = None,
) -> torch.Tensor:
    """``maxupd`` PG steps on every (permuted) row of ``A_perm`` against
    the fixed side's ``planes``; ``div_step`` overrides the step in the
    proximal divisor."""
    with profiling.span("solver.pg"):
        step, step_bsum, cnst_div = _step_scalars(A_perm, Bsum, l2_reg,
                                                  step_size, w_mult, div_step)
        for _ in range(maxupd):
            gp = ell_ops.pg_grad_ell(A_perm, planes, ell)
            A_perm = torch.clamp_min(
                (A_perm + step * gp - step_bsum) * cnst_div, 0.0)
        # rows with no nonzeros are zeroed (poismf.c:166-169)
        return torch.where((ell.row_nnz_perm > 0)[:, None], A_perm, 0.0)


def pg_epoch_ell(A_perm, B_perm, ell_user: ell_ops.EllMatrix,
                 ell_item: ell_ops.EllMatrix, l2_reg: float,
                 step_size: float, l1_reg: float, *, maxupd: int = 10,
                 w_mult: float = 1.0, plane_dtype=None):
    """One alternating PG epoch: the B half (colsums of A, plane gather,
    ``maxupd`` steps at ``step_size``), then the A half at
    ``step_size / 2`` with the divisor of ``step_size``.  Returns
    ``(A_perm, B_perm)``."""
    def half(target, fixed, ell, step, div_step):
        with profiling.span("ell.gather"):
            bsum = fixed.sum(0) + l1_reg
            planes = ell_ops.gather_planes(fixed, ell, plane_dtype)
            if w_mult != 1.0:
                bsum = ell_ops.adjusted_bsum_ell(planes, ell, bsum, w_mult)
        return pg_update_ell(target, planes, ell, bsum, l2_reg, step,
                             w_mult=w_mult, maxupd=maxupd, div_step=div_step)

    with profiling.span("half.items"):
        B_new = half(B_perm, A_perm, ell_item, step_size, None)
    with profiling.span("half.users"):
        A_new = half(A_perm, B_new, ell_user, step_size * 0.5, step_size)
    return A_new, B_new
