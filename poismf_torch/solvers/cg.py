"""Batched non-negative conjugate gradient (Li 2013 modified PRP)
(PyTorch), on the planar-ELL layout and on the flat COO.

Counterpart of ``poismf_tpu/solvers/cg.py`` (``_cg_core``,
``cg_update_ell`` and ``cg_update``: one driver, :func:`_cg_core`, fed
the ELL's evaluators or the flat COO's); see that module for the design
and the reasons behind every rule kept here.  All rows iterate together under per-row
masks: the capped direction, the PRP beta / theta corrections on the free
coordinates, the ``|<g, d>| <= tol`` stop, the step cap (with
``limit_step`` at most the first zero crossing, else 0.99 times the
largest one), and the Armijo backtracking with the reference's feval
accounting (the initial evaluation counts one, each rejected trial one,
up to ``maxnfeval``).

Two line-search modes:

* ray (the default, needs ``limit_step``): predictions are linear in the
  factor vector, so along the search ray ``pred(x + a*d) = px + a*<B, d>``
  with ``px`` from the last full evaluation and ``<B, d>`` computed once
  per line search; each round scores the next ``CG_RAY_CAND`` steps of
  the fixed backtracking sequence from those planes or streams (the
  first round also alpha = 0, the Armijo test's base f, so that trials
  and base are one sum in one order), and one full evaluation at the
  accepted point closes the iteration.
* fused (``use_ray=False``, or by default under ``POISMF_CG_RAY=0``, read
  per call): each trial is one full (f, g) evaluation, and the accepted
  trial's gradient is the next iteration's.

``return_passes`` adds the solver's full-sweep count, the JAX package's
(each evaluation weighted by the bytes it reads against a full sweep's,
summed in float32 on the host from the loop counters).

The JAX package's ``lax.while_loop``s are Python loops here; each loop
test is one host sync (``profiling.host``, counted by site when
recording).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops import ell as ell_ops
from ..ops import objective as obj
from ..utils import profiling

EPS_LIMIT = 1e-15  # nonnegcg.c:94 clamp threshold under limit_step
CG_TOL = 1e-2
CG_MAXNFEVAL = 150
CG_DECR = 0.25
CG_LNSRCH_C = 0.01
CG_MAX_LS = 20
CG_RAY_CAND = 4  # candidates per ray-trial round


def _cg_ray_default() -> bool:
    return os.environ.get("POISMF_CG_RAY", "1") != "0"


def cg_update_ell(
    A_perm: torch.Tensor,
    planes,
    ell: ell_ops.EllMatrix,
    Bsum: torch.Tensor,
    *,
    l2_reg: float,
    w_mult: float = 1.0,
    maxupd: int = 5,
    limit_step: bool = True,
    maxnfeval: int = CG_MAXNFEVAL,
    return_passes: bool = False,
    use_ray: Optional[bool] = None,
    init=None,
):
    """Up to ``maxupd`` batched CG iterations on every (permuted) row of
    ``A_perm`` against the fixed side's ``planes``
    (:func:`poismf_torch.ops.ell.gather_planes`).  ``use_ray`` selects
    the cached-plane ray line search (default: whenever ``limit_step``
    keeps the ray exact, unless ``POISMF_CG_RAY=0``).  ``init`` is
    ``(f0, g0, px0)`` at the entry point from :func:`cg_probe_ell` (ray
    mode only): it replaces the solver's first evaluation, whose sweep
    the caller counts.  ``maxnfeval`` is each row's evaluation budget.
    Rows without nonzeros come back zero.  Returns the new rows, and with
    ``return_passes`` also the solver's full-sweep count."""
    use_ray = _use_ray(use_ray, limit_step)
    if init is not None and not use_ray:
        raise ValueError("init carries px planes: ray mode only")
    has_nnz = ell.row_nnz_perm > 0
    # sweep weights (the JAX package's): a full sweep reads k * itemsize
    # + 4 (vals) bytes a slot, a ray round px / pd / vals, fg also writes
    # the px plane
    it = planes[0].dtype.itemsize if planes else A_perm.dtype.itemsize
    full_b = float(A_perm.shape[1] * it + 4)
    with profiling.span("solver.cg"):
        x, passes = _cg_core(
            torch.where(has_nnz[:, None], A_perm, 0.0), has_nnz,
            lambda x: ell_ops.fg_ell(x, planes, ell, Bsum, l2_reg, w_mult,
                                     want_px=use_ray),
            lambda cand, coef, px, bd: ell_ops.f_ray_multi_ell(
                cand, coef, px, bd, ell, l2_reg, w_mult),
            lambda d: ell_ops.bdot_ell(d, planes, ell),
            lambda x, d: obj.ray_coef(x, d, Bsum),
            maxupd=maxupd, limit_step=limit_step, use_ray=use_ray,
            init=init, maxnfeval=maxnfeval, trial_frac=12.0 / full_b,
            fg_weight=1.0 + 4.0 / full_b)
    return (x, passes) if return_passes else x


def cg_probe_ell(A_perm, planes, ell: ell_ops.EllMatrix, Bsum,
                 l2_reg: float, w_mult: float = 1.0):
    """The entry probe of cg's compaction: one (f, g, px) sweep at
    ``A_perm``, which is the solver's own init (``cg_update_ell(...,
    init=...)``), and the rows that would iterate at all: those with
    nonzeros, a finite f, and not already stopped by ``|<g, d>| <= tol``
    for the capped entry direction.  Returns (f0, g0, px0, active)."""
    with profiling.span("solver.cg_probe"):
        f0, g0, px0 = ell_ops.fg_ell(A_perm, planes, ell, Bsum, l2_reg,
                                     w_mult)
        has_nnz = ell.row_nnz_perm > 0
        x0 = torch.where(has_nnz[:, None], A_perm, 0.0)
        d = torch.where((x0 <= 0.0) & (g0 >= 0.0), 0.0, -g0)
        conv = (g0 * d).sum(1).abs() <= CG_TOL
        return f0, g0, px0, has_nnz & torch.isfinite(f0) & ~conv


def cg_update(
    A: torch.Tensor,
    B: torch.Tensor,
    X,
    Bsum: torch.Tensor,
    *,
    l2_reg: float,
    w_mult: float = 1.0,
    maxupd: int = 5,
    limit_step: bool = True,
    nnz_chunk: Optional[int] = None,
    maxnfeval: int = CG_MAXNFEVAL,
    return_passes: bool = False,
    use_ray: Optional[bool] = None,
):
    """Up to ``maxupd`` batched CG iterations on every row of ``A``
    against ``B`` on the flat COO ``X`` (a
    :class:`~poismf_torch.sparse.DeviceCounts`), the JAX package's
    ``cg_update``; ``nnz_chunk`` walks the stream in chunks, the rest as
    in :func:`cg_update_ell`."""
    use_ray = _use_ray(use_ray, limit_step)
    has_nnz = X.row_nnz > 0
    # sweep weights (the JAX package's): a full COO sweep streams rows,
    # cols and vals (12 B an entry) and gathers B's k-vector; a ray round
    # streams rows, vals, px and bd; fg also writes px
    full_b = 4.0 * A.shape[1] + 12.0
    with profiling.span("solver.cg"):
        x, passes = _cg_core(
            torch.where(has_nnz[:, None], A, 0.0), has_nnz,
            lambda x: obj.poisson_fg(x, B, X, Bsum, l2_reg, w_mult,
                                     nnz_chunk),
            lambda cand, coef, px, bd: obj.poisson_f_ray_multi(
                cand, coef, px, bd, X, l2_reg, w_mult, nnz_chunk),
            lambda d: obj.poisson_bdot(d, B, X),
            lambda x, d: obj.ray_coef(x, d, Bsum),
            maxupd=maxupd, limit_step=limit_step, use_ray=use_ray,
            maxnfeval=maxnfeval, trial_frac=16.0 / full_b,
            fg_weight=1.0 + 4.0 / full_b)
    return (x, passes) if return_passes else x


def _use_ray(use_ray: Optional[bool], limit_step: bool) -> bool:
    if use_ray is None:
        return limit_step and _cg_ray_default()
    if use_ray and not limit_step:
        # without the step cap a trial clips against the bounds mid-ray
        # and px + a*<B,d> is no longer its prediction
        raise ValueError("ray trials require limit_step (no bound crossing)")
    return bool(use_ray)


def _cg_core(x, has_nnz, fg, f_ray, bdot, ray_coef_fn, *, maxupd: int,
             limit_step: bool, use_ray: bool, init=None,
             maxnfeval: int = CG_MAXNFEVAL, trial_frac: float = 1.0,
             fg_weight: float = 1.0):
    """The layout-agnostic batched CG driver (the JAX package's
    ``_cg_core``), from the start ``x`` (rows without nonzeros zero) with
    the layout's evaluators: ``fg(x) -> (f, g, px)`` (px may be None
    outside the ray mode), ``f_ray(alphas, coef, px, bd) -> f`` at C ray
    trials, ``bdot(d) -> bd`` and ``ray_coef_fn(x, d)``; ``init``, when
    given, is ``fg``'s value at ``x``.  Returns (x, passes): the full
    sweeps, ``fg_weight`` an fg of the ray mode (none for ``init``),
    ``trial_frac`` a ray round, one a bdot; one a fused trial."""
    R, k = x.shape
    dtype, dev = x.dtype, x.device
    f32 = np.float32
    f, g, px = fg(x) if init is None else init
    passes = f32(0.0 if init is not None else fg_weight if use_ray else 1.0)
    nfeval = torch.ones((R,), dtype=torch.int32, device=dev)
    # rows with a nan/inf initial objective terminate at once
    # (nonnegcg.c:223-226); rows without nonzeros are done (zero) already
    active = has_nnz & torch.isfinite(f)
    grad_prev = torch.zeros_like(x)
    dir_prev = torch.zeros_like(x)
    gnorm_prev = torch.ones((R,), dtype=dtype, device=dev)
    if use_ray:
        decays = CG_DECR ** torch.arange(CG_RAY_CAND, dtype=dtype,
                                         device=dev)
        j_ar = torch.arange(CG_RAY_CAND, dtype=torch.int32,
                            device=dev)[:, None]

    it = 0
    while it < maxupd and profiling.host_any(active, "solver.cg.outer"):
        nonpos = x <= 0.0
        d = torch.where(nonpos & (g >= 0.0), 0.0, -g)
        if it > 0:
            free = ~nonpos
            dg = g - grad_prev
            theta = torch.where(free, g * dir_prev, 0.0).sum(1) / gnorm_prev
            beta = torch.where(free, g * dg, 0.0).sum(1) / gnorm_prev
            corr = beta[:, None] * dir_prev - theta[:, None] * dg
            d = d + torch.where(free, corr, 0.0)

        converged_now = (g * d).sum(1).abs() <= CG_TOL
        active = active & ~converged_now

        # maximum step per row
        neg = d < 0.0
        ratios = torch.where(neg, -x / torch.where(neg, d, -1.0), 0.0)
        if limit_step:
            cap = torch.where(neg, ratios, torch.inf).amin(1)
            max_step = torch.clamp_max(cap, 1.0)
        else:
            cap = torch.where(neg, ratios, 0.0).amax(1)
            max_step = torch.clamp_max(0.99 * cap, 1.0)
        dnorm_sq = (d * d).sum(1)

        # ---- batched backtracking line search ----
        step = max_step
        found = torch.zeros((R,), dtype=torch.bool, device=dev)
        searching = active
        nfe = nfeval
        ls = 0
        if use_ray:
            bd = bdot(d)  # one pass over the planes / stream per search
            coef = ray_coef_fn(x, d)
            a_new = torch.zeros((R,), dtype=dtype, device=dev)
            # each round scores the next CG_RAY_CAND steps of the fixed
            # sequence {max_step * CG_DECR^j}; the accepted trial and the
            # rejected-trial accounting are the reference's
            # (nonnegcg.c:290-327)
            n_rounds = -(-CG_MAX_LS // CG_RAY_CAND)
            with profiling.span("solver.cg.ls"):
                while ls < n_rounds and profiling.host_any(
                        searching, "solver.cg.ls"):
                    cand = step[None, :] * decays[:, None]  # [CAND, R]
                    if ls == 0:
                        # the Armijo test's base f from the same sum as
                        # the trials' (a leading candidate at alpha = 0):
                        # fg's f sums a row's terms in another order on the
                        # card, and near the optimum that rounding rejects
                        # every step
                        f_c = f_ray(torch.cat([torch.zeros_like(cand[:1]),
                                               cand]), coef, px, bd)
                        f_base, f_c = f_c[0], f_c[1:]
                    else:
                        f_c = f_ray(cand, coef, px, bd)
                    # a candidate may be evaluated only while the feval
                    # budget and the CG_MAX_LS trial cap allow it: both
                    # advance one per prior rejection
                    allowed = ((nfe[None, :] + j_ar < maxnfeval)
                               & (ls * CG_RAY_CAND + j_ar < CG_MAX_LS))
                    ok_c = (torch.isfinite(f_c)
                            & (f_c <= f_base[None] - CG_LNSRCH_C * cand
                               * dnorm_sq[None])
                            & allowed)
                    any_ok = ok_c.any(0)
                    # first accepted j (argmax returns the first maximum)
                    j_star = ok_c.to(torch.int32).argmax(0).to(torch.int32)
                    accept = searching & any_ok
                    a_acc = step * CG_DECR ** j_star.to(dtype)
                    found = found | accept
                    # rejections this round: those before an acceptance,
                    # every allowed candidate otherwise
                    n_allowed = allowed.to(torch.int32).sum(
                        0, dtype=torch.int32)
                    rej = torch.where(accept, j_star,
                                      torch.where(searching, n_allowed, 0))
                    nfe = nfe + rej.to(torch.int32)
                    searching = (searching & ~any_ok & (nfe < maxnfeval)
                                 & ((ls + 1) * CG_RAY_CAND < CG_MAX_LS))
                    step = torch.where(searching,
                                       step * CG_DECR ** CG_RAY_CAND, step)
                    a_new = torch.where(accept, a_acc, a_new)
                    ls += 1
            # the accepted point from its step, with the in-loop trial's
            # EPS_LIMIT cleanup; one full evaluation there writes next px
            x_sel = x + a_new[:, None] * d
            x_sel = torch.where(x_sel >= EPS_LIMIT, x_sel, 0.0)
            x_next = torch.where(found[:, None], x_sel, x)
            f_next, g_next, px = fg(x_next)
            passes = (passes + f32(1.0) + f32(ls) * f32(trial_frac)
                      + f32(fg_weight))
        else:
            x_new, f_new, g_new = x, f, g
            with profiling.span("solver.cg.ls"):
                while ls < CG_MAX_LS and profiling.host_any(
                        searching, "solver.cg.ls"):
                    trial = x + step[:, None] * d
                    if limit_step:
                        trial = torch.where(trial >= EPS_LIMIT, trial, 0.0)
                    else:
                        trial = torch.clamp_min(trial, 0.0)
                    # the trial's f decides acceptance; its g (floored
                    # weights, finite even where f poisons) is kept on
                    # acceptance
                    f_trial, g_trial, _ = fg(trial)
                    ok = (torch.isfinite(f_trial)
                          & (f_trial <= f - CG_LNSRCH_C * step * dnorm_sq))
                    accept = searching & ok
                    found = found | accept
                    rejected = searching & ~ok
                    nfe = nfe + rejected.to(torch.int32)
                    searching = rejected & (nfe < maxnfeval)
                    step = torch.where(rejected, step * CG_DECR, step)
                    x_new = torch.where(accept[:, None], trial, x_new)
                    f_new = torch.where(accept, f_trial, f_new)
                    g_new = torch.where(accept[:, None], g_trial, g_new)
                    ls += 1
            x_next = torch.where(found[:, None], x_new, x)
            f_next = torch.where(found, f_new, f)
            g_next = torch.where(found[:, None], g_new, g)
            passes = passes + f32(ls)  # one fused sweep a trial
        # rows that ran out of the feval budget terminate (stop_maxnfeval)
        active = active & (nfe < maxnfeval)

        grad_prev, dir_prev = g, d
        gnorm_prev = torch.clamp_min((g * g).sum(1), 1e-30)
        x, f, g, nfeval = x_next, f_next, g_next, nfe
        it += 1
    return x, float(passes)
