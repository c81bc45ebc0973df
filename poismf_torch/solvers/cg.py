"""Batched non-negative conjugate gradient (Li 2013 modified PRP) on the
planar-ELL layout (PyTorch).

Counterpart of ``poismf_tpu/solvers/cg.py`` (``_cg_core`` and
``cg_update_ell``); see that module for the design and the reasons
behind every rule kept here.  All rows iterate together under per-row
masks: the capped direction, the PRP beta / theta corrections on the free
coordinates, the ``|<g, d>| <= tol`` stop, the step cap (with
``limit_step`` at most the first zero crossing, else 0.99 times the
largest one), and the Armijo backtracking with the reference's feval
accounting (the initial evaluation counts one, each rejected trial one).

Two line-search modes:

* ray (the default, needs ``limit_step``): predictions are linear in the
  factor vector, so along the search ray ``pred(x + a*d) = px + a*<B, d>``
  with ``px`` from the last full evaluation and ``<B, d>`` computed once
  per line search; each round scores the next ``CG_RAY_CAND`` steps of
  the fixed backtracking sequence from those planes (the first round
  also alpha = 0, the Armijo test's base f, so that trials and base are
  one sum in one order), and one full evaluation at the accepted point
  closes the iteration.
* fused (``use_ray=False``): each trial is one full (f, g) evaluation,
  and the accepted trial's gradient is the next iteration's.

The JAX package's ``lax.while_loop``s are Python loops here; each loop
test is one host sync.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import ell as ell_ops
from ..ops import objective as obj

EPS_LIMIT = 1e-15  # nonnegcg.c:94 clamp threshold under limit_step
CG_TOL = 1e-2
CG_MAXNFEVAL = 150
CG_DECR = 0.25
CG_LNSRCH_C = 0.01
CG_MAX_LS = 20
CG_RAY_CAND = 4  # candidates per ray-trial round


def _any(mask: torch.Tensor) -> bool:
    return bool(mask.any().item())


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
    use_ray: Optional[bool] = None,
) -> torch.Tensor:
    """Up to ``maxupd`` batched CG iterations on every (permuted) row of
    ``A_perm`` against the fixed side's ``planes``
    (:func:`poismf_torch.ops.ell.gather_planes`).  ``use_ray`` selects
    the cached-plane ray line search (default: whenever ``limit_step``
    keeps the ray exact).  Rows without nonzeros come back zero."""
    if use_ray is None:
        use_ray = limit_step
    if use_ray and not limit_step:
        # without the step cap a trial clips against the bounds mid-ray
        # and px + a*<B,d> is no longer its prediction
        raise ValueError("ray trials require limit_step (no bound crossing)")
    R, k = A_perm.shape
    dtype, dev = A_perm.dtype, A_perm.device

    def fg(x):
        return ell_ops.fg_ell(x, planes, ell, Bsum, l2_reg, w_mult,
                              want_px=use_ray)

    has_nnz = ell.row_nnz_perm > 0
    x = torch.where(has_nnz[:, None], A_perm, 0.0)
    f, g, px = fg(x)
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
    while it < maxupd and _any(active):
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
            bd = ell_ops.bdot_ell(d, planes, ell)  # one plane pass per search
            coef = obj.ray_coef(x, d, Bsum)
            a_new = torch.zeros((R,), dtype=dtype, device=dev)
            # each round scores the next CG_RAY_CAND steps of the fixed
            # sequence {max_step * CG_DECR^j}; the accepted trial and the
            # rejected-trial accounting are the reference's
            # (nonnegcg.c:290-327)
            n_rounds = -(-CG_MAX_LS // CG_RAY_CAND)
            while ls < n_rounds and _any(searching):
                cand = step[None, :] * decays[:, None]  # [CAND, R]
                if ls == 0:
                    # the Armijo test's base f from the same sum as the
                    # trials' (a leading candidate at alpha = 0): fg's f
                    # sums a row's terms in another order on the card, and
                    # near the optimum that rounding rejects every step
                    f_c = ell_ops.f_ray_multi_ell(
                        torch.cat([torch.zeros_like(cand[:1]), cand]), coef,
                        px, bd, ell, l2_reg, w_mult)
                    f_base, f_c = f_c[0], f_c[1:]
                else:
                    f_c = ell_ops.f_ray_multi_ell(cand, coef, px, bd, ell,
                                                  l2_reg, w_mult)
                # a candidate may be evaluated only while the feval budget
                # and the CG_MAX_LS trial cap allow it: both advance one
                # per prior rejection
                allowed = ((nfe[None, :] + j_ar < CG_MAXNFEVAL)
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
                # rejections this round: those before an acceptance, every
                # allowed candidate otherwise
                n_allowed = allowed.to(torch.int32).sum(0, dtype=torch.int32)
                rej = torch.where(accept, j_star,
                                  torch.where(searching, n_allowed, 0))
                nfe = nfe + rej.to(torch.int32)
                searching = (searching & ~any_ok & (nfe < CG_MAXNFEVAL)
                             & ((ls + 1) * CG_RAY_CAND < CG_MAX_LS))
                step = torch.where(searching, step * CG_DECR ** CG_RAY_CAND,
                                   step)
                a_new = torch.where(accept, a_acc, a_new)
                ls += 1
            # the accepted point from its step, with the in-loop trial's
            # EPS_LIMIT cleanup; one full evaluation there writes next px
            x_sel = x + a_new[:, None] * d
            x_sel = torch.where(x_sel >= EPS_LIMIT, x_sel, 0.0)
            x_next = torch.where(found[:, None], x_sel, x)
            f_next, g_next, px = fg(x_next)
        else:
            x_new, f_new, g_new = x, f, g
            while ls < CG_MAX_LS and _any(searching):
                trial = x + step[:, None] * d
                if limit_step:
                    trial = torch.where(trial >= EPS_LIMIT, trial, 0.0)
                else:
                    trial = torch.clamp_min(trial, 0.0)
                # the trial's f decides acceptance; its g (floored weights,
                # finite even where f poisons) is kept on acceptance
                f_trial, g_trial, _ = fg(trial)
                ok = (torch.isfinite(f_trial)
                      & (f_trial <= f - CG_LNSRCH_C * step * dnorm_sq))
                accept = searching & ok
                found = found | accept
                rejected = searching & ~ok
                nfe = nfe + rejected.to(torch.int32)
                searching = rejected & (nfe < CG_MAXNFEVAL)
                step = torch.where(rejected, step * CG_DECR, step)
                x_new = torch.where(accept[:, None], trial, x_new)
                f_new = torch.where(accept, f_trial, f_new)
                g_new = torch.where(accept[:, None], g_trial, g_new)
                ls += 1
            x_next = torch.where(found[:, None], x_new, x)
            f_next = torch.where(found, f_new, f)
            g_next = torch.where(found[:, None], g_new, g)
        # rows that ran out of the feval budget terminate (stop_maxnfeval)
        active = active & (nfe < CG_MAXNFEVAL)

        grad_prev, dir_prev = g, d
        gnorm_prev = torch.clamp_min((g * g).sum(1), 1e-30)
        x, f, g, nfeval = x_next, f_next, g_next, nfe
        it += 1
    return x
