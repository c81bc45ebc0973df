"""Batched truncated-Newton (TNCG) solver on the planar-ELL layout (PyTorch).

Counterpart of ``poismf_tpu/solvers/tncg.py`` (``_tncg_core`` and
``tncg_update_ell``); see that module for the design and the reasons
behind every rule kept here: exact Hessian-vector products, a batched
masked inner CG with the Jacobi preconditioner, the feasible-cone
handling, the ray line search with LS_CAND candidates per round capped
at the nearest bound, getptc's collapse ladder, snap-to-bound, the
convergence tests and the per-row feval budget.

The JAX package's three ``lax.while_loop``s (outer iterations, inner CG,
line-search rounds) are Python loops here over tensors masked per row;
each loop test costs one host sync (``.item()``).  Where the inner-CG cap
is small (``maxcg <= 6``), the line search's ``<B, d>`` plane is
accumulated from the HVPs' ``<B, p_i>`` planes instead of a standalone
bdot sweep.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops import ell as ell_ops
from ..ops import objective as obj

# Constants from the reference call sites (poismf.c:383-391, tnc.c:401-436)
TNC_FTOL = 1e-4  # explicit at poismf.c:388
TNC_ETA = 0.25  # CG forcing / line-search eta
LS_RMU = 1e-4  # sufficient-decrease mu
LS_EXTRAP = 4.0  # bracket growth factor while no upper bound found
MAX_LS = 16  # whole-batch line-search round cap
LS_CAND = 4  # line-search candidates per round
# Inner-CG caps up to which <B, d> is accumulated during the CG: each HVP
# round then adds ~16 B/slot against the (k*itemsize + 8) B/slot bdot
# sweep it replaces, a break-even near 6 rounds.
BD_ACCUM_MAX_CG = 6


def _maxcgit(k: int) -> int:
    # maxCGit = clamp(k/2, 1, 50)  (poismf.c:342)
    return int(min(50.0, max(1.0, k / 2.0)))


def _any(mask: torch.Tensor) -> bool:
    return bool(mask.any().item())


def tncg_update_ell(
    A_perm: torch.Tensor,
    planes,
    ell: ell_ops.EllMatrix,
    Bsum: torch.Tensor,
    *,
    l2_reg: float,
    w_mult: float = 1.0,
    maxupd: int = 750,
    reuse_prev: bool = False,
    max_outer: int = 0,
    active_mask: Optional[torch.Tensor] = None,
    l2_in_f: bool = False,
    max_cg: Optional[int] = None,
    nfeval0: Optional[torch.Tensor] = None,
    ftol: float = TNC_FTOL,
):
    """One TNCG pass over every (permuted) row of ``A_perm`` against the
    fixed side's ``planes`` (:func:`poismf_torch.ops.ell.gather_planes`).

    ``A_perm`` and a 2D ``Bsum`` are in the ELL's permuted row order.
    ``max_outer`` caps the outer iterations (0: max(4, maxupd // 3));
    ``active_mask`` restricts the solve to a subset of rows; ``nfeval0``
    carries the per-row feval budget across cascade rounds.  ``max_cg``
    overrides the inner-CG cap ``maxCGit = clamp(k/2, 1, 50)``.
    ``l2_in_f=False`` (training) omits the l2 penalty from f but not from
    the gradient, like the reference's calc_fun_and_grad.  ``ftol`` is
    the f-convergence tolerance of the outer loop and of the line search's
    collapse test (serving solves pass 0).

    Returns ``(A_new, share_unchanged, stats)``: the share of true rows
    that moved by <= 1e-4 (squared L2), and per-row ``nfeval`` /
    ``active`` with the whole-batch counters ``outer_iters``,
    ``ls_rounds``, ``hvp_rounds``, ``clip_rows`` and ``fb_rows``."""
    R, k = A_perm.shape
    dtype, dev = A_perm.dtype, A_perm.device
    maxcg = _maxcgit(k) if max_cg is None else max(1, int(max_cg))
    max_outer = max_outer if max_outer > 0 else max(4, maxupd // 3)
    track_bd = maxcg <= BD_ACCUM_MAX_CG

    eps_f = float(np.finfo(str(dtype).replace("torch.", "")).eps)
    rteps = float(np.sqrt(eps_f))
    pgtol = 1e-2 * (rteps ** 0.5)  # tnc.c:431-433 with accuracy=rteps
    xtol = rteps

    def full(v):
        return torch.full((R,), v, dtype=dtype, device=dev)

    def fgh(x):
        return ell_ops.fgh_ell(x, planes, ell, Bsum, l2_reg, w_mult,
                               l2_in_f=l2_in_f)

    has_nnz = ell.row_nnz_perm > 0
    x = torch.where(has_nnz[:, None],
                    A_perm if reuse_prev else torch.full_like(A_perm, 1e-3),
                    0.0)
    f, g, w2, diag, px = fgh(x)
    # the per-row feval budget is carried across cascade rounds (the
    # reference's per-half-update maxnfeval); each round charges its own
    # init fgh, and a row whose budget is spent never re-activates
    nfeval = (torch.ones((R,), dtype=torch.int32, device=dev)
              if nfeval0 is None else nfeval0.to(torch.int32) + 1)
    active = has_nnz & torch.isfinite(f)
    if active_mask is not None:
        active = active & active_mask
    if nfeval0 is not None:
        active = active & (nfeval < maxupd)
    stats = dict(outer_iters=0, ls_rounds=0, hvp_rounds=0,
                 clip_rows=torch.zeros((), dtype=torch.int64, device=dev),
                 fb_rows=torch.zeros((), dtype=torch.int64, device=dev))

    while stats["outer_iters"] < max_outer and _any(active):
        # --- active set & projected gradient ---
        fixed = (x <= 0.0) & (g > 0.0)
        pgrad = torch.where(fixed, 0.0, g)
        pgnorm = torch.sqrt((pgrad * pgrad).sum(1))
        pg_scaled = pgrad * (1.0 + x.abs())
        conv_pg = torch.sqrt((pg_scaled * pg_scaled).sum(1)) <= pgtol
        active = active & ~conv_pg
        inv_diag = 1.0 / torch.clamp_min(diag, 1e-12)

        # --- inner preconditioned CG for  H d = -g  on free coordinates ---
        r0norm = (pgrad * pgrad).sum(1)
        z = torch.where(fixed, 0.0, inv_diag * pgrad)
        t = dict(d=torch.zeros_like(x), r=pgrad, z=z, p=-z,
                 rz=(pgrad * z).sum(1), run=active & (r0norm > 0.0),
                 hvps=torch.zeros((R,), dtype=torch.int32, device=dev), i=0)
        if track_bd:
            t["bd"] = ell_ops.bd_zeros_ell(ell, dtype)

        def cg_step(t):
            first = t["i"] == 0
            p = torch.where(fixed, 0.0, t["p"])
            if track_bd:
                Hp, bv = ell_ops.hvp_bv_ell(p, planes, ell, w2, l2_reg)
            else:
                Hp = ell_ops.hvp_ell(p, planes, ell, w2, l2_reg)
            Hp = torch.where(fixed, 0.0, Hp)
            pHp = (t["p"] * Hp).sum(1)
            pp = (t["p"] * t["p"]).sum(1)
            # negative / tiny / non-finite curvature -> truncate
            curv_ok = ((pHp > 1e-12 * torch.clamp_min(pp, 1e-30))
                       & torch.isfinite(pHp))
            d_fb = (torch.where((~curv_ok & t["run"])[:, None], t["p"],
                                t["d"]) if first else t["d"])
            alpha = torch.where(
                curv_ok, t["rz"] / torch.where(curv_ok, pHp, 1.0), 0.0
            )
            step = (t["run"] & curv_ok)[:, None]
            r_new = torch.where(step, t["r"] + alpha[:, None] * Hp, t["r"])
            z_new = torch.where(fixed, 0.0, inv_diag * r_new)
            rz_new = (r_new * z_new).sum(1)
            beta = rz_new / torch.where(t["rz"] > 0, t["rz"], 1.0)
            out = dict(
                d=torch.where(step, t["d"] + alpha[:, None] * t["p"], d_fb),
                r=r_new, z=z_new, rz=rz_new,
                p=torch.where(step, -z_new + beta[:, None] * t["p"], t["p"]),
                run=(t["run"] & curv_ok
                     & ((r_new * r_new).sum(1) > TNC_ETA ** 2 * r0norm)),
                hvps=t["hvps"] + t["run"].to(torch.int32), i=t["i"] + 1,
            )
            if track_bd:
                # d_new - d_old = m * p: m = alpha on a curvature step, 1 on
                # the first-iteration truncation fallback, else 0
                m = torch.where(t["run"] & curv_ok, alpha, 0.0)
                if first:
                    m = torch.where(t["run"] & ~curv_ok, 1.0, m)
                out["bd"] = ell_ops.bd_axpy_ell(t["bd"], m, bv, ell)
            return out

        if track_bd:
            # iteration 0 unrolled: (d1, bd1) is the safe replacement
            # direction (it never leaves the feasible cone)
            t = cg_step(t)
            d1, bd1 = t["d"], t["bd"]
        while t["i"] < maxcg and _any(t["run"]):
            t = cg_step(t)

        if track_bd:
            # rows whose full CG direction leaves the cone or is junk /
            # ascent revert to d1, whose bd1 plane is already accumulated
            d_cg = torch.where(fixed, 0.0, t["d"])
            clipped = ((x <= 0.0) & (d_cg < 0.0)).any(1)
            gtd_cg = (g * d_cg).sum(1)
            bad = ((~torch.isfinite(gtd_cg)) | (gtd_cg >= 0.0)
                   | ((d_cg * d_cg).sum(1) <= 0.0))
            use_d1 = (clipped | bad) & active
            d = torch.where(use_d1[:, None], d1, d_cg)
            bd = ell_ops.bd_select_ell(use_d1, bd1, t["bd"], ell)
            gtd = (g * d).sum(1)
            dnorm = (d * d).sum(1)
            # rows whose d1 is also degenerate have no search direction
            dead = (~torch.isfinite(gtd)) | (gtd >= 0.0) | (dnorm <= 0.0)
            bad = bad | dead
            d = torch.where(dead[:, None], 0.0, d)
            gtd = torch.where(dead, 0.0, gtd)
            dnorm = torch.where(dead, 0.0, dnorm)
            search = active & ~dead
        else:
            d = torch.where(fixed, 0.0, t["d"])
            # project the direction into the feasible cone
            outward = (x <= 0.0) & (d < 0.0)
            clipped = outward.any(1)
            d = torch.where(outward, 0.0, d)
            # fall back to steepest descent if CG returned junk or ascent
            gtd = (g * d).sum(1)
            dnorm = (d * d).sum(1)
            bad = (~torch.isfinite(gtd)) | (gtd >= 0.0) | (dnorm <= 0.0)
            d = torch.where(bad[:, None], -pgrad, d)
            gtd = torch.where(bad, -pgnorm * pgnorm, gtd)
            search = active
            bd = ell_ops.bdot_ell(d, planes, ell)
        nfeval = nfeval + t["hvps"]

        # --- ray line search (tnc.c linearSearch/getptc), see JAX doc ---
        spe = torch.where(d < 0.0, x / torch.clamp_min(-d, 1e-30),
                          torch.inf).amin(1)
        a0 = torch.where(f > 0.0, -2.0 * f / torch.clamp_max(gtd, -1e-30),
                         full(1.0))
        a0 = torch.minimum(a0, spe)
        a0 = torch.where(torch.isfinite(a0) & (a0 > 0.0), a0, 1.0)
        coef = obj.ray_coef(x, d, Bsum)
        # getptc's own collapse tolerances (tnc.c:1714-1722)
        xnorm = torch.sqrt((x * x).sum(1))
        pnorm = torch.sqrt(dnorm) + eps_f
        tnytol = eps_f * (xnorm + 1.0) / pnorm
        ls = dict(alpha=a0, lo=full(0.0), hi=full(torch.inf), f_lo=f,
                  g_lo=gtd, f_hi=full(torch.inf), g_hi=full(0.0),
                  found=torch.zeros((R,), dtype=torch.bool, device=dev),
                  a_new=full(0.0), f_new=f, a_best=full(0.0), f_best=f,
                  reltol=rteps * (xnorm + 1.0) / pnorm,
                  abstol=eps_f * (1.0 + f.abs()) / (gtd.abs() + eps_f),
                  searching=search, nfeval=nfeval, t=0)
        while ls["t"] < MAX_LS and _any(ls["searching"]):
            cands = _ls_candidates(ls, spe)
            f_c, gu_c = ell_ops.f_gtd_ray_multi_ell(
                cands, coef, px, bd, ell, l2_reg, w_mult, l2_in_f=l2_in_f
            )
            ls = _ls_fold(ls, cands, f_c, gu_c, f, gtd, spe, tnytol, maxupd,
                          ftol)

        # Wolfe/newcon point if found, else the best simple-decrease
        # point; LSFAIL only when no trial decreased f at all
        fallback = active & ~ls["found"] & (ls["f_best"] < f)
        moved = ls["found"] | fallback
        a_sel = torch.where(ls["found"], ls["a_new"], ls["a_best"])
        x_sel = torch.clamp_min(x + a_sel[:, None] * d, 0.0)
        x_next = torch.where(moved[:, None], x_sel, x)
        # addConstraint analog (tnc.c:1076-1084): snap onto the bound
        snap_tol = 10.0 * eps_f * (1.0 + x.abs())
        x_next = torch.where(
            moved[:, None] & (d < 0.0) & (x_next <= snap_tol), 0.0, x_next
        )
        f_next = torch.where(
            ls["found"], ls["f_new"], torch.where(fallback, ls["f_best"], f)
        )

        # --- convergence tests (tnc.c:909-929) ---
        same_face = ((x_next <= 0.0) == (x <= 0.0)).all(1)
        conv_f = moved & same_face & ((f - f_next).abs() <= ftol)
        conv_x = moved & same_face & (
            torch.sqrt(((x_next - x) ** 2).sum(1)) <= xtol)
        ls_fail = active & ~moved
        budget = ls["nfeval"] >= maxupd
        stats["clip_rows"] += (active & clipped).sum()
        stats["fb_rows"] += (active & bad).sum()
        active = active & ~conv_f & ~conv_x & ~ls_fail & ~budget

        x, f = x_next, f_next
        _, g, w2, diag, px = fgh(x)
        nfeval = ls["nfeval"] + moved.to(torch.int32)
        stats["outer_iters"] += 1
        stats["ls_rounds"] += ls["t"]
        stats["hvp_rounds"] += t["i"]

    # >= 95% of true rows moved by <= 1e-4 (squared L2), poismf.c:393-403
    delta = x - torch.where(has_nnz[:, None], A_perm, 0.0)
    small = (delta * delta).sum(1) <= 1e-4
    share = int((small & has_nnz).sum().item()) / max(float(ell.n_rows), 1.0)
    stats.update(nfeval=nfeval, active=active,
                 still_active=int(active.sum().item()),
                 clip_rows=int(stats["clip_rows"].item()),
                 fb_rows=int(stats["fb_rows"].item()))
    return x, share, stats


def _ls_candidates(t, spe):
    """[LS_CAND, R] trial steps: bracketed rows take the safeguarded cubic
    (Hermite minimizer through both ends, bisection where undefined) and
    even subdivisions, or a descending geometric ladder when the bracket's
    upper end is poisoned; unbracketed rows the extrapolation ladder
    clamped at spe."""
    C = LS_CAND
    lo, hi = t["lo"], t["hi"]
    f_lo, g_lo, f_hi, g_hi = t["f_lo"], t["g_lo"], t["f_hi"], t["g_hi"]
    has_hi = torch.isfinite(hi)
    span = hi - lo
    d1 = g_lo + g_hi + 3.0 * (f_lo - f_hi) / torch.clamp_min(span, 1e-30)
    rad = d1 * d1 - g_lo * g_hi
    d2 = torch.sqrt(torch.clamp_min(rad, 0.0))
    denom = g_hi - g_lo + 2.0 * d2
    a_cubic = hi - span * (g_hi + d2 - d1) / denom
    cubic_ok = (has_hi & torch.isfinite(f_hi) & (rad >= 0.0)
                & (denom.abs() > 1e-30) & torch.isfinite(a_cubic))
    a_brack = torch.where(
        cubic_ok,
        torch.minimum(torch.maximum(a_cubic, lo + 0.1 * span),
                      hi - 0.1 * span),
        0.5 * (lo + hi),
    )
    brack = torch.stack(
        [a_brack] + [lo + span * ((j + 1.0) / C) for j in range(C - 1)]
    )
    poisoned = has_hi & ~torch.isfinite(f_hi) & (0.25 * hi > lo)
    geo = torch.stack([hi * (0.25 ** (j + 1.0)) for j in range(C)])
    brack = torch.where(poisoned[None, :], geo, brack)
    ladder = torch.stack([torch.minimum(t["alpha"] * (LS_EXTRAP ** j), spe)
                          for j in range(C)])
    return torch.where(has_hi[None, :], brack, ladder)


def _ls_fold(t, cands, f_c, gu_c, f, dginit, spe, tnytol, maxupd, ftol):
    """Fold one round's candidates into each row's search, in processing
    order: first-ok accept (bracketed rows only at the cubic candidate
    c == 0), too-far candidates shrink hi, too-short ones raise lo; then
    getptc's convergence check (tnc.c:1968-1997), batched."""
    lo, hi = t["lo"], t["hi"]
    f_lo, g_lo, f_hi, g_hi = t["f_lo"], t["g_lo"], t["f_hi"], t["g_hi"]
    acc = torch.zeros_like(t["searching"])
    a_acc = torch.zeros_like(f)
    f_acc = torch.full_like(f, torch.inf)
    a_best, f_best = t["a_best"], t["f_best"]
    nfe = t["nfeval"]
    searching0 = t["searching"]
    has_hi0 = torch.isfinite(hi)
    for c in range(LS_CAND):
        a_c, f_tc, gu_tc = cands[c], f_c[c], gu_c[c]
        usable = (searching0 & ~acc & (a_c > lo) & (a_c < hi)
                  & (nfe < maxupd))
        nfe = nfe + usable.to(torch.int32)
        suff = torch.isfinite(f_tc) & (f_tc <= f + LS_RMU * a_c * dginit)
        curv_lo = gu_tc >= TNC_ETA * dginit
        curv_hi = gu_tc <= -TNC_ETA * dginit
        wolfe = usable & suff & curv_lo & curv_hi
        newcon = usable & suff & (a_c >= spe * (1.0 - 1e-6)) & ~curv_lo
        ok = (wolfe & (~has_hi0 | (c == 0))) | newcon
        take = ok & ~acc
        a_acc = torch.where(take, a_c, a_acc)
        f_acc = torch.where(take, f_tc, f_acc)
        acc = acc | ok
        better = usable & torch.isfinite(f_tc) & (f_tc < f_best)
        a_best = torch.where(better, a_c, a_best)
        f_best = torch.where(better, f_tc, f_best)
        to_hi = usable & ~ok & (~suff | ~curv_hi)
        to_lo = usable & ~ok & suff & ~curv_lo & curv_hi
        hi = torch.where(to_hi, a_c, hi)
        f_hi = torch.where(to_hi, f_tc, f_hi)
        g_hi = torch.where(to_hi, gu_tc, g_hi)
        lo = torch.where(to_lo, a_c, lo)
        f_lo = torch.where(to_lo, f_tc, f_lo)
        g_lo = torch.where(to_lo, gu_tc, g_lo)

    searching = searching0 & ~acc & (nfe < maxupd)
    has_hi = torch.isfinite(hi)
    reltol, abstol = t["reltol"], t["abstol"]
    tol = reltol * lo + abstol
    collapse = has_hi & ((hi - lo) <= 2.0 * tol)
    improved = f_best < f
    fw_gap = torch.where(torch.isfinite(f_hi), (f - f_hi).abs(), torch.inf)
    dead_ok = collapse & improved
    shrinkable = collapse & ~improved
    dead_fail = shrinkable & (fw_gap <= ftol)
    cont = shrinkable & ~dead_fail
    too_tiny = 0.1 * tol < tnytol
    dead_fail = dead_fail | (cont & too_tiny)
    cont = cont & ~too_tiny
    searching = searching & ~(dead_ok | dead_fail)
    return dict(
        alpha=torch.where(
            searching & ~has_hi,
            torch.minimum(t["alpha"] * (LS_EXTRAP ** LS_CAND), spe),
            t["alpha"],
        ),
        lo=lo, hi=hi, f_lo=f_lo, g_lo=g_lo, f_hi=f_hi, g_hi=g_hi,
        found=t["found"] | acc,
        a_new=torch.where(acc, a_acc, t["a_new"]),
        f_new=torch.where(acc, f_acc, t["f_new"]),
        a_best=a_best, f_best=f_best, searching=searching,
        reltol=torch.where(cont, 0.1 * reltol, reltol),
        abstol=torch.where(cont, 0.1 * abstol, abstol),
        nfeval=nfe, t=t["t"] + 1,
    )
