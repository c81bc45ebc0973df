"""Batched truncated-Newton (TNCG) solver (PyTorch), on the planar-ELL
layout and on the flat COO.

Counterpart of ``poismf_tpu/solvers/tncg.py`` (``_tncg_core``,
``tncg_update_ell`` and ``tncg_update``); see that module for the design
and the reasons behind every rule kept here: exact Hessian-vector
products, a batched masked inner CG with the Jacobi preconditioner, the
feasible-cone handling, the ray line search with ``ls_cand`` candidates
per round capped at the nearest bound (1: the sequential single-trial
search), getptc's collapse ladder, snap-to-bound, the convergence tests
and the per-row feval budget.

One driver, :func:`_tncg_core`, takes the layout's evaluators as
callables: :func:`tncg_update_ell` hands it the ELL's (the hand-written
kernels on the card), :func:`tncg_update` the flat COO's
(:mod:`poismf_torch.ops.objective`).  The JAX package's three
``lax.while_loop``s (outer iterations, inner CG, line-search rounds) are
Python loops here over tensors masked per row; each loop test costs one
host sync (``profiling.host``, which counts it by site when recording).
A line-search round's per-row state update (the fold of its trials, then
the next round's candidates) is one call of :func:`kernels.ls_round`,
which picks its version: one launch on float32 state on the card, the
plain round (``kernels.ls_round_torch``) on the CPU and for float64
state, bit for bit the same.  On the ELL, where the inner-CG cap is
small (``maxcg <= 6``) and ``bd_accum`` is on, the line search's ``<B,
d>`` plane is accumulated from the HVPs' ``<B, p_i>`` planes instead of a
standalone bdot sweep; the COO takes one bdot sweep a search, as the JAX
package's does.

The stats count the solver's full sweeps (``passes``) as the JAX package
counts them, each evaluation weighted by the bytes it reads against a full
sweep's; the count is kept on the host from the loop counters, in float32
as the JAX package's ``passes`` scalar, so it adds no sync and no launch.

``POISMF_TNCG_LS_CAND`` (default 4) and ``POISMF_TNCG_BD_ACCUM`` (``0``
turns the accumulation off) give ``ls_cand``'s and ``bd_accum``'s defaults,
read per call.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..kernels.ls_round import TNC_ETA
from ..ops import ell as ell_ops
from ..ops import objective as obj
from ..utils import profiling

# Constants from the reference call sites (poismf.c:383-391, tnc.c:401-436);
# TNC_ETA (the CG forcing and line-search eta) and the line search's own
# constants sit beside its round in kernels/ls_round.py.
TNC_FTOL = 1e-4  # explicit at poismf.c:388
MAX_LS = 16  # whole-batch line-search round cap
LS_CAND_DEFAULT = 4  # line-search candidates per round
# Inner-CG caps up to which <B, d> is accumulated during the CG: each HVP
# round then adds ~16 B/slot against the (k*itemsize + 8) B/slot bdot
# sweep it replaces, a break-even near 6 rounds.
BD_ACCUM_MAX_CG = 6


def _maxcgit(k: int) -> int:
    # maxCGit = clamp(k/2, 1, 50)  (poismf.c:342)
    return int(min(50.0, max(1.0, k / 2.0)))


def _ls_cand_default() -> int:
    return int(os.environ.get("POISMF_TNCG_LS_CAND", str(LS_CAND_DEFAULT)))


def _bd_accum_default() -> bool:
    return os.environ.get("POISMF_TNCG_BD_ACCUM", "1") != "0"


def _ls_cand(ls_cand: Optional[int]) -> int:
    return max(1, int(ls_cand if ls_cand is not None
                      else _ls_cand_default()))


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
    track_unchanged: bool = False,
    max_outer: int = 0,
    return_stats: bool = False,
    active_mask: Optional[torch.Tensor] = None,
    ftol: float = TNC_FTOL,
    l2_in_f: bool = False,
    max_cg: Optional[int] = None,
    ls_cand: Optional[int] = None,
    nfeval0: Optional[torch.Tensor] = None,
    bd_accum: Optional[bool] = None,
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
    collapse test (serving solves pass 0).  ``ls_cand`` is the number of
    line-search candidates a round (default ``POISMF_TNCG_LS_CAND`` or 4;
    1 is the sequential single-trial search).  ``bd_accum`` (default
    ``POISMF_TNCG_BD_ACCUM``, on) accumulates the line search's ``<B, d>``
    plane in the inner CG where ``max_cg`` is at most BD_ACCUM_MAX_CG,
    else one bdot sweep a search.  ``track_unchanged`` is accepted and
    ignored, as in the JAX package (the share is always computed).

    Returns ``(A_new, share_unchanged)``, the share of true rows that
    moved by <= 1e-4 (squared L2); with ``return_stats`` also the stats:
    per-row ``nfeval`` and ``active``, and the whole-batch ``outer_iters``,
    ``still_active``, ``passes``, ``ls_rounds``, ``hvp_rounds``,
    ``clip_rows``, ``fb_rows`` and ``dbg_search`` / ``dbg_brack`` (rows
    searching / bracketed at each line-search round of the last outer
    iteration, [MAX_LS] int32)."""
    del track_unchanged
    k = A_perm.shape[1]
    maxcg = _maxcgit(k) if max_cg is None else max(1, int(max_cg))
    bd_accum = _bd_accum_default() if bd_accum is None else bool(bd_accum)

    def fgh(x):
        return ell_ops.fgh_ell(x, planes, ell, Bsum, l2_reg, w_mult,
                               l2_in_f=l2_in_f)

    def f_gtd_ray_multi(cands, coef, px, bd):
        return ell_ops.f_gtd_ray_multi_ell(cands, coef, px, bd, ell, l2_reg,
                                           w_mult, l2_in_f=l2_in_f)

    def hvp_with(w2):
        return lambda V: ell_ops.hvp_ell(V, planes, ell, w2, l2_reg)

    # sweep weights (the JAX package's): a full sweep reads k * itemsize
    # + 4 (vals) bytes a slot, a ray round px / pd / vals, bdot the planes
    # once and writes pd, fgh also writes w2 and px
    it = planes[0].dtype.itemsize if planes else A_perm.dtype.itemsize
    full_b = float(k * it + 4)
    weights = dict(trial_frac=12.0 / full_b, fgh_weight=1.0 + 8.0 / full_b,
                   bdot_weight=1.0 + 4.0 / full_b)
    bd_fns = None
    if bd_accum and maxcg <= BD_ACCUM_MAX_CG:
        bd_fns = dict(
            hvp_bv_with=lambda w2: (
                lambda V: ell_ops.hvp_bv_ell(V, planes, ell, w2, l2_reg)),
            zeros=lambda dtype: ell_ops.bd_zeros_ell(ell, dtype),
            axpy=lambda bd, m, bv: ell_ops.bd_axpy_ell(bd, m, bv, ell),
            select=lambda u, bd1, bd: ell_ops.bd_select_ell(u, bd1, bd, ell),
        )
        # each HVP round writes bv and adds it into bd; the post-CG select
        # takes the bdot's place
        weights.update(hvp_extra=16.0 / full_b, bdot_weight=12.0 / full_b)
    has_nnz = ell.row_nnz_perm > 0
    x0 = torch.where(has_nnz[:, None],
                     A_perm if reuse_prev else torch.full_like(A_perm, 1e-3),
                     0.0)
    with profiling.span("solver.tncg"):
        return _tncg_core(
            x0, has_nnz, ell.n_rows, fgh, f_gtd_ray_multi, hvp_with,
            lambda d: ell_ops.bdot_ell(d, planes, ell),
            lambda x, d: obj.ray_coef(x, d, Bsum),
            maxupd=maxupd, max_outer=max_outer, maxcg=maxcg,
            x_prev=torch.where(has_nnz[:, None], A_perm, 0.0),
            active_mask=active_mask, nfeval0=nfeval0, ftol=ftol,
            bd_fns=bd_fns, ls_cand=_ls_cand(ls_cand),
            return_stats=return_stats, **weights,
        )


def tncg_update(
    A: torch.Tensor,
    B: torch.Tensor,
    X,
    Bsum: torch.Tensor,
    *,
    l2_reg: float,
    w_mult: float = 1.0,
    maxupd: int = 750,
    reuse_prev: bool = False,
    track_unchanged: bool = False,
    nnz_chunk: Optional[int] = None,
    max_outer: int = 0,
    return_stats: bool = False,
    ftol: float = TNC_FTOL,
    l2_in_f: bool = False,
    max_cg: Optional[int] = None,
    ls_cand: Optional[int] = None,
):
    """One TNCG pass over every row of ``A`` against ``B`` on the flat COO
    ``X`` (a :class:`~poismf_torch.sparse.DeviceCounts`), the JAX
    package's ``tncg_update``: rows with nonzeros start from 1e-3 (from
    ``A`` when ``reuse_prev``), rows without come back zero, and the
    line search's ``<B, d>`` is one :func:`~poismf_torch.ops.objective.
    poisson_bdot` sweep a search (no accumulation in the inner CG).
    ``nnz_chunk`` walks the stream in chunks; the other arguments and the
    result are those of :func:`tncg_update_ell`."""
    del track_unchanged
    k = A.shape[1]
    maxcg = _maxcgit(k) if max_cg is None else max(1, int(max_cg))

    def fgh(x):
        return obj.poisson_fgh(x, B, X, Bsum, l2_reg, w_mult, nnz_chunk,
                               l2_in_f=l2_in_f)

    def f_gtd_ray_multi(cands, coef, px, bd):
        return obj.poisson_f_gtd_ray_multi(cands, coef, px, bd, X, l2_reg,
                                           w_mult, nnz_chunk,
                                           l2_in_f=l2_in_f)

    def hvp_with(w2):
        return lambda V: obj.poisson_hvp(V, B, X, w2, l2_reg, nnz_chunk)

    # sweep weights (the JAX package's): a full COO sweep streams rows,
    # cols and vals (12 B an entry) and gathers B's k-vector; a ray round
    # streams rows, vals, px and bd
    full_b = 4.0 * k + 12.0
    has_nnz = X.row_nnz > 0
    x0 = torch.where(has_nnz[:, None],
                     A if reuse_prev else torch.full_like(A, 1e-3), 0.0)
    with profiling.span("solver.tncg"):
        return _tncg_core(
            x0, has_nnz, X.n_rows, fgh, f_gtd_ray_multi, hvp_with,
            lambda d: obj.poisson_bdot(d, B, X),
            lambda x, d: obj.ray_coef(x, d, Bsum),
            maxupd=maxupd, max_outer=max_outer, maxcg=maxcg,
            x_prev=torch.where(has_nnz[:, None], A, 0.0), ftol=ftol,
            ls_cand=_ls_cand(ls_cand), return_stats=return_stats,
            trial_frac=16.0 / full_b, fgh_weight=1.0 + 8.0 / full_b,
            bdot_weight=1.0 + 4.0 / full_b,
        )


def _tncg_core(x, has_nnz, n_rows: int, fgh, f_gtd_ray_multi, hvp_with,
               bdot, ray_coef_fn, *, maxupd: int, max_outer: int, maxcg: int,
               x_prev, active_mask=None, nfeval0=None, ftol: float = TNC_FTOL,
               bd_fns: Optional[dict] = None, ls_cand: int = LS_CAND_DEFAULT,
               return_stats: bool = False, trial_frac: float = 1.0,
               fgh_weight: float = 1.0, bdot_weight: float = 1.0,
               hvp_extra: float = 0.0):
    """The layout-agnostic batched truncated-Newton driver (the JAX
    package's ``_tncg_core``), from the start ``x`` with the layout's
    evaluators: ``fgh(x) -> (f, g, w2, diag, px)``,
    ``f_gtd_ray_multi(alphas, coef, px, bd) -> (f, g.d)`` at C ray trials,
    ``hvp_with(w2) -> (V -> HV)``, ``bdot(d) -> bd`` and
    ``ray_coef_fn(x, d)``.  ``bd_fns`` (``hvp_bv_with``, ``zeros``,
    ``axpy``, ``select``) accumulates ``<B, d>`` from the inner CG's HVPs
    instead of a bdot sweep.  ``x_prev`` is what the unchanged share is
    measured from, over the ``n_rows`` true rows.  ``ls_cand`` candidates
    a line-search round.  The weights are each evaluation's sweeps in the
    ``passes`` count: ``trial_frac`` a line-search round, ``fgh_weight``
    an fgh, ``bdot_weight`` a search's ``<B, d>``, ``1 + hvp_extra`` an
    HVP round.  Returns (x, share), and with ``return_stats`` the stats
    too, ``dbg_search`` / ``dbg_brack`` included."""
    R, k = x.shape
    dtype, dev = x.dtype, x.device
    max_outer = max_outer if max_outer > 0 else max(4, maxupd // 3)
    track_bd = bd_fns is not None
    C = int(ls_cand)
    f32 = np.float32

    eps_f = float(np.finfo(str(dtype).replace("torch.", "")).eps)
    rteps = float(np.sqrt(eps_f))
    pgtol = 1e-2 * (rteps ** 0.5)  # tnc.c:431-433 with accuracy=rteps
    xtol = rteps

    def full(v):
        return torch.full((R,), v, dtype=dtype, device=dev)

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
                 # full sweeps, summed in float32 in the JAX package's
                 # order: the init fgh, then per outer iteration below
                 passes=f32(fgh_weight),
                 clip_rows=torch.zeros((), dtype=torch.int64, device=dev),
                 fb_rows=torch.zeros((), dtype=torch.int64, device=dev))
    ls_seen = []  # (searching, hi) at each LS round of the last iteration

    while stats["outer_iters"] < max_outer and profiling.host_any(
            active, "solver.tncg.outer"):
        # --- active set & projected gradient ---
        fixed = (x <= 0.0) & (g > 0.0)
        pgrad = torch.where(fixed, 0.0, g)
        pgnorm = torch.sqrt((pgrad * pgrad).sum(1))
        pg_scaled = pgrad * (1.0 + x.abs())
        conv_pg = torch.sqrt((pg_scaled * pg_scaled).sum(1)) <= pgtol
        active = active & ~conv_pg
        inv_diag = 1.0 / torch.clamp_min(diag, 1e-12)
        if track_bd:
            hvp_bv = bd_fns["hvp_bv_with"](w2)
        else:
            hvp = hvp_with(w2)

        # --- inner preconditioned CG for  H d = -g  on free coordinates ---
        r0norm = (pgrad * pgrad).sum(1)
        z = torch.where(fixed, 0.0, inv_diag * pgrad)
        t = dict(d=torch.zeros_like(x), r=pgrad, z=z, p=-z,
                 rz=(pgrad * z).sum(1), run=active & (r0norm > 0.0),
                 hvps=torch.zeros((R,), dtype=torch.int32, device=dev), i=0)
        if track_bd:
            t["bd"] = bd_fns["zeros"](dtype)

        def cg_step(t):
            first = t["i"] == 0
            p = torch.where(fixed, 0.0, t["p"])
            if track_bd:
                Hp, bv = hvp_bv(p)
            else:
                Hp = hvp(p)
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
                out["bd"] = bd_fns["axpy"](t["bd"], m, bv)
            return out

        with profiling.span("solver.tncg.cg"):
            if track_bd:
                # iteration 0 unrolled: (d1, bd1) is the safe replacement
                # direction (it never leaves the feasible cone)
                t = cg_step(t)
                d1, bd1 = t["d"], t["bd"]
            while t["i"] < maxcg and profiling.host_any(t["run"],
                                                        "solver.tncg.cg"):
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
            bd = bd_fns["select"](use_d1, bd1, t["bd"])
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
            bd = bdot(d)
        nfeval = nfeval + t["hvps"]

        # --- ray line search (tnc.c linearSearch/getptc), see JAX doc ---
        spe = torch.where(d < 0.0, x / torch.clamp_min(-d, 1e-30),
                          torch.inf).amin(1)
        a0 = torch.where(f > 0.0, -2.0 * f / torch.clamp_max(gtd, -1e-30),
                         full(1.0))
        a0 = torch.minimum(a0, spe)
        a0 = torch.where(torch.isfinite(a0) & (a0 > 0.0), a0, 1.0)
        coef = ray_coef_fn(x, d)
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
        ls_seen = []
        with profiling.span("solver.tncg.ls"):
            ls = _ls_rounds(
                ls, lambda cands: f_gtd_ray_multi(cands, coef, px, bd), f,
                gtd, spe, tnytol, maxupd, ftol, C,
                ls_seen if return_stats else None)

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
        # sweeps this outer iteration: one per HVP round (with its bd
        # accumulation), trial_frac per LS round, the search's <B, d> and
        # the fgh at the accepted point
        stats["passes"] = (stats["passes"] + f32(t["i"]) * f32(1.0 + hvp_extra)
                           + f32(ls["t"]) * f32(trial_frac)
                           + f32(bdot_weight) + f32(fgh_weight))

    # >= 95% of true rows moved by <= 1e-4 (squared L2), poismf.c:393-403
    delta = x - x_prev
    small = (delta * delta).sum(1) <= 1e-4
    share = int(profiling.host((small & has_nnz).sum(), "solver.tncg.stats")
                ) / max(float(n_rows), 1.0)
    if not return_stats:
        return x, share
    stats.update(nfeval=nfeval, active=active,
                 still_active=int(profiling.host(active.sum(),
                                                 "solver.tncg.stats")),
                 passes=float(stats["passes"]),
                 clip_rows=int(profiling.host(stats["clip_rows"],
                                              "solver.tncg.stats")),
                 fb_rows=int(profiling.host(stats["fb_rows"],
                                            "solver.tncg.stats")))
    dbg_search = torch.zeros((MAX_LS,), dtype=torch.int32, device=dev)
    dbg_brack = torch.zeros((MAX_LS,), dtype=torch.int32, device=dev)
    if ls_seen:
        searching = torch.stack([s for s, _ in ls_seen])
        hi = torch.stack([h for _, h in ls_seen])
        n = len(ls_seen)
        dbg_search[:n] = searching.sum(1, dtype=torch.int32)
        dbg_brack[:n] = (searching & torch.isfinite(hi)).sum(
            1, dtype=torch.int32)
    stats.update(dbg_search=dbg_search, dbg_brack=dbg_brack)
    return x, share, stats


def _ls_rounds(ls, trials, f, dginit, spe, tnytol, maxupd: int,
               ftol: float, C: int, seen: Optional[list]):
    """The line search's rounds from the state ``ls``, copied once into
    the rounds' buffers (:func:`kernels.ls_round_state`): a first call
    forms round 1's C candidates, then, while a row searches and MAX_LS
    rounds at most whatever C is, each round evaluates them (``trials(cands)
    -> (f_c, gu_c)``) and one call of :func:`kernels.ls_round` folds them
    in (nfeval counts each evaluated trial) and writes the next round's
    over them.  The loop test reads the round's flag (``more[t]``), which
    the call before it set if a row still searches.  ``seen`` (if a
    list) gets each round's (searching, hi) at its start.  Returns the
    final state."""
    R = f.shape[0]
    state, ls = kernels.ls_round_state(ls)
    more = torch.zeros((MAX_LS + 1,), dtype=torch.int32, device=f.device)
    cands = torch.empty((C, R), dtype=f.dtype, device=f.device)
    kernels.ls_round(state, cands, None, f, dginit, spe, tnytol, more[0],
                     maxupd=maxupd, ftol=ftol)
    t = 0
    while t < MAX_LS and bool(profiling.host(more[t], "solver.tncg.ls")):
        if seen is not None:
            seen.append((ls["searching"].clone(), ls["hi"].clone()))
        kernels.ls_round(state, cands, trials(cands), f, dginit, spe,
                         tnytol, more[t + 1], maxupd=maxupd, ftol=ftol)
        t += 1
    ls["t"] = t
    return ls
