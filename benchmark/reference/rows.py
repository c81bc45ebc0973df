"""Per-row Poisson factorization problems, solved plainly in float64.

A half-update solves, for every target row ``r`` with counts ``x_ri`` on
the fixed side's rows ``b_i``, the convex problem over ``a >= 0``::

    f_r(a) = <s, a> + l2 ||a||^2 - sum_i x_ri log <a, b_i>,
    s = colsums(fixed) + l1.

(Non-negative Poisson matrix factorization, Cortes 2018,
arXiv:1811.01908.)  Rows are held in padded groups of similar length:
the fixed side's rows gathered once, ``[R, P, k]``.  Three things are
computed on them: ``f`` at given rows, the exact minimiser by a
projected Newton method, and the published non-negative conjugate
gradient's iterations (Li 2013's modified Polak-Ribiere with the poismf
reference's capped step and Armijo backtracking) from a given start.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

LOG_FLOOR = 1e-30


@dataclasses.dataclass
class Group:
    rows: torch.Tensor  # [R] ids of the target rows
    cols: torch.Tensor  # [R, P] ids of the fixed rows (zero at padding)
    Fg: torch.Tensor  # [R, P, k] float64 fixed rows (zero at padding)
    X: torch.Tensor  # [R, P] float64 counts (zero at padding)


def make_groups(rows: torch.Tensor, indptr: torch.Tensor, cols: torch.Tensor,
                vals: torch.Tensor, fixed: torch.Tensor,
                max_slots: int = 1 << 21) -> List[Group]:
    """The rows ``rows`` (ids into ``indptr``) as padded groups against
    ``fixed`` [n_fixed, k] (cast to float64): rows sorted by length, each
    group padded to the next power of two of its longest row, at most
    ``max_slots`` slots a group (a longer row is a group alone)."""
    lens = (indptr[rows + 1] - indptr[rows])
    order = torch.argsort(lens)
    rows, lens = rows[order], lens[order].tolist()
    F = fixed.to(torch.float64)
    groups, i = [], 0
    while i < len(rows):
        P = 1 << max(int(lens[i]) - 1, 0).bit_length()
        j = i + 1
        while j < len(rows):
            Pj = 1 << max(int(lens[j]) - 1, 0).bit_length()
            if (j + 1 - i) * Pj > max_slots:
                break
            P = Pj
            j += 1
        rr = rows[i:j]
        start = indptr[rr]
        pos = torch.arange(P, device=rows.device)[None, :]
        n = (indptr[rr + 1] - start)[:, None]
        valid = pos < n
        at = torch.where(valid, start[:, None] + pos, 0)
        idx = torch.where(valid, cols[at], 0)
        X = torch.where(valid, vals[at].to(torch.float64), 0.0)
        Fg = torch.where(valid[:, :, None], F[idx], 0.0)
        groups.append(Group(rr, idx, Fg, X))
        i = j
    return groups


def regather(g: Group, fixed: torch.Tensor) -> Group:
    """``g`` against other fixed rows (float64), same slots."""
    Fg = torch.where(g.X[:, :, None] > 0, fixed.to(torch.float64)[g.cols],
                     0.0)
    return Group(g.rows, g.cols, Fg, g.X)


def _pred(g: Group, a: torch.Tensor) -> torch.Tensor:
    return torch.bmm(g.Fg, a.unsqueeze(2)).squeeze(2)


def objective(g: Group, a: torch.Tensor, s: torch.Tensor,
              l2: float) -> torch.Tensor:
    """f_r at rows ``a`` [R, k] (float64), the log floored at 1e-30."""
    a = a.to(torch.float64)
    logt = torch.where(g.X > 0, g.X * torch.log(
        _pred(g, a).clamp_min(LOG_FLOOR)), 0.0)
    return a @ s + l2 * (a * a).sum(1) - logt.sum(1)


def gradient(g: Group, a: torch.Tensor, s: torch.Tensor,
             l2: float) -> torch.Tensor:
    """The gradient of each row's ``f`` at ``a`` [R, k] (float64)."""
    a = a.to(torch.float64)
    w = torch.where(g.X > 0, g.X / _pred(g, a).clamp_min(LOG_FLOOR), 0.0)
    return s + 2.0 * l2 * a - torch.bmm(w.unsqueeze(1), g.Fg).squeeze(1)


def solve_exact(g: Group, a0: torch.Tensor, s: torch.Tensor, l2: float,
                iters: int = 200, tol: float = 1e-13) -> torch.Tensor:
    """The minimiser of each row's ``f`` over ``a >= 0``, by projected
    Newton steps (Bertsekas 1982): the coordinates within ``eps`` of zero
    whose gradient is positive are held at zero (``eps`` the scaled
    projected gradient's size, at most 1e-3 of the row's largest
    entry), a Newton step on the others (a diagonally scaled step where
    the reduced Hessian does not factor), and an Armijo search along the
    projection arc.  A row stops once a step gains less than ``tol`` of
    its objective.  ``a0`` starts it (made strictly positive)."""
    R, P, k = g.Fg.shape
    eye = torch.eye(k, dtype=torch.float64, device=g.Fg.device)
    a = a0.to(torch.float64).clamp_min(1e-6)
    f = objective(g, a, s, l2)
    done = torch.zeros(R, dtype=torch.bool, device=a.device)
    for _ in range(iters):
        pred = _pred(g, a).clamp_min(LOG_FLOOR)
        w = torch.where(g.X > 0, g.X / pred, 0.0)
        w2 = torch.where(g.X > 0, g.X / (pred * pred), 0.0)
        grad = s + 2.0 * l2 * a - torch.bmm(w.unsqueeze(1), g.Fg).squeeze(1)
        H = torch.bmm(g.Fg.transpose(1, 2) * w2.unsqueeze(1), g.Fg)
        H = H + 2.0 * l2 * eye
        diag = torch.diagonal(H, dim1=1, dim2=2)
        width = (a - (a - grad / diag).clamp_min(0.0)).norm(dim=1)
        eps = torch.minimum(width, 1e-3 * a.amax(1))[:, None]
        bind = (a <= eps) & (grad > 0)
        both = bind.unsqueeze(2) | bind.unsqueeze(1)
        Hf = torch.where(both, eye.expand(R, k, k), H)
        gf = torch.where(bind, 0.0, grad)
        L, info = torch.linalg.cholesky_ex(Hf)
        ok = (info == 0)[:, None]
        L = torch.where(ok[:, :, None], L, eye.expand(R, k, k))
        d = -torch.cholesky_solve(gf.unsqueeze(2), L).squeeze(2)
        d = torch.where(ok, d, -gf / diag)
        d = torch.where(bind, -grad / diag, d)
        t = torch.ones(R, dtype=torch.float64, device=a.device)
        took = done.clone()
        a_new, f_new = a, f
        for _ in range(60):
            trial = (a + t[:, None] * d).clamp_min(0.0)
            ft = objective(g, trial, s, l2)
            acc = ~took & (ft <= f + 1e-4 * (grad * (trial - a)).sum(1))
            a_new = torch.where(acc[:, None], trial, a_new)
            f_new = torch.where(acc, ft, f_new)
            took = took | acc
            if bool(took.all()):
                break
            t = torch.where(took, t, 0.5 * t)
        gain = f - f_new
        done = done | ~took | (gain <= tol * f.abs().clamp_min(1.0))
        a, f = a_new, f_new
        if bool(done.all()):
            break
    return a


# The poismf reference's CG constants (nonnegcg.c).
CG_TOL = 1e-2
CG_MAXNFEVAL = 150
CG_DECR = 0.25
CG_LNSRCH_C = 0.01
CG_MAX_LS = 20
EPS_LIMIT = 1e-15


def cg_iterate(g: Group, x0: torch.Tensor, s: torch.Tensor, l2: float,
               maxupd: int) -> torch.Tensor:
    """Up to ``maxupd`` iterations of the non-negative CG from ``x0``
    [R, k], every row on its own: the projected steepest-descent
    direction corrected on the free coordinates by the modified PRP
    beta and theta, the stop at ``|<g, d>| <= 1e-2``, the step capped at
    1 and at the first zero crossing, then Armijo backtracking over
    ``cap * 0.25^j`` (at most 20 trials, an evaluation budget of 150 a
    row), with ``x < 1e-15`` set to zero at the accepted point."""
    x = x0.to(torch.float64)
    R, k = x.shape
    dev = x.device
    f = objective(g, x, s, l2)
    grad = gradient(g, x, s, l2)
    nfe = torch.ones(R, dtype=torch.int64, device=dev)
    active = torch.isfinite(f)
    grad_prev = torch.zeros_like(x)
    dir_prev = torch.zeros_like(x)
    gnorm_prev = torch.ones(R, dtype=torch.float64, device=dev)
    for it in range(maxupd):
        if not bool(active.any()):
            break
        nonpos = x <= 0.0
        d = torch.where(nonpos & (grad >= 0.0), 0.0, -grad)
        if it > 0:
            free = ~nonpos
            dg = grad - grad_prev
            theta = torch.where(free, grad * dir_prev, 0.0).sum(1) / gnorm_prev
            beta = torch.where(free, grad * dg, 0.0).sum(1) / gnorm_prev
            d = d + torch.where(free, beta[:, None] * dir_prev
                                - theta[:, None] * dg, 0.0)
        active = active & ~((grad * d).sum(1).abs() <= CG_TOL)
        neg = d < 0.0
        ratio = torch.where(neg, -x / torch.where(neg, d, -1.0), torch.inf)
        step = ratio.amin(1).clamp_max(1.0)
        dnorm = (d * d).sum(1)
        x_new, found = x, torch.zeros(R, dtype=torch.bool, device=dev)
        searching = active.clone()
        for j in range(CG_MAX_LS):
            if not bool(searching.any()):
                break
            trial = x + step[:, None] * d
            trial = torch.where(trial >= EPS_LIMIT, trial, 0.0)
            ft = objective(g, trial, s, l2)
            ok = searching & torch.isfinite(ft) & (
                ft <= f - CG_LNSRCH_C * step * dnorm) & (nfe < CG_MAXNFEVAL)
            x_new = torch.where(ok[:, None], trial, x_new)
            found = found | ok
            rejected = searching & ~ok
            nfe = nfe + rejected.to(torch.int64)
            searching = rejected & (nfe < CG_MAXNFEVAL)
            step = torch.where(rejected, step * CG_DECR, step)
        active = active & (nfe < CG_MAXNFEVAL)
        grad_prev, dir_prev = grad, d
        gnorm_prev = (grad * grad).sum(1).clamp_min(1e-30)
        x = torch.where(found[:, None], x_new, x)
        f = objective(g, x, s, l2)
        grad = gradient(g, x, s, l2)
    return x


def round_fixed(F: torch.Tensor, dtype: Optional[torch.dtype]):
    """``F`` rounded to ``dtype`` and back to float64 (None: as it is);
    an 8-bit float takes one scale for the whole matrix, its largest
    entry mapped to the format's largest value."""
    if dtype is None:
        return F.to(torch.float64)
    F32 = F.to(torch.float32)
    if dtype.itemsize == 1:
        scale = torch.finfo(dtype).max / F32.abs().max().clamp_min(1e-30)
        return ((F32 * scale).to(dtype).to(torch.float64)
                / scale.to(torch.float64))
    return F32.to(dtype).to(torch.float64)


# The published truncated Newton's rules as the poismf reference calls
# it (tnc.c with poismf.c's arguments, in single precision: use_float).
TNC_ETA = 0.25  # inner-CG forcing and the line search's curvature test
TNC_FTOL = 1e-4  # f-convergence tolerance (poismf.c passes it)
TNC_RMU = 1e-4  # sufficient decrease
TNC_EXTRAP = 4.0  # step growth while the minimum is not bracketed
TNC_MAX_LS = 16  # trials a line search
TNC_EPS = 2.0 ** -23  # float32's machine epsilon


def merit(g: Group, a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The truncated Newton's ``f``: each row's ``f_r`` without its l2
    term (the reference's calc_fun_and_grad leaves it out of ``f`` and
    keeps it in the gradient)."""
    return objective(g, a, s, 0.0)


def _ray(g: Group, x, d, alpha, s, l2):
    """(merit, gradient . d) at ``x + alpha d``."""
    y = x + alpha[:, None] * d
    return merit(g, y, s), (gradient(g, y, s, l2) * d).sum(1)


def tnc_iterate(g: Group, x0: torch.Tensor, s: torch.Tensor, l2: float,
                maxupd: int) -> torch.Tensor:
    """The published truncated Newton from ``x0`` [R, k] over ``a >= 0``,
    every row on its own, with ``f`` the merit (no l2 term) and the
    gradient with it: the projected gradient's test, the inner CG with
    exact Hessian products and the Jacobi preconditioner on the free
    coordinates (``clamp(k / 2, 1, 50)`` products at most, stopped at
    ``|r| <= 0.25 |r0|`` or at non-positive curvature), the direction
    kept in the feasible cone (steepest descent where it does not
    descend), then a line search along ``x + alpha d`` up to the nearest
    bound: extrapolation by 4 until bracketed, then the safeguarded
    cubic, accepting the strong Wolfe point (or a sufficient decrease at
    the bound), at most 16 trials, the best decrease where none passes;
    the step snapped onto the bound; a row stops at ``|df| <= 1e-4``,
    ``|dx| <= sqrt(eps)`` on one face, a failed search, or its budget of
    ``maxupd`` evaluations, and the whole after ``max(4, maxupd // 3)``
    iterations."""
    R, P, k = g.Fg.shape
    dev = g.Fg.device
    maxcg = int(min(50.0, max(1.0, k / 2.0)))
    rteps = TNC_EPS ** 0.5
    pgtol, xtol = 1e-2 * rteps ** 0.5, rteps
    x = x0.to(torch.float64)

    def evaluate(x):
        pred = _pred(g, x).clamp_min(LOG_FLOOR)
        w = torch.where(g.X > 0, g.X / pred, 0.0)
        w2 = torch.where(g.X > 0, g.X / (pred * pred), 0.0)
        grad = s + 2.0 * l2 * x - torch.bmm(w.unsqueeze(1), g.Fg).squeeze(1)
        diag = 2.0 * l2 + torch.bmm(w2.unsqueeze(1), g.Fg * g.Fg).squeeze(1)
        return merit(g, x, s), grad, w2, diag

    def hvp(w2, v):
        bv = torch.bmm(g.Fg, v.unsqueeze(2)).squeeze(2)
        return (torch.bmm((w2 * bv).unsqueeze(1), g.Fg).squeeze(1)
                + 2.0 * l2 * v)

    f, grad, w2, diag = evaluate(x)
    nfeval = torch.ones(R, dtype=torch.int64, device=dev)
    active = (g.X > 0).any(1) & torch.isfinite(f)
    for _ in range(max(4, maxupd // 3)):
        if not bool(active.any()):
            break
        fixed = (x <= 0.0) & (grad > 0.0)
        pgrad = torch.where(fixed, 0.0, grad)
        active = active & ~((pgrad * (1.0 + x.abs())).norm(dim=1) <= pgtol)
        inv_diag = 1.0 / diag.clamp_min(1e-12)
        # the inner CG for H d = -g on the free coordinates
        r0 = (pgrad * pgrad).sum(1)
        r = pgrad
        z = torch.where(fixed, 0.0, inv_diag * r)
        p, rz = -z, (r * z).sum(1)
        d = torch.zeros_like(x)
        run = active & (r0 > 0.0)
        hvps = torch.zeros(R, dtype=torch.int64, device=dev)
        for i in range(maxcg):
            if not bool(run.any()):
                break
            p = torch.where(fixed, 0.0, p)
            Hp = torch.where(fixed, 0.0, hvp(w2, p))
            pHp, pp = (p * Hp).sum(1), (p * p).sum(1)
            curv = (pHp > 1e-12 * pp.clamp_min(1e-30)) & torch.isfinite(pHp)
            if i == 0:  # no curvature at all: the preconditioned gradient
                d = torch.where((run & ~curv)[:, None], p, d)
            step = run & curv
            alpha = torch.where(step, rz / torch.where(curv, pHp, 1.0), 0.0)
            d = torch.where(step[:, None], d + alpha[:, None] * p, d)
            r = torch.where(step[:, None], r + alpha[:, None] * Hp, r)
            z = torch.where(fixed, 0.0, inv_diag * r)
            rz_new = (r * z).sum(1)
            beta = rz_new / torch.where(rz > 0, rz, 1.0)
            p = torch.where(step[:, None], -z + beta[:, None] * p, p)
            rz = torch.where(step, rz_new, rz)
            hvps = hvps + run.to(torch.int64)
            run = step & ((r * r).sum(1) > TNC_ETA ** 2 * r0)
        d = torch.where(fixed | ((x <= 0.0) & (d < 0.0)), 0.0, d)
        gtd, dnorm = (grad * d).sum(1), (d * d).sum(1)
        bad = ~torch.isfinite(gtd) | (gtd >= 0.0) | (dnorm <= 0.0)
        d = torch.where(bad[:, None], -pgrad, d)
        gtd = torch.where(bad, -r0, gtd)
        dnorm = (d * d).sum(1)
        nfeval = nfeval + hvps
        # the line search
        spe = torch.where(d < 0.0, x / (-d).clamp_min(1e-30),
                          torch.inf).amin(1)
        a0 = torch.where(f > 0.0, -2.0 * f / gtd.clamp_max(-1e-30), 1.0)
        a0 = torch.minimum(a0, spe)
        alpha = torch.where(torch.isfinite(a0) & (a0 > 0.0), a0, 1.0)
        xnorm, pnorm = x.norm(dim=1), dnorm.sqrt() + TNC_EPS
        tnytol = TNC_EPS * (xnorm + 1.0) / pnorm
        reltol = rteps * (xnorm + 1.0) / pnorm
        abstol = TNC_EPS * (1.0 + f.abs()) / (gtd.abs() + TNC_EPS)
        inf = torch.full_like(f, torch.inf)
        lo, hi = torch.zeros_like(f), inf.clone()
        f_lo, g_lo, f_hi, g_hi = f, gtd, inf.clone(), torch.zeros_like(f)
        found = torch.zeros(R, dtype=torch.bool, device=dev)
        a_new, f_new, a_best, f_best = torch.zeros_like(f), f, \
            torch.zeros_like(f), f
        searching = active.clone()
        for _ in range(TNC_MAX_LS):
            if not bool(searching.any()):
                break
            has_hi = torch.isfinite(hi)
            span = hi - lo
            d1 = g_lo + g_hi + 3.0 * (f_lo - f_hi) / span.clamp_min(1e-30)
            rad = d1 * d1 - g_lo * g_hi
            d2 = rad.clamp_min(0.0).sqrt()
            den = g_hi - g_lo + 2.0 * d2
            cubic = hi - span * (g_hi + d2 - d1) / den
            ok_c = (has_hi & torch.isfinite(f_hi) & (rad >= 0.0)
                    & (den.abs() > 1e-30) & torch.isfinite(cubic))
            brack = torch.where(ok_c, torch.minimum(torch.maximum(
                cubic, lo + 0.1 * span), hi - 0.1 * span), 0.5 * (lo + hi))
            a = torch.where(has_hi, brack, torch.minimum(alpha, spe))
            ft, gut = _ray(g, x, d, torch.where(searching, a, 0.0), s, l2)
            usable = searching & (a > lo) & (a < hi) & (nfeval < maxupd)
            nfeval = nfeval + usable.to(torch.int64)
            suff = torch.isfinite(ft) & (ft <= f + TNC_RMU * a * gtd)
            c_lo, c_hi = gut >= TNC_ETA * gtd, gut <= -TNC_ETA * gtd
            ok = usable & suff & ((c_lo & c_hi)
                                  | ((a >= spe * (1.0 - 1e-6)) & ~c_lo))
            a_new, f_new = torch.where(ok, a, a_new), torch.where(ok, ft,
                                                                  f_new)
            found = found | ok
            better = usable & torch.isfinite(ft) & (ft < f_best)
            a_best = torch.where(better, a, a_best)
            f_best = torch.where(better, ft, f_best)
            to_hi = usable & ~ok & (~suff | ~c_hi)
            to_lo = usable & ~ok & suff & ~c_lo & c_hi
            hi, f_hi = torch.where(to_hi, a, hi), torch.where(to_hi, ft, f_hi)
            g_hi = torch.where(to_hi, gut, g_hi)
            lo, f_lo = torch.where(to_lo, a, lo), torch.where(to_lo, ft, f_lo)
            g_lo = torch.where(to_lo, gut, g_lo)
            searching = searching & ~ok & (nfeval < maxupd)
            # the bracket's collapse (getptc's tolerances)
            tol = reltol * lo + abstol
            collapse = torch.isfinite(hi) & ((hi - lo) <= 2.0 * tol)
            shrink = collapse & ~(f_best < f)
            dead = ((collapse & (f_best < f))
                    | (shrink & (torch.where(torch.isfinite(f_hi),
                                             (f - f_hi).abs(), torch.inf)
                                 <= TNC_FTOL))
                    | (shrink & (0.1 * tol < tnytol)))
            cont = shrink & ~dead
            searching = searching & ~dead
            reltol = torch.where(cont, 0.1 * reltol, reltol)
            abstol = torch.where(cont, 0.1 * abstol, abstol)
            alpha = torch.where(searching & ~torch.isfinite(hi),
                                torch.minimum(alpha * TNC_EXTRAP, spe), alpha)
        fallback = active & ~found & (f_best < f)
        moved = found | fallback
        a_sel = torch.where(found, a_new, a_best)
        x_next = torch.where(moved[:, None],
                             (x + a_sel[:, None] * d).clamp_min(0.0), x)
        snap = 10.0 * TNC_EPS * (1.0 + x.abs())
        x_next = torch.where(moved[:, None] & (d < 0.0) & (x_next <= snap),
                             0.0, x_next)
        f_next, grad, w2, diag = evaluate(x_next)
        same_face = ((x_next <= 0.0) == (x <= 0.0)).all(1)
        conv = moved & same_face & (((f - f_next).abs() <= TNC_FTOL)
                                    | ((x_next - x).norm(dim=1) <= xtol))
        active = (active & ~conv & moved & (nfeval < maxupd))
        nfeval = nfeval + moved.to(torch.int64)
        x, f = x_next, f_next
    return x
