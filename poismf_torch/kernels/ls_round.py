"""ls_round: one round of the TNCG ray line search for every row: fold the
round's C trials into each row's search, then form the next round's C
candidate steps, in place on the search's state buffers.

CUDA kernel ``csrc/ls_round.cu`` (replaces no TPU kernel: the JAX package
runs the round as one XLA-fused loop body, eager PyTorch as ~415 small
launches) and its plain PyTorch version, :func:`ls_round_torch`, which
runs :func:`_ls_fold` then :func:`_ls_candidates` (the JAX package's
search, ``poismf_tpu/solvers/tncg.py``; the kernel mirrors them op by
op) on the same buffers.  On float32 state the kernel gives their result
bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib
from .route import takes_plain

# The search's constants (tnc.c:401-436; csrc/ls_round.cu RMU, ETA, EXTRAP).
TNC_ETA = 0.25  # CG forcing / line-search eta
LS_RMU = 1e-4  # sufficient-decrease mu
LS_EXTRAP = 4.0  # bracket growth factor while no upper bound found

# The float rows of the state buffer, in its order (csrc/ls_round.cu
# ``Field``).
STATE_FLOATS = ("alpha", "lo", "hi", "f_lo", "g_lo", "f_hi", "g_hi",
                "a_new", "f_new", "a_best", "f_best", "reltol", "abstol")


def _views(state) -> dict:
    floats, flags, nfeval = state
    return dict(zip(STATE_FLOATS, floats), found=flags[0],
                searching=flags[1], nfeval=nfeval, t=0)


def ls_round_state(ls: dict):
    """The round's own copy of the search state ``ls`` (the solver's dict
    of [R] vectors): ``(floats, flags, nfeval)``, the STATE_FLOATS stacked
    into a [13, R] buffer, ``found`` and ``searching`` into a [2, R] bool
    buffer and a copy of ``nfeval``; and a dict of ``ls``'s keys on views
    of them, through which the state reads after each round.  Being
    copies, the buffers keep the rounds' writes off ``ls``'s tensors
    (``f_lo``, ``f_new`` and ``f_best`` start as the solver's ``f``)."""
    floats = torch.stack([ls[k] for k in STATE_FLOATS])
    flags = torch.stack([ls["found"], ls["searching"]])
    nfeval = ls["nfeval"].to(torch.int32, copy=True)
    state = (floats, flags, nfeval)
    return state, _views(state)


def ls_round_torch(state, cands, trials, f, dginit, spe, tnytol, more, *,
                   maxupd: int, ftol: float) -> None:
    """Plain PyTorch version of :func:`ls_round`, any dtype and device:
    :func:`_ls_fold` on views of the state, written back into the
    buffers, then :func:`_ls_candidates` written over ``cands``."""
    C = cands.shape[0]
    ls = _views(state)
    if trials is not None:
        new = _ls_fold(ls, cands, *trials, f, dginit, spe, tnytol, maxupd,
                       ftol, C)
        for key, x in ls.items():
            if key != "t":
                x.copy_(new[key])
    cands.copy_(_ls_candidates(ls, spe, C))
    more.bitwise_or_(ls["searching"].any())


def ls_round(state, cands: torch.Tensor,
             trials: Optional[Tuple[torch.Tensor, torch.Tensor]],
             f: torch.Tensor, dginit: torch.Tensor, spe: torch.Tensor,
             tnytol: torch.Tensor, more: torch.Tensor, *, maxupd: int,
             ftol: float) -> None:
    """One round on ``state`` (from :func:`ls_round_state`) and the round's
    candidate steps ``cands`` [C, R]: with ``trials`` = (f_c, gu_c), the
    trial f and g.d at ``cands`` ([C, R] each), it folds them into the
    state as ``_ls_fold`` does with ``f``, ``dginit``, ``spe``, ``tnytol``
    ([R] each), ``maxupd`` and ``ftol``; with ``trials`` None it leaves
    the state as it is.  Then it writes the next round's candidates
    (``_ls_candidates``) over ``cands``, and sets ``more`` (one int32,
    zero before) to 1 if any row still searches.  No sync.

    float64 state takes :func:`ls_round_torch` on any device, as the ray
    trials take their plain versions (``route.py``); float32 state on the
    CPU too, and on the card one launch of the kernel, or a raise."""
    if takes_plain(state[0]) or _lib.uses_plain(state[0], cands, f):
        ls_round_torch(state, cands, trials, f, dginit, spe, tnytol, more,
                       maxupd=maxupd, ftol=ftol)
    else:
        _launch(state, cands, trials, f, dginit, spe, tnytol, more,
                maxupd, ftol)


def _launch(state, cands, trials, f, dginit, spe, tnytol, more,
            maxupd: int, ftol: float) -> None:
    """The kernel's launch: CUDA tensors only, float32 (the state's flags
    bool, nfeval and ``more`` int32); raises on anything else, float64
    included.  No rows, no launch."""
    floats, flags, nfeval = state
    C, R = cands.shape
    vecs = [x.contiguous() for x in (f, dginit, spe, tnytol)]
    trials = [] if trials is None else [x.contiguous() for x in trials]
    _lib.require(floats.is_cuda and C >= 1 and C * R < 2 ** 31,
                 "ls_round: CUDA tensors, 1 <= C candidates, C * R < 2**31")
    _lib.require(
        all(t.dtype == torch.float32 and t.device == floats.device
            and t.is_contiguous() for t in (floats, cands, *vecs, *trials)),
        "ls_round: the state, steps, trials and row vectors must be "
        "contiguous float32 on one device (float64 state takes "
        "ls_round_torch)")
    _lib.require(tuple(floats.shape) == (len(STATE_FLOATS), R)
                 and tuple(flags.shape) == (2, R)
                 and flags.dtype == torch.bool and flags.is_contiguous()
                 and tuple(nfeval.shape) == (R,)
                 and nfeval.dtype == torch.int32 and nfeval.is_contiguous(),
                 "ls_round: the state must come from ls_round_state")
    _lib.require(all(tuple(t.shape) == (R,) for t in vecs)
                 and all(tuple(t.shape) == (C, R) for t in trials)
                 and len(trials) in (0, 2),
                 "ls_round: f, dginit, spe, tnytol [R]; trials two [C, R]")
    _lib.require(more.dtype == torch.int32 and more.numel() == 1
                 and more.device == floats.device,
                 "ls_round: more must be one int32 on the state's device")
    if R == 0:
        return
    f_c, gu_c = trials or (None, None)
    lib = _lib.library()
    with torch.cuda.device(floats.device):
        rc = lib.poismf_ls_round(
            floats.data_ptr(), flags.data_ptr(), nfeval.data_ptr(),
            cands.data_ptr(), _lib.ptr(f_c), _lib.ptr(gu_c),
            *(t.data_ptr() for t in vecs), more.data_ptr(), C, R,
            int(maxupd), float(ftol), _lib.stream_of(floats))
    _lib.check(rc, "ls_round")
    _lib.launch_counts["ls_round"] += 1


def _ls_candidates(t, spe, C: int):
    """[C, R] trial steps: bracketed rows take the safeguarded cubic
    (Hermite minimizer through both ends, bisection where undefined) and,
    for C > 1, even subdivisions, or a descending geometric ladder when
    the bracket's upper end is poisoned; unbracketed rows the
    extrapolation ladder clamped at spe (C = 1: its one rung)."""
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
    if C == 1:
        brack = a_brack[None]
        ladder = torch.minimum(t["alpha"], spe)[None]
    else:
        brack = torch.stack(
            [a_brack] + [lo + span * ((j + 1.0) / C) for j in range(C - 1)]
        )
        poisoned = has_hi & ~torch.isfinite(f_hi) & (0.25 * hi > lo)
        geo = torch.stack([hi * (0.25 ** (j + 1.0)) for j in range(C)])
        brack = torch.where(poisoned[None, :], geo, brack)
        ladder = torch.stack([torch.minimum(t["alpha"] * (LS_EXTRAP ** j),
                                            spe) for j in range(C)])
    return torch.where(has_hi[None, :], brack, ladder)


def _ls_fold(t, cands, f_c, gu_c, f, dginit, spe, tnytol, maxupd, ftol,
             C: int):
    """Fold one round's C candidates into each row's search, in processing
    order: first-ok accept (for C > 1 bracketed rows only at the cubic
    candidate c == 0), too-far candidates shrink hi, too-short ones raise
    lo; then getptc's convergence check (tnc.c:1968-1997), batched, and
    the unbracketed rows' ladder moves up EXTRAP^C."""
    lo, hi = t["lo"], t["hi"]
    f_lo, g_lo, f_hi, g_hi = t["f_lo"], t["g_lo"], t["f_hi"], t["g_hi"]
    acc = torch.zeros_like(t["searching"])
    a_acc = torch.zeros_like(f)
    f_acc = torch.full_like(f, torch.inf)
    a_best, f_best = t["a_best"], t["f_best"]
    nfe = t["nfeval"]
    searching0 = t["searching"]
    has_hi0 = torch.isfinite(hi)
    for c in range(C):
        a_c, f_tc, gu_tc = cands[c], f_c[c], gu_c[c]
        usable = (searching0 & ~acc & (a_c > lo) & (a_c < hi)
                  & (nfe < maxupd))
        nfe = nfe + usable.to(torch.int32)
        suff = torch.isfinite(f_tc) & (f_tc <= f + LS_RMU * a_c * dginit)
        curv_lo = gu_tc >= TNC_ETA * dginit
        curv_hi = gu_tc <= -TNC_ETA * dginit
        wolfe = usable & suff & curv_lo & curv_hi
        newcon = usable & suff & (a_c >= spe * (1.0 - 1e-6)) & ~curv_lo
        ok = (wolfe & (~has_hi0 | (c == 0)) if C > 1 else wolfe) | newcon
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
            torch.minimum(t["alpha"] * (LS_EXTRAP ** C), spe),
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
