"""ls_round: one round of the TNCG ray line search for every row: fold the
round's C trials into each row's search, then form the next round's C
candidate steps, in place on the search's state buffers.

CUDA kernel ``csrc/ls_round.cu`` (replaces no TPU kernel: the JAX package
runs the round as one XLA-fused loop body, eager PyTorch as ~415 small
launches) and its plain PyTorch version, :func:`ls_round_torch`, which
runs the solver's own pair, :func:`poismf_torch.solvers.tncg._ls_fold`
then ``_ls_candidates``, on the same buffers.  On float32 state the
kernel gives their result bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _lib

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
    ``_ls_fold`` on views of the state, written back into the buffers,
    then ``_ls_candidates`` written over ``cands``."""
    from ..solvers import tncg  # the plain pair is the solver's own

    C = cands.shape[0]
    ls = _views(state)
    if trials is not None:
        new = tncg._ls_fold(ls, cands, *trials, f, dginit, spe, tnytol,
                            maxupd, ftol, C)
        for key, x in ls.items():
            if key != "t":
                x.copy_(new[key])
    cands.copy_(tncg._ls_candidates(ls, spe, C))
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

    State on the CPU takes :func:`ls_round_torch`; on the card one launch
    of the kernel, or a raise (float64 included)."""
    if _lib.uses_plain(state[0], cands, f):
        ls_round_torch(state, cands, trials, f, dginit, spe, tnytol, more,
                       maxupd=maxupd, ftol=ftol)
    else:
        _launch(state, cands, trials, f, dginit, spe, tnytol, more,
                maxupd, ftol)


def _launch(state, cands, trials, f, dginit, spe, tnytol, more,
            maxupd: int, ftol: float) -> None:
    """The kernel's launch: CUDA tensors only, float32 (the state's flags
    bool, nfeval and ``more`` int32); raises on anything else.  No rows,
    no launch."""
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
        "contiguous float32 on one device")
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
