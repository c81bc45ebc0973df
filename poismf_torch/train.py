"""Alternating-optimization training driver (tncg on the planar-ELL layout).

Counterpart of ``poismf_tpu/train.py``: per epoch, update B holding A fixed
(by-item orientation), then A holding B fixed (by-user orientation).  Each
half-update gathers the fixed side into planes once and runs the TNCG
cascade: a few outer iterations on the full structure, then the
still-active tail on the smallest compact sub-ELL that holds it.

Semantics carried over: ``Bsum = colsums(fixed) + l1`` before each
half-update, the weighted per-row Bsum when ``w_mult != 1``, and the early
stop when >= 95% of rows move by <= 1e-4 (squared L2) on both sides.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .ops import ell as ell_ops
from .sparse import CountsMatrix
from .solvers.tncg import tncg_update_ell

METHODS = ("tncg", "cg", "pg")

# Compact capacity levels, tried smallest-first: steady-state ~2% tails
# solve at 1/16 of the structure, 10-25% tails at 1/4, 25-50% clustered
# tails at 1/2; larger tails continue on the full structure.
COMPACT_DENOMS = (16, 4, 2)

# The cascade's round schedule (train.py:674-685 of the JAX package).
MAX_ROUNDS = 8
ROUND_ITERS = 4
ROUND0_ITERS = 3
BIG_SHARE, BIG_ITERS = 0.35, 8


@dataclasses.dataclass
class FitParams:
    """Hyperparameters, with the same "auto" tables as the reference."""

    k: int = 50
    method: str = "tncg"
    l2_reg: float = "auto"  # type: ignore[assignment]
    l1_reg: float = 0.0
    niter: int = "auto"  # type: ignore[assignment]
    maxupd: int = "auto"  # type: ignore[assignment]
    early_stop: bool = True
    reuse_prev: bool = False
    w_mult: float = 1.0
    layout: str = "auto"
    plane_dtype: Optional[str] = None
    max_cg: Optional[int] = "auto"  # type: ignore[assignment]

    def resolved(self) -> "FitParams":
        p = dataclasses.replace(self)
        if p.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}")
        if p.layout not in ("auto", "ell", "coo"):
            raise ValueError("layout must be 'auto', 'ell' or 'coo'")
        if p.layout == "auto":
            p.layout = "ell"
        if p.l2_reg == "auto":
            p.l2_reg = {"tncg": 1e3, "cg": 1e4, "pg": 1e9}[p.method]
        if p.maxupd == "auto":
            p.maxupd = {"tncg": 15 * p.k, "cg": 5, "pg": 10}[p.method]
        if p.niter == "auto":
            p.niter = {"tncg": 10, "cg": 30, "pg": 10}[p.method]
        if p.max_cg == "auto":
            # the tight cap relies on the cascade's final uncapped rounds
            p.max_cg = 3 if (p.method == "tncg" and p.layout == "ell") \
                else None
        if p.max_cg is not None:
            p.max_cg = int(p.max_cg)
            if p.max_cg < 1:
                raise ValueError("max_cg must be a positive integer or None")
        if not (p.k > 0 and p.niter >= 1 and p.maxupd >= 1):
            raise ValueError("k, niter and maxupd must be positive")
        if not (p.l2_reg >= 0 and p.l1_reg >= 0):
            raise ValueError("l2_reg and l1_reg must be non-negative")
        if not p.w_mult > 0:
            raise ValueError("w_mult must be positive")
        p.l2_reg = float(p.l2_reg)
        p.l1_reg = float(p.l1_reg)
        return p


def initialize_factors(n_rows: int, n_rows_pad: int, k: int, seed,
                       dtype=np.float32, device="cpu") -> torch.Tensor:
    """A, B ~ 0.3 + U(0, 0.01) on the host (the reference's HPF-style
    init); padded rows stay exactly zero.  The same NumPy draws as the JAX
    package, so the same seed gives bit-identical factors."""
    rng = (seed if isinstance(seed, np.random.Generator)
           else np.random.default_rng(seed))
    M = np.zeros((n_rows_pad, k), dtype=dtype)
    M[:n_rows] = 0.3 + rng.uniform(0.0, 0.01, size=(n_rows, k))
    return torch.from_numpy(M).to(device)


def _make_aux(ell: ell_ops.EllMatrix) -> dict:
    """Host-side cascade metadata: the static compact plans and the host
    copies of the per-slot nnz and the buckets' ``src``."""
    return dict(
        plans=[ell_ops.plan_compact(ell, d) for d in COMPACT_DENOMS],
        row_nnz=ell.host["row_nnz_perm"],
        src=list(ell.host["src"]),
    )


# One-entry cache of the ELL pair, keyed on the identity of the host index
# arrays (pinned in the entry, so a recycled id can never alias it) and the
# device: repeated fits on the same data skip the O(nnz) host build.
_ELL_CACHE: dict = {}


def ell_pair_cached(by_user: CountsMatrix, by_item: CountsMatrix, device):
    referents = (by_user.row_ids, by_user.col_ids, by_user.vals,
                 by_item.row_ids, by_item.col_ids, by_item.vals)
    key = tuple(id(a) for a in referents) + (str(torch.device(device)),)
    entry = _ELL_CACHE.get(key)
    if entry is None:
        pair = ell_ops.ell_pair_from_counts(by_user, by_item, device=device)
        _ELL_CACHE.clear()
        _ELL_CACHE[key] = (pair, referents)
        return pair
    return entry[0]


def _compact_round(x_full, fixed_p, ell, bsum_in, sel, plan, plane_dtype,
                   max_outer: int, p: FitParams, max_cg, nfe_full):
    """One cascade round on a compact sub-ELL: build it (edge data and
    planes gathered on the device), solve, and scatter the rows and their
    carried feval counts back into the full ELL space."""
    sels, src_cs, slot_map, row_nnz_c, _ = sel
    compact = ell_ops.build_compact(ell, plan, sels, src_cs, slot_map,
                                    row_nnz_c)
    planes_c = ell_ops.gather_planes(fixed_p, compact, plane_dtype)
    slot_map_d = compact.perm
    bsum_c = bsum_in if bsum_in.dim() == 1 else bsum_in[slot_map_d]
    x_new, _, st = tncg_update_ell(
        x_full[slot_map_d], planes_c, compact, bsum_c,
        l2_reg=p.l2_reg, w_mult=p.w_mult, maxupd=p.maxupd,
        reuse_prev=True,  # compact rounds always continue from x
        max_outer=max_outer, nfeval0=nfe_full[slot_map_d], max_cg=max_cg,
    )
    x_out = ell_ops.scatter_back(x_full, x_new, slot_map_d,
                                 compact.row_nnz_perm)
    # fill slots all map to the parent zero tail and write its own value
    nfe_out = nfe_full.clone()
    nfe_out[slot_map_d] = torch.where(compact.row_nnz_perm > 0,
                                      st["nfeval"], nfe_full[slot_map_d])
    return x_out, st["active"], nfe_out


def _tncg_cascade(target_p, fixed_p, planes, ell, bsum_in, p: FitParams,
                  plane_dtype):
    """One tncg half-update by the annealing cascade; returns
    (new target, converged)."""
    aux = _make_aux(ell)
    unbounded = max(4, p.maxupd // 3)  # the solver's own default cap
    x = target_p
    active = None  # None = all rows (first round)
    # per-row feval budget, threaded across rounds
    nfe = torch.zeros((ell.n_rows_ell,), dtype=torch.int32, device=ell.device)
    for rnd in range(MAX_ROUNDS):
        last = rnd == MAX_ROUNDS - 1
        sel = plan = None
        if active is not None:
            for plan in aux["plans"]:  # smallest capacity first
                sel = ell_ops.select_active(ell, plan, active, aux["row_nnz"],
                                            aux["src"])
                if sel is not None:
                    break
        if sel is not None:
            # a tail that fits the smallest capacity is cheap enough to
            # finish in one unbounded solve
            if plan is aux["plans"][0]:
                last = True
            x, act_c, nfe = _compact_round(
                x, fixed_p, ell, bsum_in, sel, plan, plane_dtype,
                unbounded if last else ROUND_ITERS, p,
                None if last else p.max_cg, nfe,
            )
            act_next = None
            if not last:
                sm = sel[2]
                live = act_c.cpu().numpy() & (sm != ell.n_rows_ell - 1)
                act_next = np.zeros(ell.n_rows_ell, dtype=bool)
                act_next[sm[live]] = True
        else:
            mask = (None if active is None
                    else torch.from_numpy(active).to(ell.device))
            share = (1.0 if active is None
                     else float(np.count_nonzero(active))
                     / max(ell.n_rows_ell, 1))
            bounded = BIG_ITERS if share > BIG_SHARE else ROUND_ITERS
            x, _, st = tncg_update_ell(
                x, planes, ell, bsum_in,
                l2_reg=p.l2_reg, w_mult=p.w_mult, maxupd=p.maxupd,
                reuse_prev=(p.reuse_prev if rnd == 0 else True),
                max_outer=(unbounded if last
                           else (ROUND0_ITERS if rnd == 0 else bounded)),
                active_mask=mask, nfeval0=nfe,
                # final rounds polish with the reference maxCGit
                max_cg=None if last else p.max_cg,
            )
            nfe = st["nfeval"]
            act_next = None if last else st["active"].cpu().numpy()
        if act_next is None or not act_next.any():
            break
        active = act_next
    if not p.early_stop:
        return x, False
    has = ell.row_nnz_perm > 0
    before = torch.where(has[:, None], target_p, 0.0)
    small = ((x - before) ** 2).sum(1) <= 1e-4
    share = int((small & has).sum().item()) / max(ell.n_rows, 1)
    return x, share >= 0.95


def run_poismf(
    A: torch.Tensor,
    B: torch.Tensor,
    by_user: CountsMatrix,
    by_item: CountsMatrix,
    params: FitParams,
    handle_interrupt: bool = True,
    callback: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]]
    = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Alternating driver.  A: [n_users_pad, k], B: [n_items_pad, k] on
    the fit's device.  Returns (A, B, status): 0 = success, 2 =
    interrupted (the partial factors stay usable)."""
    p = params.resolved()
    if p.method != "tncg":
        raise NotImplementedError(f"method={p.method!r}: not yet ported")
    if p.layout != "ell":
        raise NotImplementedError(f"layout={p.layout!r}: not yet ported")
    return _run_poismf_ell(A, B, by_user, by_item, p, handle_interrupt,
                           callback)


def _run_poismf_ell(A, B, by_user, by_item, p: FitParams,
                    handle_interrupt: bool = True, callback=None):
    """Fit on the planar-ELL layout: both factor matrices live in their
    nnz-sorted permuted row order for the whole fit, so the only per-half
    setup is the gather of the fixed side's planes."""
    ell_user, ell_item = ell_pair_cached(by_user, by_item, A.device)
    A_p = ell_ops.permute_rows(A, ell_user.perm)
    B_p = ell_ops.permute_rows(B, ell_item.perm)
    plane_dtype = ell_ops.torch_dtype(p.plane_dtype)
    status = 0
    converged_A = converged_B = False

    def half(target_p, fixed_p, ell):
        # colsums over the full padded matrix are exact: padding and empty
        # rows are identically zero
        Bsum = fixed_p.sum(0) + p.l1_reg
        planes = ell_ops.gather_planes(fixed_p, ell, plane_dtype)
        bsum_in = Bsum
        if p.w_mult != 1.0:
            bsum_in = ell_ops.adjusted_bsum_ell(planes, ell, Bsum, p.w_mult)
        return _tncg_cascade(target_p, fixed_p, planes, ell, bsum_in, p,
                             plane_dtype)

    try:
        for epoch in range(p.niter):
            if not converged_B:
                B_p, converged_B = half(B_p, A_p, ell_item)
            if not converged_A:
                A_p, converged_A = half(A_p, B_p, ell_user)
            if callback is not None:
                callback(epoch, ell_ops.permute_rows(A_p, ell_user.inv_perm),
                         ell_ops.permute_rows(B_p, ell_item.inv_perm))
            if converged_A and converged_B:
                break
    except KeyboardInterrupt:
        status = 2
        if not handle_interrupt:
            raise
    A = ell_ops.permute_rows(A_p, ell_user.inv_perm)
    B = ell_ops.permute_rows(B_p, ell_item.inv_perm)
    return A, B, status
