"""Alternating-optimization training driver, on the planar-ELL layout
(``layout="ell"``, the default) or on the flat COO (``layout="coo"``).

Counterpart of ``poismf_tpu/train.py``: per epoch, update B holding A fixed
(by-item orientation), then A holding B fixed (by-user orientation).

On the ELL each half-update gathers the fixed side into planes once and
runs the method's solver: for tncg the cascade (a few outer iterations on
the full structure, then the still-active tail on the smallest compact
sub-ELL that holds it), for cg one batched CG pass, on the compact
sub-ELL that holds the rows its entry probe finds still active; a pg
epoch is both halves of :func:`poismf_torch.solvers.pg.pg_epoch_ell`,
after which the step halves.  The compact plans are the ELL's cascade
state (:func:`cascade_aux`): three uniform ones, and the profile plans
sized from the tails that all of them rejected in earlier halves, so
they carry over to later halves and to later fits on the same cached
pair.  ``compact_tail=False`` runs each half as one solver call
instead.  On the COO (:func:`_run_poismf_coo`, the JAX package's
``run_poismf`` loop) each half-update is one call of the method's COO
solver over the whole stream, without a cascade: tncg with the
reference's inner-CG cap unless one is given.

Semantics carried over: ``Bsum = colsums(fixed) + l1`` before each
half-update, the weighted per-row Bsum when ``w_mult != 1``, pg's step
halved between the halves (the A half keeps the B half's proximal
divisor), and for tncg the early stop when >= 95% of rows move by <= 1e-4
(squared L2) on both sides (cg and pg run every epoch).

The single-device ELL fits keep the JAX package's accounting of what
they read: :data:`PASS_STATS` (a ``(sweeps, bytes a sweep)`` entry per
plane gather, compact build and solver call) and :data:`CG_STATS` (one
dict a cg half), and ``POISMF_CASCADE_LOG=1`` (``2``: with each bucket's
active rows) prints one stderr line a cascade round, in the JAX
package's format.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .ops import ell as ell_ops
from .ops import objective as obj
from .parallel.collectives import all_reduce_max, all_reduce_sum
from .sparse import CountsMatrix, DeviceCounts, to_device
from .solvers.cg import (_cg_ray_default, cg_probe_ell, cg_update,
                         cg_update_ell)
from .solvers.pg import pg_epoch_ell, pg_update, pg_update_ell
from .solvers.tncg import LS_CAND_DEFAULT, tncg_update, tncg_update_ell
from .utils import profiling

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

# Profile plans built per size class at most (the JAX package's bound).
MAX_ADAPTIVE_REBUILDS = 3


class CascadeRound(NamedTuple):
    """One round of a half-update in a cascade trace (cg: its probe).
    Counts are over all ranks; ``denom`` is the compact plan's divisor (0
    for a profile plan, None on the full structure) and ``plans`` the
    caps of the profile plans in use, by size class."""

    rnd: int
    structure: str
    n_in: int
    n_out: int
    denom: Optional[int]
    plans: dict


# When set to a list, the single-device ELL fits append every half's
# CascadeRound entries (round 0 starts a half).
CASCADE_TRACE: Optional[list] = None

# When set to a list, the single-device ELL fits append one (sweeps,
# bytes a sweep) entry per plane gather, compact build and solver call,
# where the JAX package's driver appends it: ``sweeps`` a host float (the
# solvers count theirs from their loop counters), so the list costs no
# sync; sum(sweeps * bytes) over a fit is what it read, a model of the
# traffic (``_sweep_bytes``), not a measurement.
PASS_STATS: Optional[list] = None

# When set to a list, each cg half of a single-device ELL fit appends one
# dict: ``rows`` (the ELL's true rows), ``active`` (rows active at the
# entry probe; None where no probe ran), ``denom`` (the compact plan's
# divisor, 0 a profile plan; None on the full structure) and ``probed``.
CG_STATS: Optional[list] = None


def _ell_padded_nnz(ell: ell_ops.EllMatrix) -> int:
    return sum(b.n_rows * b.P for b in ell.buckets)


def _sweep_bytes(padded_nnz: int, k: int, plane_itemsize: int) -> float:
    """Bytes read by one full sweep of an orientation: the bg planes
    [k, P, R] and the vals planes [P, R] (f32)."""
    return float(padded_nnz) * (k * plane_itemsize + 4.0)


def _gather_bytes(ell: ell_ops.EllMatrix, k: int,
                  plane_itemsize: int) -> float:
    """One plane gather: the fixed side's rows read at random (nnz * k *
    4) and the planes written."""
    return float(ell.nnz) * k * 4.0 + _ell_padded_nnz(ell) * k * float(
        plane_itemsize)


def _plan_padded_nnz(ell: ell_ops.EllMatrix, plan) -> int:
    return sum(c * b.P for c, b in zip(plan.caps, ell.buckets))


def _plane_itemsize(plane_dtype, x: torch.Tensor) -> int:
    """Bytes of a plane entry: the plane dtype's, else the factors'."""
    return (plane_dtype.itemsize if plane_dtype is not None
            else x.dtype.itemsize)


def _count(group, sweeps, nbytes: float) -> None:
    """One PASS_STATS entry, on a single-device fit (the JAX package's
    sharded drivers keep no count)."""
    if PASS_STATS is not None and group is None:
        PASS_STATS.append((sweeps, nbytes))


def _cascade_logger(ell: ell_ops.EllMatrix):
    """``POISMF_CASCADE_LOG=1``: a function that prints one stderr line a
    cascade round (its wall since the last line, structure, active rows
    in and out, and with the solver's stats its passes, outer iterations,
    LS and HVP rounds); ``=2`` replaces the stats by each bucket's
    active rows out.  Unset: a function that does nothing.  Its inputs are
    on the host already, bar the stats' counts, which the solvers keep
    there."""
    mode = os.environ.get("POISMF_CASCADE_LOG")
    if not mode:
        return lambda *a, **kw: None
    t_last = [time.time()]
    n = ell.n_rows_ell

    def log(rnd, structure, last, active, act_next, stats=None):
        now = time.time()
        n_in = n if active is None else int(np.count_nonzero(active))
        n_out = 0 if act_next is None else int(np.count_nonzero(act_next))
        extra = ""
        if stats is not None:
            extra += (f"  passes={float(stats['passes']):.0f}"
                      f" it={int(stats['outer_iters'])}"
                      f" ls={int(stats['ls_rounds'])}"
                      f" hvp={int(stats['hvp_rounds'])}")
        if mode == "2" and act_next is not None:
            per = _bucket_active_counts(ell, cascade_aux(ell), act_next)
            extra = "  per-bucket " + " ".join(
                f"P{b.P}:{c}/{b.n_rows}" for b, c in zip(ell.buckets, per))
        print(f"#   cascade[{ell.n_rows}r] rnd {rnd} {structure:>10} "
              f"{'final ' if last else ''}{n_in} -> {n_out} active "
              f"({now - t_last[0]:.2f}s){extra}", file=sys.stderr,
              flush=True)
        t_last[0] = now

    return log


@dataclasses.dataclass
class FitParams:
    """Hyperparameters, with the same "auto" tables as the reference."""

    k: int = 50
    method: str = "tncg"
    l2_reg: float = "auto"  # type: ignore[assignment]
    l1_reg: float = 0.0
    niter: int = "auto"  # type: ignore[assignment]
    maxupd: int = "auto"  # type: ignore[assignment]
    limit_step: bool = True  # cg: step capped at the first zero crossing
    initial_step: float = 1e-7  # pg: first epoch's step, halved per epoch
    early_stop: bool = True
    reuse_prev: bool = False
    w_mult: float = 1.0
    nnz_chunk: Optional[int] = None  # COO: entries per chunk of the stream
    layout: str = "auto"
    plane_dtype: Optional[str] = None
    max_cg: Optional[int] = "auto"  # type: ignore[assignment]
    # ELL: tncg's cascade and cg's probe compaction (False: one solver
    # call a half, tncg with its unchanged-share early stop)
    compact_tail: bool = True

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
            # the tight cap relies on the cascade's final uncapped rounds:
            # a fit without the cascade takes the reference's maxCGit
            p.max_cg = 3 if (p.method == "tncg" and p.compact_tail
                             and p.layout == "ell") else None
        if p.max_cg is not None:
            p.max_cg = int(p.max_cg)
            if p.max_cg < 1:
                raise ValueError("max_cg must be a positive integer or None")
        if not (p.k > 0 and p.niter >= 1 and p.maxupd >= 1):
            raise ValueError("k, niter and maxupd must be positive")
        if not (p.l2_reg >= 0 and p.l1_reg >= 0):
            raise ValueError("l2_reg and l1_reg must be non-negative")
        if not (p.w_mult > 0 and p.initial_step > 0):
            raise ValueError("w_mult and initial_step must be positive")
        if p.nnz_chunk is not None:
            p.nnz_chunk = int(p.nnz_chunk)
            if p.nnz_chunk < 1:
                raise ValueError("nnz_chunk must be a positive integer or "
                                 "None")
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
    return profiling.to_device(M, device, "fit.init")


def initialize_factors_device(n_rows: int, n_rows_pad: int, k: int,
                              seed: int, device="cuda") -> torch.Tensor:
    """The same distribution as :func:`initialize_factors`, 0.3 + U(0,
    0.01) with padded rows zero, drawn on ``device`` by a
    ``torch.Generator`` seeded with ``seed``: only the seed crosses to the
    device.  Like the JAX package's, its stream is not the host draw's."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    M = 0.3 + 0.01 * torch.rand((n_rows_pad, k), generator=gen,
                                dtype=torch.float32, device=device)
    rows = torch.arange(n_rows_pad, device=device)[:, None] < n_rows
    return torch.where(rows, M, 0.0)


def cascade_aux(ell: ell_ops.EllMatrix) -> dict:
    """``ell``'s cascade state, made at its first half-update and kept in
    ``ell.host`` for the ELL's lifetime, as the JAX package keeps its
    ``_ELL_AUX`` beside the cached pair: the compact plans, cheapest
    first (the uniform ones, then also profile plans), the host copies of
    the per-slot nnz and the buckets' ``src``, and the rejected-tail
    profiles with the profile plans built from them, by size class.  A
    fit on the same cached pair (or, on a mesh, the fit's next half of
    the same side) starts from what earlier halves built."""
    aux = ell.host.get("cascade")
    if aux is None:
        aux = ell.host["cascade"] = dict(
            plans=[ell_ops.plan_compact(ell, d) for d in COMPACT_DENOMS],
            row_nnz=ell.host["row_nnz_perm"],
            src=list(ell.host["src"]),
            profiles={}, adaptive_caps={}, adaptive_rebuilds={},
            adaptive_plans={},
        )
    return aux


def _bucket_active_counts(ell: ell_ops.EllMatrix, aux: dict,
                          active: np.ndarray) -> np.ndarray:
    """Per bucket, the rows of ``active`` it holds (extension chunks
    follow their primary's activity)."""
    return np.array([np.count_nonzero(active[b.offset:b.offset + b.n_rows]
                                      if s is None else active[s])
                     for b, s in zip(ell.buckets, aux["src"])],
                    dtype=np.int64)


def _update_profile(ell: ell_ops.EllMatrix, aux: dict, active: np.ndarray,
                    n_active: int, group=None) -> None:
    """Record a tail that every plan rejected: its per-bucket counts join
    (elementwise max) the profile of its size class, "small" up to 1/6 of
    the rows, "mid" up to 1/2; larger tails are not recorded.  On a mesh
    ``n_active`` counts all ranks' rows against all ranks' slots, and the
    counts are the maximum over the ranks (one all_reduce, which every
    rank reaches, as each takes the same rejection from the same
    counts)."""
    n = ell.n_rows_ell * (1 if group is None
                          else dist.get_world_size(group))
    if n_active > n // 2:
        return
    cls = "small" if n_active <= n // 6 else "mid"
    counts = _bucket_active_counts(ell, aux, active)
    if group is not None:
        counts = all_reduce_max(torch.from_numpy(counts).to(ell.device),
                                group).cpu().numpy()
    prof = aux["profiles"].get(cls)
    aux["profiles"][cls] = counts if prof is None else np.maximum(prof,
                                                                  counts)


def _maybe_build_adaptive_plan(ell: ell_ops.EllMatrix, aux: dict) -> None:
    """Per size class, a profile plan (2x its profile,
    :func:`~poismf_torch.ops.ell.plan_compact_from_profile`) once the
    class has a profile that its current plan, if any, does not cover, at
    most MAX_ADAPTIVE_REBUILDS times a class; then the plans re-sorted by
    cost (``sum(cap * P)``), so a profile plan may become the cheapest.
    ``POISMF_ADAPTIVE_PLAN=0`` turns it off, read per call."""
    if os.environ.get("POISMF_ADAPTIVE_PLAN") == "0":
        return
    rebuilt = False
    for cls, prof in aux["profiles"].items():
        caps = aux["adaptive_caps"].get(cls)
        if caps is not None and np.all(prof <= caps):
            continue
        if aux["adaptive_rebuilds"].get(cls, 0) >= MAX_ADAPTIVE_REBUILDS:
            continue
        plan = ell_ops.plan_compact_from_profile(ell, prof)
        if plan is None:
            continue
        aux["adaptive_rebuilds"][cls] = \
            aux["adaptive_rebuilds"].get(cls, 0) + 1
        aux["adaptive_caps"][cls] = np.asarray(plan.caps)
        aux["adaptive_plans"][cls] = plan
        rebuilt = True
    if rebuilt:
        plans = ([pl for pl in aux["plans"] if pl.denom != 0]
                 + list(aux["adaptive_plans"].values()))
        plans.sort(key=lambda pl: sum(c * b.P for c, b in zip(pl.caps,
                                                              ell.buckets)))
        aux["plans"] = plans


def _plans_built(aux: dict) -> dict:
    return {cls: plan.caps for cls, plan in aux["adaptive_plans"].items()}


# One-entry caches of each layout's pair, keyed on the identity of the
# host index arrays (pinned in the entry, so a recycled id can never alias
# it) and the device: repeated fits on the same data skip the O(nnz) host
# build.
_ELL_CACHE: dict = {}
_COO_CACHE: dict = {}


def _pair_cached(cache: dict, build, by_user: CountsMatrix,
                 by_item: CountsMatrix, device):
    referents = (by_user.row_ids, by_user.col_ids, by_user.vals,
                 by_item.row_ids, by_item.col_ids, by_item.vals)
    key = tuple(id(a) for a in referents) + (str(torch.device(device)),)
    entry = cache.get(key)
    if entry is None:
        pair = build(by_user, by_item, device)
        cache.clear()
        cache[key] = (pair, referents)
        return pair
    return entry[0]


def ell_pair_cached(by_user: CountsMatrix, by_item: CountsMatrix, device):
    """Both orientations' planar ELL on ``device`` (cached)."""
    return _pair_cached(
        _ELL_CACHE, lambda u, i, d: ell_ops.ell_pair_from_counts(
            u, i, device=d), by_user, by_item, device)


def coo_pair_cached(by_user: CountsMatrix, by_item: CountsMatrix, device):
    """Both orientations as :class:`~poismf_torch.sparse.DeviceCounts` on
    ``device`` (cached, with the row-sum plans they build)."""
    return _pair_cached(
        _COO_CACHE, lambda u, i, d: (to_device(u, d), to_device(i, d)),
        by_user, by_item, device)


def _compact_round(x_full, fixed, ell, bsum_in, sel, plan, plane_dtype,
                   max_outer: int, p: FitParams, max_cg, nfe_full,
                   group=None):
    """One cascade round on a compact sub-ELL: build it (edge data and
    planes gathered on the device), solve, and scatter the rows and their
    carried feval counts back into the full ELL space.  As the JAX
    package's compact rounds, it takes ``bd_accum``'s default and 4
    line-search candidates whatever ``POISMF_TNCG_LS_CAND`` says.
    Returns (x, active, nfeval, the solver's stats)."""
    sels, src_cs, slot_map, row_nnz_c, _ = sel
    with profiling.span("cascade.build"):
        compact = ell_ops.build_compact(ell, plan, sels, src_cs, slot_map,
                                        row_nnz_c)
        planes_c = ell_ops.gather_planes(fixed, compact, plane_dtype)
    slot_map_d = compact.perm
    bsum_c = bsum_in if bsum_in.dim() == 1 else bsum_in[slot_map_d]
    x_new, _, st = tncg_update_ell(
        x_full[slot_map_d], planes_c, compact, bsum_c,
        l2_reg=p.l2_reg, w_mult=p.w_mult, maxupd=p.maxupd,
        reuse_prev=True,  # compact rounds always continue from x
        max_outer=max_outer, return_stats=True,
        nfeval0=nfe_full[slot_map_d], max_cg=max_cg,
        ls_cand=LS_CAND_DEFAULT,
    )
    # the build gathers the round's planes and edge data from the
    # parent's, then the solver sweeps the compact planes
    k = x_full.shape[1]
    it = 2 if plane_dtype == torch.bfloat16 else x_full.dtype.itemsize
    padded = _plan_padded_nnz(ell, plan)
    _count(group, 1.0, 2.0 * padded * (k * it + 4.0))
    _count(group, st["passes"], _sweep_bytes(padded, k, it))
    with profiling.span("cascade.build"):
        x_out = ell_ops.scatter_back(x_full, x_new, slot_map_d,
                                     compact.row_nnz_perm)
        # fill slots all map to the parent zero tail and write its own
        # value
        nfe_out = nfe_full.clone()
        nfe_out[slot_map_d] = torch.where(compact.row_nnz_perm > 0,
                                          st["nfeval"], nfe_full[slot_map_d])
    return x_out, st["active"], nfe_out, st


def _round_decisions(aux: dict, ell: ell_ops.EllMatrix, active: np.ndarray,
                     group) -> List[int]:
    """What the next cascade round is decided by, from this rank's
    ``active`` mask: per compact plan of ``aux["plans"]`` (cheapest
    first) the number of ranks whose tail it holds (``select_active``
    would not refuse it), then the number of active rows, both summed
    over the ranks of ``group`` in one all_reduce (no group: this
    process's own counts)."""
    n = _bucket_active_counts(ell, aux, active)
    v = [int(np.all(n <= np.asarray(plan.caps))) for plan in aux["plans"]]
    v.append(int(np.count_nonzero(active)))
    if group is None:
        return v
    t = torch.tensor(v, dtype=torch.int64, device=ell.device)
    return all_reduce_sum(t, group).tolist()


def _tncg_cascade(target_p, fixed, planes, ell, bsum_in, p: FitParams,
                  plane_dtype, group=None, n_true: Optional[int] = None,
                  trace: Optional[list] = None, swb: float = 0.0):
    """One tncg half-update by the annealing cascade; returns
    (new target, converged).

    On a row-sharded fit ``group`` is the mesh's process group and
    ``ell`` this rank's rows (every rank's ELL has the same bucket
    geometry, so the same compact plans), and each decision is taken over
    all ranks, as one controller would take it: a compact plan only if
    every rank's tail fits it, the round length from the active rows of
    all ranks, the end once no rank has an active row, and the early stop
    from the share of all ``n_true`` true rows (default ``ell.n_rows``).
    The plans are ``ell``'s :func:`cascade_aux`: at the start of the half
    a profile plan is built for each size class whose rejected tails
    outgrew its plan, and every round whose tail no plan holds records
    the tail's profile.  ``trace`` (a list), when given, gets one
    :class:`CascadeRound` per round; a single-device half also logs it
    (:func:`_cascade_logger`) and counts each full round's sweeps at
    ``swb`` bytes.  As the JAX package's, the single-device full rounds
    take ``ls_cand``'s default, the compact rounds and a mesh's rounds 4
    line-search candidates."""
    aux = cascade_aux(ell)
    log = _cascade_logger(ell) if group is None else None
    with profiling.span("cascade.host"):
        _maybe_build_adaptive_plan(ell, aux)
    n_ranks = 1 if group is None else dist.get_world_size(group)
    n_total = n_ranks * ell.n_rows_ell
    unbounded = max(4, p.maxupd // 3)  # the solver's own default cap
    x = target_p
    active, fits, n_in = None, None, n_total  # None = all rows (round 0)
    # per-row feval budget, threaded across rounds
    nfe = torch.zeros((ell.n_rows_ell,), dtype=torch.int32, device=ell.device)
    for rnd in range(MAX_ROUNDS):
        with profiling.span("cascade.round"):
            last = rnd == MAX_ROUNDS - 1
            plan = sel = mask = None
            if active is not None:  # cheapest first
                with profiling.span("cascade.host"):
                    plan = next((pl for pl, f in zip(aux["plans"], fits)
                                 if f == n_ranks), None)
                    if plan is None:  # its shape sizes the next half's plans
                        _update_profile(ell, aux, active, n_in, group)
                        mask = profiling.to_device(active, ell.device,
                                                   "cascade.mask")
                    else:
                        sel = ell_ops.select_active(ell, plan, active,
                                                    aux["row_nnz"],
                                                    aux["src"])
            if plan is not None:
                # a tail that fits the smallest capacity is cheap enough to
                # finish in one unbounded solve
                if plan is aux["plans"][0]:
                    last = True
                x, _, nfe, st = _compact_round(
                    x, fixed, ell, bsum_in, sel, plan, plane_dtype,
                    unbounded if last else ROUND_ITERS, p,
                    None if last else p.max_cg, nfe, group,
                )
                structure = f"compact/{plan.denom}"
            else:
                bounded = (BIG_ITERS if n_in / max(n_total, 1) > BIG_SHARE
                           else ROUND_ITERS)
                x, _, st = tncg_update_ell(
                    x, planes, ell, bsum_in,
                    l2_reg=p.l2_reg, w_mult=p.w_mult, maxupd=p.maxupd,
                    reuse_prev=(p.reuse_prev if rnd == 0 else True),
                    max_outer=(unbounded if last
                               else (ROUND0_ITERS if rnd == 0 else bounded)),
                    return_stats=True, active_mask=mask, nfeval0=nfe,
                    # final rounds polish with the reference maxCGit
                    max_cg=None if last else p.max_cg,
                    ls_cand=None if group is None else LS_CAND_DEFAULT,
                )
                _count(group, st["passes"], swb)
                nfe = st["nfeval"]
                structure = "full"
            act_next, n_out = None, 0
            if not last:
                with profiling.span("cascade.host"):
                    act = profiling.host(st["active"], "cascade.mask").numpy()
                    if plan is None:
                        act_next = act
                    else:  # compact slots back to the full ELL's
                        sm = sel[2]
                        act_next = np.zeros(ell.n_rows_ell, dtype=bool)
                        act_next[sm[act & (sm != ell.n_rows_ell - 1)]] = True
                    *fits, n_out = _round_decisions(aux, ell, act_next, group)
            if trace is not None:
                trace.append(CascadeRound(rnd, structure, n_in, n_out,
                                          None if plan is None else plan.denom,
                                          _plans_built(aux)))
            if log is not None:
                log(rnd, structure, last, active, act_next, stats=st)
        if n_out == 0:
            break
        active, n_in = act_next, n_out
    if not p.early_stop:
        return x, False
    with profiling.span("cascade.host"):
        has = ell.row_nnz_perm > 0
        before = torch.where(has[:, None], target_p, 0.0)
        small = ((((x - before) ** 2).sum(1) <= 1e-4) & has).sum()
        if group is not None:
            all_reduce_sum(small, group)
        n_small = int(profiling.host(small, "cascade.early_stop"))
    n_true = ell.n_rows if n_true is None else n_true
    return x, n_small / max(n_true, 1) >= 0.95


def _half_update(target_p, fixed, ell, p: FitParams, plane_dtype,
                 step: Optional[float] = None,
                 div_step: Optional[float] = None, group=None,
                 n_true: Optional[int] = None, trace: Optional[list] = None):
    """One half-update of ``target_p`` (rows in ``ell``'s permuted order)
    against ``fixed``, the rows ``ell``'s columns index: ``Bsum =
    colsums(fixed) + l1`` (exact over a padded matrix: padding and empty
    rows are zero), the fixed side's planes gathered once, then the
    method's solver: pg's ``maxupd`` steps at ``step`` with the proximal
    divisor of ``div_step``, one batched cg pass (with ``compact_tail``,
    ``limit_step`` and no ``group``: :func:`_cg_compact_half`), or the
    tncg cascade (``group``, ``n_true`` and ``trace`` as in
    :func:`_tncg_cascade`; without ``compact_tail`` one solver call, the
    early stop from its unchanged share, which a mesh takes over all
    ranks itself).  A single-device half counts its plane gather and
    solves in :data:`PASS_STATS`.  Returns (new target, converged)."""
    with profiling.span("ell.gather"):
        Bsum = fixed.sum(0) + p.l1_reg
        planes = ell_ops.gather_planes(fixed, ell, plane_dtype)
        bsum_in = Bsum
        if p.w_mult != 1.0:
            bsum_in = ell_ops.adjusted_bsum_ell(planes, ell, Bsum, p.w_mult)
    if p.method == "pg":
        return pg_update_ell(target_p, planes, ell, bsum_in, p.l2_reg, step,
                             w_mult=p.w_mult, maxupd=p.maxupd,
                             div_step=div_step), False
    k = target_p.shape[1]
    plane_it = _plane_itemsize(plane_dtype, target_p)
    swb = _sweep_bytes(_ell_padded_nnz(ell), k, plane_it)
    _count(group, 1.0, _gather_bytes(ell, k, plane_it))
    if p.method == "cg":
        # the probe seeds a ray solve: without the ray route (limit_step
        # off, or POISMF_CG_RAY=0) the half runs uncompacted
        if (p.compact_tail and p.limit_step and _cg_ray_default()
                and group is None):
            return _cg_compact_half(target_p, fixed, planes, ell, bsum_in, p,
                                    plane_dtype, trace, swb), False
        if CG_STATS is not None and group is None:
            CG_STATS.append(dict(rows=ell.n_rows, active=None, denom=None,
                                 probed=False))
        new, passes = cg_update_ell(
            target_p, planes, ell, bsum_in, l2_reg=p.l2_reg,
            w_mult=p.w_mult, maxupd=p.maxupd, limit_step=p.limit_step,
            return_passes=True)
        _count(group, passes, swb)
        return new, False
    if not p.compact_tail:
        new, share, st = tncg_update_ell(
            target_p, planes, ell, bsum_in, l2_reg=p.l2_reg, w_mult=p.w_mult,
            maxupd=p.maxupd, reuse_prev=p.reuse_prev, return_stats=True,
            max_cg=p.max_cg)
        _count(group, st["passes"], swb)
        return new, p.early_stop and group is None and share >= 0.95
    return _tncg_cascade(target_p, fixed, planes, ell, bsum_in, p,
                         plane_dtype, group=group, n_true=n_true, trace=trace,
                         swb=swb)


def _cg_compact_build(x_full, fixed, ell, bsum_in, init, sel, plan,
                      plane_dtype):
    """The compact sub-ELL of cg's tail: its edge data and planes, the
    rows' iterates and (weighted) Bsum, and the probe's ``(f, g, px)``
    gathered into it (px's fill rows zero), so that the compact solve
    starts where the probe left off."""
    sels, src_cs, slot_map, row_nnz_c, _ = sel
    compact = ell_ops.build_compact(ell, plan, sels, src_cs, slot_map,
                                    row_nnz_c)
    planes_c = ell_ops.gather_planes(fixed, compact, plane_dtype)
    sm = compact.perm
    bsum_c = bsum_in if bsum_in.dim() == 1 else bsum_in[sm]
    f0, g0, px0 = init
    px_c = []
    for b, px, sel_b in zip(ell.buckets, px0, sels):
        sel_d = profiling.to_device(sel_b, ell.device, "cascade.build")
        px_c.append(torch.where((sel_d < b.n_rows)[None, :],
                                px[:, sel_d.clamp(max=b.n_rows - 1)], 0.0))
    return compact, planes_c, x_full[sm], bsum_c, (f0[sm], g0[sm],
                                                   tuple(px_c))


def _cg_compact_half(target_p, fixed, planes, ell, bsum_in, p: FitParams,
                     plane_dtype, trace: Optional[list] = None,
                     swb: float = 0.0):
    """cg's half-update with the JAX package's entry-probe compaction: one
    probe sweep (:func:`~poismf_torch.solvers.cg.cg_probe_ell`) gives
    the solver's init and the rows still active at entry; the iterations
    run on the cheapest plan of :func:`cascade_aux` that holds those rows,
    then scatter back.  cg's rows are independent, so the result is the
    uncompacted solve's.  A tail that no plan holds is recorded as the
    cascade records one, and the solve runs on the full structure from
    the probe's init.  ``trace`` gets one :class:`CascadeRound`, the
    cascade log one line, :data:`CG_STATS` one dict, and
    :data:`PASS_STATS` the probe, the build and the solve (a full sweep
    ``swb`` bytes)."""
    with profiling.span("cascade.round"):
        aux = cascade_aux(ell)
        kw = dict(l2_reg=p.l2_reg, w_mult=p.w_mult, maxupd=p.maxupd,
                  limit_step=p.limit_step, return_passes=True)
        k = target_p.shape[1]
        plane_it = _plane_itemsize(plane_dtype, target_p)
        f0, g0, px0, active_d = cg_probe_ell(target_p, planes, ell, bsum_in,
                                             p.l2_reg, w_mult=p.w_mult)
        _count(None, 1.0 + 4.0 / (k * plane_it + 4.0), swb)  # fg with px
        with profiling.span("cascade.host"):
            active = profiling.host(active_d, "cascade.mask").numpy()
            n_active = int(np.count_nonzero(active))
            sel = plan = None
            for plan in aux["plans"]:  # cheapest first
                sel = ell_ops.select_active(ell, plan, active, aux["row_nnz"],
                                            aux["src"])
                if sel is not None:
                    break
        structure = "full/init" if sel is None else f"compact/{plan.denom}"
        if trace is not None:
            trace.append(CascadeRound(
                0, structure, ell.n_rows_ell, n_active,
                None if sel is None else plan.denom, _plans_built(aux)))
        _cascade_logger(ell)(0, structure, True, None, active)
        if CG_STATS is not None:
            CG_STATS.append(dict(rows=ell.n_rows, active=n_active,
                                 denom=None if sel is None else plan.denom,
                                 probed=True))
        if sel is None:
            with profiling.span("cascade.host"):
                _update_profile(ell, aux, active, n_active)
                _maybe_build_adaptive_plan(ell, aux)
            new, passes = cg_update_ell(target_p, planes, ell, bsum_in,
                                        init=(f0, g0, px0), **kw)
            _count(None, passes, swb)
            return new
        with profiling.span("cascade.build"):
            compact, planes_c, x_c, bsum_c, init_c = _cg_compact_build(
                target_p, fixed, ell, bsum_in, (f0, g0, px0), sel, plan,
                plane_dtype)
        out_c, passes = cg_update_ell(x_c, planes_c, compact, bsum_c,
                                      init=init_c, **kw)
        padded_c = _plan_padded_nnz(ell, plan)
        _count(None, 1.0, 2.0 * padded_c * (k * plane_it + 4.0))
        _count(None, passes, _sweep_bytes(padded_c, k, plane_it))
        with profiling.span("cascade.build"):
            new = ell_ops.scatter_back(target_p, out_c, compact.perm,
                                       compact.row_nnz_perm)
            # the scatter writes the selected rows only: rows without nonzeros
            # come back zero, as the reference zeroes them every half
            return torch.where((ell.row_nnz_perm > 0)[:, None], new, 0.0)


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
    run = _run_poismf_coo if p.layout == "coo" else _run_poismf_ell
    with profiling.span("fit"):
        return run(A, B, by_user, by_item, p, handle_interrupt, callback)


def _run_poismf_ell(A, B, by_user, by_item, p: FitParams,
                    handle_interrupt: bool = True, callback=None):
    """Fit on the planar-ELL layout: both factor matrices live in their
    nnz-sorted permuted row order for the whole fit, so the only per-half
    setup is the gather of the fixed side's planes."""
    ell_user, ell_item = ell_pair_cached(by_user, by_item, A.device)
    A_p = ell_ops.permute_rows(A, ell_user.perm)
    B_p = ell_ops.permute_rows(B, ell_item.perm)
    plane_dtype = ell_ops.torch_dtype(p.plane_dtype)
    plane_it = _plane_itemsize(plane_dtype, A_p)
    status = 0
    step_size = p.initial_step
    converged_A = converged_B = False

    try:
        for epoch in range(p.niter):
            if p.method == "pg":
                A_p, B_p = pg_epoch_ell(
                    A_p, B_p, ell_user, ell_item, p.l2_reg, step_size,
                    p.l1_reg, maxupd=p.maxupd, w_mult=p.w_mult,
                    plane_dtype=plane_dtype,
                )
                # per half, one plane gather and maxupd gradient sweeps
                for e in (ell_item, ell_user):
                    _count(None, 1.0, _gather_bytes(e, p.k, plane_it))
                    _count(None, float(p.maxupd),
                           _sweep_bytes(_ell_padded_nnz(e), p.k, plane_it))
                step_size *= 0.5
            else:
                if not converged_B:
                    with profiling.span("half.items"):
                        B_p, converged_B = _half_update(
                            B_p, A_p, ell_item, p, plane_dtype,
                            trace=CASCADE_TRACE)
                if not converged_A:
                    with profiling.span("half.users"):
                        A_p, converged_A = _half_update(
                            A_p, B_p, ell_user, p, plane_dtype,
                            trace=CASCADE_TRACE)
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



def half_update_coo(target, fixed, X: DeviceCounts, fixed_n_rows: int,
                    p: FitParams, step: float = 0.0,
                    div_step: Optional[float] = None,
                    early_stop: bool = False):
    """One half-update of ``target`` (rows of ``X``) against ``fixed`` on
    the flat COO, the JAX package's COO ``_half_update``: ``Bsum`` over
    the first ``fixed_n_rows`` rows of ``fixed`` (rows without nonzeros
    included, at whatever value they hold) plus l1, weighted per row when
    ``w_mult != 1``; then pg's ``maxupd`` steps at ``step`` with the
    proximal divisor of ``div_step``, one cg pass, or one tncg pass.
    Returns (new target, converged): tncg's unchanged share >= 0.95 when
    ``early_stop``."""
    Bsum = obj.make_bsum(fixed, fixed_n_rows, p.l1_reg)
    if p.w_mult != 1.0:
        Bsum = obj.adjusted_bsum(fixed, Bsum, X, p.w_mult)
    if p.method == "pg":
        return pg_update(target, fixed, X, Bsum, p.l2_reg, step,
                         w_mult=p.w_mult, maxupd=p.maxupd,
                         nnz_chunk=p.nnz_chunk, div_step=div_step), False
    if p.method == "cg":
        return cg_update(target, fixed, X, Bsum, l2_reg=p.l2_reg,
                         w_mult=p.w_mult, maxupd=p.maxupd,
                         limit_step=p.limit_step,
                         nnz_chunk=p.nnz_chunk), False
    new, share = tncg_update(target, fixed, X, Bsum, l2_reg=p.l2_reg,
                             w_mult=p.w_mult, maxupd=p.maxupd,
                             reuse_prev=p.reuse_prev,
                             track_unchanged=early_stop,
                             nnz_chunk=p.nnz_chunk, max_cg=p.max_cg)
    return new, early_stop and share >= 0.95


def _run_poismf_coo(A, B, by_user, by_item, p: FitParams,
                    handle_interrupt: bool = True, callback=None):
    """Fit on the flat COO: both orientations on the fit's device once,
    then per epoch the B half and the A half, each one solver call over
    every row (the JAX package's ``run_poismf`` loop)."""
    X_user, X_item = coo_pair_cached(by_user, by_item, A.device)
    n_users, n_items = by_user.n_rows, by_item.n_rows
    step_size = p.initial_step
    status = 0
    converged_A = converged_B = False
    try:
        for epoch in range(p.niter):
            div_step = step_size
            if not converged_B:
                with profiling.span("half.items"):
                    B, converged_B = half_update_coo(
                        B, A, X_item, n_users, p, step_size,
                        early_stop=p.early_stop)
            if p.method == "pg":
                # halved between the halves (poismf.c:532); the A half
                # keeps the B half's proximal divisor (poismf.c:511)
                step_size *= 0.5
            if not converged_A:
                with profiling.span("half.users"):
                    A, converged_A = half_update_coo(
                        A, B, X_user, n_items, p, step_size,
                        div_step=div_step if p.method == "pg" else None,
                        early_stop=p.early_stop)
            if callback is not None:
                callback(epoch, A, B)
            if converged_A and converged_B:
                break
    except KeyboardInterrupt:
        status = 2
        if not handle_interrupt:
            raise
    return A, B, status
