"""Row-sharded multi-device training on the planar-ELL layout.

Counterpart of ``poismf_tpu/parallel/ell_mesh.py``.  Each rank owns a
contiguous range of ``rps`` rows of the matrix being updated and solves
them with the single-device solvers on its own planar ELL; each
half-update all-gathers the fixed side over the mesh's group.

The per-shard layouts are unified as in the JAX package (whose
``shard_map`` needs one program for every device): one bucket per
nonzero-width level with the largest row count over the shards (a shard
without rows at a level gets an all-padding bucket), and a level carries
``src`` indirection if ANY shard needs it (identity ``src`` on the
others).  Shard-local columns index the fixed matrix in its ORIGINAL row
order.  So every rank has the same bucket geometry, hence the same
compact plans, which the tncg cascade's global round decisions need
(:func:`poismf_torch.train._tncg_cascade`).  Every rank builds all
shards' host arrays (NumPy, as the JAX package does) and moves only its
own shard to its device.

Each side's local ELL is built once a fit and carries the cascade's
state (:func:`poismf_torch.train.cascade_aux`) from half to half, as the
JAX package's ``aux_u`` / ``aux_i`` do.  A rejected tail's profile is
the maximum over the ranks of each bucket's count (the twin of the JAX
package's ``_update_se_profile``), sized in the single-device rule's
classes against all ranks' rows and slots: the JAX package compares the
rows of all devices with one device's slots, and so records on D devices
only tails of at most 1/(2D) of the rows (ROADMAP.md, Queue 3).  cg runs
without the entry-probe compaction, as the JAX package's sharded cg does.
The cascade's full and compact rounds read ``POISMF_TNCG_BD_ACCUM`` and
take 4 line-search candidates whatever ``POISMF_TNCG_LS_CAND`` says, as
the JAX package's ``_full_round_body`` / ``_compact_round_body`` do; a
tncg half without ``compact_tail`` and cg take both solvers' defaults.
The sharded fits keep no ``train.PASS_STATS`` count, as the JAX
package's keep none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import train
from ..ops import ell as ell_ops
from ..sparse import CountsMatrix
from .collectives import all_gather_rows, all_reduce_sum
from .mesh import _ceil_to, pad_rows_for_mesh

ROW_TILE = ell_ops.ROW_TILE

# When set to a list (by tests), the sharded tncg cascade appends one
# (round, structure, active_in, active_out) tuple per round, counted over
# all ranks: it shows the passes shrink once rows converge.
CASCADE_TRACE: Optional[list] = None


@dataclasses.dataclass(frozen=True)
class ShardedEll:
    """Uniform per-shard planar ELL on the host: arrays carry a leading
    shard axis (the JAX package's ``ShardedEll``, whose arrays these equal)."""

    cols: Tuple[np.ndarray, ...]  # per level [D, Rb, P] int32
    vals: Tuple[np.ndarray, ...]  # per level [D, P, Rb]
    srcs: Tuple[Optional[np.ndarray], ...]  # per level [D, Rb] int32 or None
    perm: np.ndarray  # [D, n_slots] local row id per slot (pad = rps)
    inv_perm: np.ndarray  # [D, rps] slot per local row
    row_nnz: np.ndarray  # [D, n_slots]
    Ps: Tuple[int, ...]
    Rbs: Tuple[int, ...]
    offsets: Tuple[int, ...]
    n_slots: int
    rps: int  # rows per shard
    n_shards: int
    n_rows: int  # true global rows
    n_cols: int

    def local_ell(self, d: int, device="cpu") -> ell_ops.EllMatrix:
        """Shard ``d`` as an EllMatrix of ``rps`` rows on ``device``.  A
        level with ``src`` also lists its real extension rows (``ext``:
        src neither the row's own slot nor the zero tail), so that the
        ELL ops read and assemble it as they do a single-device one."""
        def dev(a, index=True):
            a = np.ascontiguousarray(a, dtype=np.int64 if index else None)
            return torch.from_numpy(a).to(device)

        buckets, host_src, host_asm = [], [], []
        for Pw, Rb, off, c, v, s in zip(self.Ps, self.Rbs, self.offsets,
                                        self.cols, self.vals, self.srcs):
            src = ext = None
            if s is not None:
                src = s[d].astype(np.int64)
                ext = np.nonzero((src != off + np.arange(Rb))
                                 & (src != self.n_slots - 1))[0]
            host_src.append(src)
            host_asm.append((off, Rb, src, ext))
            buckets.append(ell_ops.EllBucket(
                offset=off, n_rows=Rb, P=Pw, cols=dev(c[d]),
                vals=dev(v[d], False),
                src=None if src is None else dev(src),
                ext=None if ext is None else dev(ext),
                ext_src=None if ext is None else dev(src[ext]),
            ))
        row_nnz = self.row_nnz[d].copy()
        return ell_ops.EllMatrix(
            buckets=tuple(buckets), perm=dev(self.perm[d]),
            inv_perm=dev(self.inv_perm[d]),
            row_nnz_perm=dev(row_nnz, False),
            n_rows=self.rps, n_cols=self.n_cols, nnz=0,
            n_rows_pad=self.rps, n_rows_ell=self.n_slots,
            host=dict(row_nnz_perm=row_nnz, src=host_src),
            asm=ell_ops.assembly(host_asm, self.n_slots, device),
        )


def shard_ell(X: CountsMatrix, n_shards: int) -> ShardedEll:
    """Partition a CountsMatrix into contiguous row ranges of ``rps`` rows
    and build a shape-unified planar ELL per shard (host NumPy)."""
    rows, cols, vals = X.triplets()
    rps = _ceil_to(max(X.n_rows, 1), n_shards * ROW_TILE) // n_shards
    bounds = np.searchsorted(rows, np.arange(n_shards + 1) * rps)

    locals_ = []
    for d in range(n_shards):
        lo, hi = bounds[d], bounds[d + 1]
        locals_.append(ell_ops.build_ell(
            rows[lo:hi] - d * rps, cols[lo:hi], vals[lo:hi], n_rows=rps,
            n_cols=X.n_cols, n_rows_pad=rps, dtype=vals.dtype, device="cpu",
        ))

    # ---- unify levels across shards ----
    all_P = sorted({b.P for e in locals_ for b in e.buckets}, reverse=True)
    Rbs, has_src = [], []
    for Pw in all_P:
        level = [b for e in locals_ for b in e.buckets if b.P == Pw]
        Rbs.append(max([ROW_TILE] + [b.n_rows for b in level]))
        has_src.append(any(b.src is not None for b in level))
    offsets = [int(o) for o in np.cumsum([0] + Rbs[:-1])]
    n_slots = sum(Rbs) + ROW_TILE

    D = n_shards
    lcols = [np.zeros((D, rb, Pw), dtype=np.int32)
             for Pw, rb in zip(all_P, Rbs)]
    lvals = [np.zeros((D, Pw, rb), dtype=vals.dtype)
             for Pw, rb in zip(all_P, Rbs)]
    lsrcs = [(np.full((D, rb), n_slots - 1, dtype=np.int32) if hs else None)
             for rb, hs in zip(Rbs, has_src)]
    perm = np.full((D, n_slots), rps, dtype=np.int32)
    inv_perm = np.full((D, rps), n_slots - 1, dtype=np.int32)
    row_nnz = np.zeros((D, n_slots), dtype=np.int32)

    for d, e in enumerate(locals_):
        e_perm, e_inv = e.perm.numpy(), e.inv_perm.numpy()
        # old slot -> new slot map for this shard
        old2new = np.full(e.n_rows_ell, n_slots - 1, dtype=np.int64)
        for b in e.buckets:
            noff = offsets[all_P.index(b.P)]
            old2new[b.offset:b.offset + b.n_rows] = noff + np.arange(b.n_rows)
        for b, bsrc in zip(e.buckets, e.host["src"]):
            li = all_P.index(b.P)
            noff = offsets[li]
            lcols[li][d, :b.n_rows] = b.cols.numpy()
            lvals[li][d, :, :b.n_rows] = b.vals.numpy()
            if lsrcs[li] is not None:
                lsrcs[li][d, :b.n_rows] = (
                    noff + np.arange(b.n_rows) if bsrc is None
                    else old2new[bsrc])
            sl = slice(noff, noff + b.n_rows)
            old_sl = slice(b.offset, b.offset + b.n_rows)
            perm[d, sl] = np.minimum(e_perm[old_sl], rps)  # sentinel = rps
            row_nnz[d, sl] = e.host["row_nnz_perm"][old_sl]
        inv_perm[d] = old2new[e_inv]

    return ShardedEll(
        cols=tuple(lcols), vals=tuple(lvals), srcs=tuple(lsrcs), perm=perm,
        inv_perm=inv_perm, row_nnz=row_nnz, Ps=tuple(all_P), Rbs=tuple(Rbs),
        offsets=tuple(offsets), n_slots=n_slots, rps=rps, n_shards=n_shards,
        n_rows=X.n_rows, n_cols=X.n_cols,
    )


def sharded_half_update_ell(group, p: train.FitParams, target_loc, fixed,
                            ell: ell_ops.EllMatrix, n_true: int,
                            step: float, div_step: float):
    """One half-update of this rank's rows ``target_loc`` [rps, k] (local
    row order) against the whole fixed side ``fixed`` (original row
    order, all-gathered): permute the rows into local-ELL order, run the
    single-device half-update (Bsum over ``fixed`` in its original order,
    as the JAX package sums it; for tncg the cascade, its round decisions
    taken over ``group``), unpermute.  The port of the JAX package's
    ``sharded_half_update_ell`` (cg, pg, and tncg without
    ``compact_tail``, whose early stop is the share of the ``n_true``
    true rows, over all ranks, that moved by <= 1e-4) and
    ``sharded_tncg_cascade_half`` (tncg).  Returns (new rows,
    converged)."""
    x = ell_ops.permute_rows(target_loc, ell.perm)
    x, converged = train._half_update(
        x, fixed, ell, p, ell_ops.torch_dtype(p.plane_dtype), step, div_step,
        group=group, n_true=n_true, trace=CASCADE_TRACE)
    new = ell_ops.permute_rows(x, ell.inv_perm)
    if p.method == "tncg" and not p.compact_tail and p.early_stop:
        rps = ell.n_rows_pad
        real = (torch.arange(rps, device=new.device)
                + dist.get_rank(group) * rps) < n_true
        small = ((((new - target_loc) ** 2).sum(1) <= 1e-4) & real).sum()
        converged = int(all_reduce_sum(small, group).item()) \
            / max(n_true, 1) >= 0.95
    return new, converged


def _own_rows(M, ell: ell_ops.EllMatrix, rank: int):
    """This rank's row block of ``M`` [rps * D, k], its rows without
    nonzeros (those ``inv_perm`` sends to the zero tail) set to zero.  The
    single-device driver leaves such rows out of its permuted factors, so
    they never enter a Bsum; the JAX package's sharded driver sums their
    initial values into the first half-update's Bsum, which on data with
    many empty rows parts its fit from the single-device one.  Zeroing
    them first makes a mesh fit compute what a single-device fit does."""
    rps = ell.n_rows_pad
    block = M[rank * rps:(rank + 1) * rps]
    return torch.where((ell.inv_perm < ell.n_rows_ell - 1)[:, None], block,
                       0)


def run_poismf_ell_sharded(A, B, by_user: CountsMatrix, by_item: CountsMatrix,
                           params: train.FitParams, mesh,
                           handle_interrupt: bool = True, callback=None):
    """Multi-device alternating driver on the planar-ELL layout.  Each
    rank holds its row blocks of A and B (rows without nonzeros zeroed,
    :func:`_own_rows`); each half all-gathers the fixed side, and the end
    gathers both.  pg halves its step between the halves
    (poismf.c:532) and keeps the pre-halving step in the A half's proximal
    divisor (poismf.c:511).  Returns (A, B, status) with the input row
    counts; status 2 = interrupted (a Ctrl-C reaches every rank of a
    launcher's process group, and the final gathers assume they all
    stopped)."""
    p = params.resolved()
    group = mesh.get_group()
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    su, si = shard_ell(by_user, D), shard_ell(by_item, D)
    ell_u, ell_i = su.local_ell(rank, A.device), si.local_ell(rank, A.device)
    n_a, n_b = A.shape[0], B.shape[0]
    A_loc = _own_rows(pad_rows_for_mesh(A, su.rps, D), ell_u, rank)
    B_loc = _own_rows(pad_rows_for_mesh(B, si.rps, D), ell_i, rank)
    step_size = p.initial_step
    status = 0
    converged_A = converged_B = False
    try:
        for epoch in range(p.niter):
            div_step = step_size
            if not converged_B:
                B_loc, converged_B = sharded_half_update_ell(
                    group, p, B_loc, all_gather_rows(A_loc, group), ell_i,
                    by_item.n_rows, step_size, div_step)
            if p.method == "pg":
                step_size *= 0.5
            if not converged_A:
                A_loc, converged_A = sharded_half_update_ell(
                    group, p, A_loc, all_gather_rows(B_loc, group), ell_u,
                    by_user.n_rows, step_size, div_step)
            if callback is not None:
                callback(epoch,
                         pad_rows_for_mesh(all_gather_rows(A_loc, group),
                                           n_a, 1),
                         pad_rows_for_mesh(all_gather_rows(B_loc, group),
                                           n_b, 1))
            if converged_A and converged_B:
                break
    except KeyboardInterrupt:
        status = 2
        if not handle_interrupt:
            raise
    A = pad_rows_for_mesh(all_gather_rows(A_loc, group), n_a, 1)
    B = pad_rows_for_mesh(all_gather_rows(B_loc, group), n_b, 1)
    return A, B, status
