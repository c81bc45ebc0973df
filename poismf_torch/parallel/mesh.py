"""Multi-device data parallelism over rows on ``torch.distributed``.

Counterpart of ``poismf_tpu/parallel/mesh.py``.  The JAX package runs one
controller over a ``jax.sharding.Mesh``; the port runs one process per
device (SPMD), and its mesh is a one-dimensional
``torch.distributed.device_mesh.DeviceMesh`` over them:

  * every rank calls the same fit with the same data, parameters and
    seed, so every rank ingests and initializes identically;
  * the matrix being UPDATED is sharded by contiguous row ranges, one a
    rank; each half-update all-gathers the fixed side over the mesh's
    group and every rank solves its own rows, on its planar ELL
    (:mod:`.ell_mesh`, ``layout="ell"``) or on its slice of the flat COO
    stream (:func:`shard_counts`, ``layout="coo"``);
  * after the fit every rank holds the whole of A and B.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..sparse import ROW_PAD_MULTIPLE, CountsMatrix, DeviceCounts, to_device
from .collectives import all_gather_rows, all_reduce_sum


def make_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A one-dimensional mesh over every rank of the default process
    group, which the caller has initialized (``dist.init_process_group``):
    ``"cuda"`` (NCCL, one GPU a rank) or ``"cpu"`` (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialize the default process group "
                           "first (torch.distributed.init_process_group)")
    return init_device_mesh(device_type, (dist.get_world_size(),))


def mesh_device(mesh) -> torch.device:
    """This rank's device on a one-dimensional ``DeviceMesh``: the CPU on a
    "cpu" mesh, the current CUDA device (which the mesh's set-up selects
    from ``LOCAL_RANK``) on a "cuda" mesh."""
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError("mesh must be a one-dimensional torch.distributed "
                        f"DeviceMesh (make_mesh), not {mesh!r}")
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    raise ValueError(f"mesh device type {mesh.device_type!r}: only 'cuda' "
                     "and 'cpu' meshes are supported")


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def pad_rows_for_mesh(M: torch.Tensor, rows_per_shard: int, n_shards: int
                      ) -> torch.Tensor:
    """Re-pad a factor matrix to ``rows_per_shard * n_shards`` rows (zero
    rows appended, or trailing rows dropped)."""
    target = rows_per_shard * n_shards
    if M.shape[0] >= target:
        return M[:target]
    return torch.cat([M, M.new_zeros((target - M.shape[0], M.shape[1]))])


@dataclasses.dataclass(frozen=True)
class ShardedCounts:
    """Row-partitioned flat COO on the host (the JAX package's
    ``ShardedCounts``): shard d owns rows ``[d * rows_per_shard, (d + 1) *
    rows_per_shard)``.  The arrays carry a leading shard axis; within a
    shard ``row_ids`` are local (padding = ``rows_per_shard``) and the
    edge arrays are padded to the largest shard's load, rounded up to 128;
    ``counts`` holds each shard's true edges."""

    row_ids: np.ndarray  # [D, E] int32 local ids
    col_ids: np.ndarray  # [D, E] int32
    vals: np.ndarray  # [D, E]
    row_nnz: np.ndarray  # [D, rows_per_shard] int32
    counts: np.ndarray  # [D] true edges per shard
    n_rows: int  # true global rows
    n_cols: int
    rows_per_shard: int
    n_shards: int

    def local_counts(self, d: int, device="cpu") -> DeviceCounts:
        """Shard ``d`` as a :class:`~poismf_torch.sparse.DeviceCounts` of
        ``rows_per_shard`` rows on ``device`` (columns index the whole
        fixed matrix in its original row order)."""
        return to_device(CountsMatrix(
            row_ids=self.row_ids[d], col_ids=self.col_ids[d],
            vals=self.vals[d], row_nnz=self.row_nnz[d],
            n_rows=self.rows_per_shard, n_cols=self.n_cols,
            nnz=int(self.counts[d])), device)


def shard_counts(X: CountsMatrix, n_shards: int) -> ShardedCounts:
    """Partition ``X`` into contiguous row ranges of ``rows_per_shard``
    rows (the true rows padded to ``n_shards * ROW_PAD_MULTIPLE``), host
    NumPy, as the JAX package's ``shard_counts``."""
    rows, cols, vals = X.triplets()
    rps = _ceil_to(max(X.n_rows, 1), n_shards * ROW_PAD_MULTIPLE) // n_shards
    bounds = np.searchsorted(rows, np.arange(n_shards + 1) * rps)
    per_shard = np.diff(bounds)
    E = _ceil_to(max(int(per_shard.max(initial=1)), 1), 128)
    row_ids = np.full((n_shards, E), rps, dtype=np.int32)
    col_ids = np.zeros((n_shards, E), dtype=np.int32)
    data = np.zeros((n_shards, E), dtype=vals.dtype)
    row_nnz = np.zeros((n_shards, rps), dtype=np.int32)
    for d in range(n_shards):
        lo, hi = bounds[d], bounds[d + 1]
        m = hi - lo
        row_ids[d, :m] = rows[lo:hi] - d * rps
        col_ids[d, :m] = cols[lo:hi]
        data[d, :m] = vals[lo:hi]
        row_nnz[d] = np.bincount(rows[lo:hi] - d * rps, minlength=rps)
    return ShardedCounts(row_ids=row_ids, col_ids=col_ids, vals=data,
                         row_nnz=row_nnz, counts=per_shard, n_rows=X.n_rows,
                         n_cols=X.n_cols, rows_per_shard=rps,
                         n_shards=n_shards)


def sharded_half_update(group, p, target_loc: torch.Tensor,
                        fixed: torch.Tensor, X_loc: DeviceCounts,
                        fixed_n_rows: int, n_true: int, step: float,
                        div_step: Optional[float] = None):
    """One half-update of this rank's rows ``target_loc`` [rps, k] against
    the whole fixed side ``fixed`` (all-gathered, original row order) on
    this rank's COO ``X_loc``: the single-device COO half-update
    (:func:`poismf_torch.train.half_update_coo`; for pg ``step`` and the
    proximal divisor's ``div_step``).  For tncg with ``early_stop`` the
    share of rows moved by <= 1e-4 is counted over all ``n_true`` true
    rows of every rank (one all_reduce), as the JAX package counts it on
    the gathered factors.  Returns (new rows, converged)."""
    from ..train import half_update_coo

    new, _ = half_update_coo(target_loc, fixed, X_loc, fixed_n_rows, p,
                             step, div_step)
    if p.method != "tncg" or not p.early_stop:
        return new, False
    rps = target_loc.shape[0]
    first = dist.get_rank(group) * rps
    true = torch.arange(first, first + rps, device=new.device) < n_true
    delta = new - target_loc
    small = ((((delta * delta).sum(1) <= 1e-4) & true).sum())
    all_reduce_sum(small, group)
    return new, int(small.item()) / max(n_true, 1) >= 0.95


def _run_poismf_coo_sharded(A, B, by_user: CountsMatrix,
                            by_item: CountsMatrix, p, mesh,
                            handle_interrupt: bool = True, callback=None):
    """The row-sharded alternating driver on the flat COO (the COO branch
    of the JAX package's ``run_poismf_sharded``): each rank holds its row
    blocks of A and B and its slices of both orientations; each half
    all-gathers the fixed side (its rows without nonzeros included, at
    their current values, as the JAX package sums them into Bsum)."""
    group = mesh.get_group()
    D, rank = dist.get_world_size(group), dist.get_rank(group)
    su, si = shard_counts(by_user, D), shard_counts(by_item, D)
    X_u = su.local_counts(rank, A.device)
    X_i = si.local_counts(rank, A.device)
    n_a, n_b = A.shape[0], B.shape[0]
    ru, ri = su.rows_per_shard, si.rows_per_shard
    A_loc = pad_rows_for_mesh(A, ru, D)[rank * ru:(rank + 1) * ru]
    B_loc = pad_rows_for_mesh(B, ri, D)[rank * ri:(rank + 1) * ri]
    n_users, n_items = by_user.n_rows, by_item.n_rows
    step_size = p.initial_step
    status = 0
    converged_A = converged_B = False
    try:
        for epoch in range(p.niter):
            div_step = step_size
            if not converged_B:
                B_loc, converged_B = sharded_half_update(
                    group, p, B_loc, all_gather_rows(A_loc, group), X_i,
                    n_users, n_items, step_size, div_step)
            if p.method == "pg":
                # halved between the halves (poismf.c:532); A keeps the
                # pre-halving step in its proximal divisor (poismf.c:511)
                step_size *= 0.5
            if not converged_A:
                A_loc, converged_A = sharded_half_update(
                    group, p, A_loc, all_gather_rows(B_loc, group), X_u,
                    n_items, n_users, step_size, div_step)
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


def run_poismf_sharded(
    A: torch.Tensor,
    B: torch.Tensor,
    by_user: CountsMatrix,
    by_item: CountsMatrix,
    params,
    mesh: DeviceMesh,
    handle_interrupt: bool = True,
    callback: Optional[Callable[[int, torch.Tensor, torch.Tensor], None]]
    = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Sharded alternating driver, the multi-device twin of
    :func:`poismf_torch.train.run_poismf`; every rank of ``mesh`` calls it
    with the same arguments.  A and B (this rank's copies of the initial
    factors, on :func:`mesh_device`) come back whole on every rank, with
    their input row counts.  ``layout="coo"`` runs the flat-COO driver
    (:func:`_run_poismf_coo_sharded`), any other the planar-ELL one
    (:func:`poismf_torch.parallel.ell_mesh.run_poismf_ell_sharded`)."""
    from .ell_mesh import run_poismf_ell_sharded

    dev = mesh_device(mesh)
    if A.device != dev or B.device != dev:
        raise ValueError(f"the factors are on {A.device} / {B.device}, this "
                         f"rank's mesh device is {dev}")
    p = params.resolved()
    run = (_run_poismf_coo_sharded if p.layout == "coo"
           else run_poismf_ell_sharded)
    return run(A, B, by_user, by_item, p, mesh,
               handle_interrupt=handle_interrupt, callback=callback)
