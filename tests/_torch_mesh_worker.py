"""Rank worker of ``tests/test_torch_mesh.py``: row-sharded fits of the
PyTorch port on a gloo mesh of CPU processes.

Spawned ranks import this module alone (numpy, torch and poismf_torch:
no JAX, no ``tests/conftest.py``).  :func:`run` is one rank of a 2-rank
mesh; it writes what it computed to ``<out>/rank<r>.npz``, and rank 0
then also fits on a 1-rank mesh and without one.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

K = 6
# 300 users split over both ranks (rows per shard 256: users 0-255 on
# rank 0, 256-299 on rank 1); 60 items, all on rank 0 (rank 1 holds only
# padding rows).  Users 0-2 get 40 more items each, and P_MAX is 16, so
# both orientations hold long-row extension chunks, and a level of the
# user side carries src on rank 0 and an identity src on rank 1.  Users
# 250-259 (on both ranks) and item 59 have no nonzeros.
N_USERS, N_ITEMS = 300, 60
P_MAX = 16
EMPTY_USERS, EMPTY_ITEM = range(250, 260), 59
# The fits of both packages (float64; the JAX package's sharded test
# problems, tests/test_sharding.py, at 2 epochs, tncg at 1).
FITS = {
    "pg": dict(l2_reg=1.0, niter=2, maxupd=5, initial_step=1e-3),
    "cg": dict(l2_reg=1.0, niter=2, maxupd=5),
    "tncg": dict(l2_reg=1.0, niter=1, maxupd=100, reuse_prev=True),
}
# The methods also fitted with layout="coo" on the 2-rank mesh.
COO_FITS = ("pg", "cg")
SEED_A, SEED_B = 11, 12
EARLY_STOP_NITER = 30  # it stops after 22
# tncg without the cascade (compact_tail=False): one solver call a half,
# its early stop the share of unchanged rows over both ranks (it stops
# after 2 epochs)
FLAT_TNCG = dict(l2_reg=1e3, niter=EARLY_STOP_NITER, maxupd=100,
                 reuse_prev=True, compact_tail=False)


def triplets(seed: int = 1, density: float = 0.1):
    """(rows, cols, vals) of the test problem, from a seed."""
    rng = np.random.default_rng(seed)
    nnz = int(N_USERS * N_ITEMS * density)
    rows = rng.integers(0, N_USERS, size=nnz)
    cols = rng.integers(0, N_ITEMS, size=nnz)
    key = rows.astype(np.int64) * N_ITEMS + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    extra = np.repeat(np.arange(3), 40)
    rows = np.concatenate([rows, extra])
    cols = np.concatenate([cols, rng.integers(0, N_ITEMS, extra.shape[0])])
    vals = rng.poisson(3.0, size=rows.shape[0]) + 1.0
    keep = ~np.isin(rows, EMPTY_USERS) & (cols != EMPTY_ITEM)
    return (rows[keep].astype(np.int32), cols[keep].astype(np.int32),
            vals[keep])


def counts(sparse, dtype):
    """Both orientations, in ``sparse`` (either package's module)."""
    rows, cols, vals = triplets()
    return sparse.build_both_orientations(rows, cols, vals, N_USERS,
                                          N_ITEMS, dtype=dtype)


def initial(train, by_user, by_item, dtype):
    """The initial factors (the same NumPy draws in both packages)."""
    return (train.initialize_factors(N_USERS, by_user.n_rows_pad, K, SEED_A,
                                     dtype=dtype),
            train.initialize_factors(N_ITEMS, by_item.n_rows_pad, K, SEED_B,
                                     dtype=dtype))


def _layout(se, d, tag, out):
    """Every field of shard ``d`` of a ShardedEll, into ``out``."""
    for li, (c, v, s) in enumerate(zip(se.cols, se.vals, se.srcs)):
        out[f"{tag}/cols{li}"] = c[d]
        out[f"{tag}/vals{li}"] = v[d]
        if s is not None:
            out[f"{tag}/src{li}"] = s[d]
    for name in ("perm", "inv_perm", "row_nnz"):
        out[f"{tag}/{name}"] = getattr(se, name)[d]
    out[f"{tag}/meta"] = np.array(
        [se.n_slots, se.rps, se.n_shards, se.n_rows, se.n_cols]
        + list(se.Ps) + list(se.Rbs) + list(se.offsets))


def _fits(mesh, out, tag):
    """Each method's fit in float64 on ``mesh`` (or without one)."""
    from poismf_torch import sparse, train
    from poismf_torch.parallel import ell_mesh
    from poismf_torch.parallel.mesh import run_poismf_sharded

    by_user, by_item = counts(sparse, np.float64)
    for method, kw in FITS.items():
        A0, B0 = initial(train, by_user, by_item, np.float64)
        p = train.FitParams(k=K, method=method, **kw)
        if mesh is None:
            A, B, status = train.run_poismf(A0, B0, by_user, by_item, p)
        else:
            ell_mesh.CASCADE_TRACE = []
            try:
                A, B, status = run_poismf_sharded(A0, B0, by_user, by_item,
                                                  p, mesh)
            finally:
                trace, ell_mesh.CASCADE_TRACE = ell_mesh.CASCADE_TRACE, None
            out[f"{tag}/{method}/trace"] = np.array(
                [(r, s.startswith("compact/"), a, b)
                 for r, s, a, b, *_ in trace],
                dtype=np.int64).reshape(-1, 4)
        out[f"{tag}/{method}/A"] = A.numpy()
        out[f"{tag}/{method}/B"] = B.numpy()
        out[f"{tag}/{method}/status"] = np.array(status)


def _two_ranks(mesh, out):
    from poismf_torch import PoisMF, sparse, train
    from poismf_torch.parallel.ell_mesh import shard_ell
    from poismf_torch.parallel.mesh import run_poismf_sharded

    rank = dist.get_rank()
    for dtype in (np.float32, np.float64):
        by_user, by_item = counts(sparse, dtype)
        for side, X in (("user", by_user), ("item", by_item)):
            _layout(shard_ell(X, 2), rank, f"layout/{side}/{dtype.__name__}",
                    out)
    _fits(mesh, out, "mesh2")

    by_user, by_item = counts(sparse, np.float64)
    # layout="coo": the flat-COO row-sharded driver
    for method in COO_FITS:
        A0, B0 = initial(train, by_user, by_item, np.float64)
        A, B, status = run_poismf_sharded(
            A0, B0, by_user, by_item,
            train.FitParams(k=K, method=method, layout="coo",
                            **FITS[method]), mesh)
        out[f"coo/{method}/A"], out[f"coo/{method}/B"] = A.numpy(), B.numpy()
        out[f"coo/{method}/status"] = np.array(status)
    # the tncg early stop: both sides' rows converged long before niter
    epochs = []
    A0, B0 = initial(train, by_user, by_item, np.float64)
    kw = dict(FITS["tncg"], niter=EARLY_STOP_NITER)
    _, _, status = run_poismf_sharded(
        A0, B0, by_user, by_item, train.FitParams(k=K, method="tncg", **kw),
        mesh, callback=lambda epoch, A, B: epochs.append(epoch))
    out["early_stop"] = np.array([status, len(epochs)])
    epochs = []
    A0, B0 = initial(train, by_user, by_item, np.float64)
    A, B, status = run_poismf_sharded(
        A0, B0, by_user, by_item,
        train.FitParams(k=K, method="tncg", **FLAT_TNCG), mesh,
        callback=lambda epoch, A, B: epochs.append(epoch))
    out["flat/A"], out["flat/B"] = A.numpy(), B.numpy()
    out["flat/status"] = np.array([status, len(epochs)])

    # the model on every rank
    rows, cols, vals = triplets()
    X = (rows, cols, vals, (N_USERS, N_ITEMS))
    model = PoisMF(k=K, method="tncg", niter=2, random_state=3,
                   mesh=mesh).fit(X)
    out["model/device"] = np.array(str(model.device))
    out["model/A"], out["model/B"] = model.A, model.B
    out["model/status"] = np.array(model._fit_status)
    out["model/topN"] = np.stack([model.topN(u, n=5)
                                  for u in (0, 1, 150, 299)])
    out["model/llk"] = np.array(model.eval_llk())
    # a device that contradicts the mesh raises
    try:
        PoisMF(k=K, mesh=mesh, device="cuda")
    except ValueError as e:
        out["refused"] = np.array(str(e))


def run(rank: int, world_size: int, store: str, out_dir: str) -> None:
    """One rank of the 2-rank gloo mesh; rank 0 then fits on a 1-rank
    mesh (a new group, ``store`` + "-1") and without a mesh."""
    from poismf_torch.ops import ell as ell_ops
    from poismf_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    ell_ops.P_MAX = P_MAX
    out = {}
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    try:
        _two_ranks(make_mesh("cpu"), out)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        dist.init_process_group("gloo", init_method=f"file://{store}-1",
                                rank=0, world_size=1)
        try:
            _fits(make_mesh("cpu"), out, "mesh1")
        finally:
            dist.destroy_process_group()
        _fits(None, out, "single")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
