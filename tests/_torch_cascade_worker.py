"""Rank worker of ``tests/test_torch_cascade.py``: the row-sharded
cascade's rejected-tail profiles on a gloo mesh of CPU processes.

Spawned ranks import this module alone (numpy, torch and poismf_torch:
no JAX, no ``tests/conftest.py``).  :func:`run` is one rank of a 2-rank
mesh: it records :func:`masks`' tails into its side's cascade state and
writes the profiles after each, and the plans built from them, to
``<out>/rank<r>.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

N_USERS, N_ITEMS = 1200, 90
N_SHARDS = 2


def counts(sparse, dtype=np.float64):
    """The by-user orientation of the test problem, in ``sparse`` (either
    package's module): more rows on rank 0 than on rank 1."""
    rng = np.random.default_rng(5)
    nnz = 24_000
    rows = np.minimum(rng.exponential(400.0, nnz).astype(np.int64),
                      N_USERS - 1)
    cols = rng.integers(0, N_ITEMS, nnz)
    key = np.unique(rows * N_ITEMS + cols)
    rows, cols = key // N_ITEMS, key % N_ITEMS
    vals = rng.poisson(3.0, rows.shape[0]) + 1.0
    return sparse.build_both_orientations(
        rows.astype(np.int32), cols.astype(np.int32), vals, N_USERS, N_ITEMS,
        dtype=dtype)[0]


def masks(n_slots: int):
    """[D, n_slots] active masks, from a seed: tails that both packages'
    rules record alike (at most 1/6 of one shard's slots over all
    shards), then one of 3/4 of one shard's slots over all shards (half
    a shard's slots or more: the JAX package records none of it)."""
    rng = np.random.default_rng(7)
    out = []
    for share in (0.02, 0.05, 0.1, 0.03, 0.15):
        n = int(share * n_slots)
        m = np.zeros(N_SHARDS * n_slots, dtype=bool)
        m[rng.choice(N_SHARDS * n_slots, n, replace=False)] = True
        out.append(m.reshape(N_SHARDS, n_slots))
    m = np.zeros(N_SHARDS * n_slots, dtype=bool)
    m[rng.choice(N_SHARDS * n_slots, 3 * n_slots // 4, replace=False)] = True
    out.append(m.reshape(N_SHARDS, n_slots))
    return out


def run(rank: int, world_size: int, store: str, out_dir: str) -> None:
    from poismf_torch import sparse, train
    from poismf_torch.parallel import collectives
    from poismf_torch.parallel.ell_mesh import shard_ell

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world_size)
    out = {}
    try:
        group = dist.group.WORLD
        se = shard_ell(counts(sparse), world_size)
        ell = se.local_ell(rank)
        aux = train.cascade_aux(ell)
        collectives.reset_counts()
        for i, m in enumerate(masks(se.n_slots)):
            train._update_profile(ell, aux, m[rank], int(m.sum()), group)
            for cls, prof in aux["profiles"].items():
                out[f"profile{i}/{cls}"] = prof
            if i == len(masks(se.n_slots)) - 2:
                train._maybe_build_adaptive_plan(ell, aux)
                out["plans"] = np.array([(pl.denom,) + pl.caps
                                         for pl in aux["plans"]])
        out["all_reduce"] = np.array(collectives.counts["all_reduce"])
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
