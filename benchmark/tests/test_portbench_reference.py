"""The plain references against the port's own solvers at a small size
on the CPU: the published truncated Newton of ``reference/rows.py``
(``tnc_iterate``) follows the port's sequential-search TNCG on the flat
COO from the same start, and ends where the objective is no higher than
its start on every row."""

import pytest
import torch

from benchmark import data
from benchmark.reference import rows as ref

N_USERS, N_ITEMS, NNZ, K = 300, 140, 6000, 12
LAWS = {"activity_sigma": 1.2, "popularity_zipf": 0.9, "oversample": 1.25,
        "count_mean": 8.0}


@pytest.fixture(scope="module")
def problem():
    rows, cols, vals = data.synth_counts(3, N_USERS, N_ITEMS, NNZ, LAWS,
                                         "cpu")
    gen = torch.Generator().manual_seed(5)
    A = 0.05 + 0.3 * torch.rand((N_USERS, K), generator=gen)
    B = 0.05 + 0.3 * torch.rand((N_ITEMS, K), generator=gen)
    return rows, cols, vals, A, B


@pytest.mark.parametrize("l2", [1.0, 30.0])
def test_tnc_follows_the_ports_sequential_search(problem, l2):
    from poismf_torch import sparse, train
    from poismf_torch.solvers.tncg import tncg_update

    rows, cols, vals, A, B = problem
    ing = sparse.ingest((rows.int().numpy(), cols.int().numpy(),
                         vals.numpy(), (N_USERS, N_ITEMS)), reindex=False)
    X_user, _ = train.coo_pair_cached(ing.by_user, ing.by_item, "cpu")
    A_pad = torch.zeros((ing.by_user.n_rows_pad, K))
    B_pad = torch.zeros((ing.by_item.n_rows_pad, K))
    A_pad[:N_USERS], B_pad[:N_ITEMS] = A, B
    Bsum = B.sum(0)
    port = tncg_update(A_pad, B_pad, X_user, Bsum, l2_reg=l2, maxupd=15 * K,
                       reuse_prev=True, ls_cand=1)[0]
    ptr, c, v = data.csr(rows, cols, vals, N_USERS)
    has = torch.nonzero(ptr[1:] > ptr[:-1]).squeeze(1)
    groups = ref.make_groups(has, ptr, c, v, B.double())
    s = Bsum.double()
    f0 = fp = fr = 0.0
    for g in groups:
        x0 = A[g.rows].double()
        mine = ref.tnc_iterate(g, x0, s, l2, 15 * K)
        f_start = ref.objective(g, x0, s, l2)
        f_ref = ref.objective(g, mine, s, l2)
        assert bool((ref.merit(g, mine, s) <= ref.merit(g, x0, s)).all())
        f0 += float(f_start.sum())
        fr += float(f_ref.sum())
        fp += float(ref.objective(g, port[g.rows], s, l2).sum())
    assert abs(fp - fr) <= 1e-3 * (f0 - fr)
