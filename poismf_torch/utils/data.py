"""Dataset helpers: synthetic counts data at Last.FM-360K scale (no
download) and a per-user train / test split for ranking metrics.

``synth_lastfm_like`` is a copy of the one in the repository's
``bench.py``, which imports the JAX stack; the same seed gives the same
data.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

N_USERS = 358_858
N_ITEMS = 160_112
NNZ_TARGET = 17_164_027


def synth_lastfm_like(rng, n_users=N_USERS, n_items=N_ITEMS,
                      nnz=NNZ_TARGET):
    """Power-law synthetic counts with Last.FM-like marginals: item
    popularity ~ Zipf, user activity ~ lognormal, counts ~ 1 + Poisson."""
    # draw with replacement then dedupe; oversample to land near nnz target
    over = int(nnz * 1.25)
    item_p = 1.0 / np.arange(1, n_items + 1) ** 0.9
    item_p /= item_p.sum()
    user_w = rng.lognormal(0.0, 1.2, size=n_users)
    user_p = user_w / user_w.sum()
    rows = rng.choice(n_users, size=over, p=user_p).astype(np.int64)
    cols = rng.choice(n_items, size=over, p=item_p).astype(np.int64)
    key = rows * n_items + cols
    _, idx = np.unique(key, return_index=True)
    idx = idx[:nnz]
    rows, cols = rows[idx].astype(np.int32), cols[idx].astype(np.int32)
    vals = (1.0 + rng.poisson(8.0, size=rows.shape[0])).astype(np.float32)
    return rows, cols, vals


def train_test_split(
    X,
    test_fraction: float = 0.2,
    users_test: Optional[int] = None,
    min_items_pool: int = 2,
    min_pos_test: int = 1,
    seed: int = 1,
):
    """Per-user holdout split of a sparse counts matrix (a copy of
    ``poismf_tpu.utils.data.train_test_split``; the same seed gives the
    same split).

    For up to ``users_test`` eligible users (enough interactions to leave
    at least ``min_pos_test`` held out and one training item), moves
    ``test_fraction`` of their observed items into the test matrix; all
    other users keep their full history in train.  Returns ``(X_train,
    X_test, test_users)``: two CSR matrices and the ids of the users with
    held-out items."""
    import scipy.sparse as sp

    Xcsr = X.tocsr()
    n_users, n_items = Xcsr.shape
    rng = np.random.default_rng(seed)
    nnz_per_user = np.diff(Xcsr.indptr)
    eligible = np.flatnonzero(nnz_per_user >= max(min_items_pool, 2))
    if users_test is not None and eligible.size > users_test:
        eligible = rng.choice(eligible, size=users_test, replace=False)
        eligible.sort()
    eligible_set = set(eligible.tolist())

    tr_r, tr_c, tr_v = [], [], []
    te_r, te_c, te_v = [], [], []
    test_users = []
    for u in range(n_users):
        lo, hi = Xcsr.indptr[u], Xcsr.indptr[u + 1]
        cols = Xcsr.indices[lo:hi]
        vals = Xcsr.data[lo:hi]
        if u in eligible_set:
            n_test = max(min_pos_test, int(round(test_fraction * cols.size)))
            n_test = min(n_test, cols.size - 1)  # keep >= 1 train item
            pick = rng.choice(cols.size, size=n_test, replace=False)
            mask = np.zeros(cols.size, dtype=bool)
            mask[pick] = True
            te_r.append(np.full(n_test, u))
            te_c.append(cols[mask])
            te_v.append(vals[mask])
            tr_r.append(np.full(cols.size - n_test, u))
            tr_c.append(cols[~mask])
            tr_v.append(vals[~mask])
            test_users.append(u)
        else:
            tr_r.append(np.full(cols.size, u))
            tr_c.append(cols)
            tr_v.append(vals)

    def build(r, c, v):
        if not r:
            return sp.csr_matrix((n_users, n_items))
        return sp.csr_matrix(
            (np.concatenate(v), (np.concatenate(r), np.concatenate(c))),
            shape=(n_users, n_items),
        )

    return (build(tr_r, tr_c, tr_v), build(te_r, te_c, te_v),
            np.asarray(test_users))
