"""Synthetic counts data at Last.FM-360K scale (no download).

A copy of ``synth_lastfm_like`` from the repository's ``bench.py``, which
imports the JAX stack; the same seed gives the same data.
"""

from __future__ import annotations

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
