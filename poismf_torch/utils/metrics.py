"""Batched ranking metrics for implicit-feedback evaluation (PyTorch).

Counterpart of ``poismf_tpu/utils/metrics.py``: P@K, Recall@K, NDCG@K
(graded by the held-out counts) and ROC-AUC over each test user's
held-out items, the user's training items left out of the candidates.
Per chunk of users: one ``[U, n_items]`` score matmul, the training items
set to -inf, ``torch.topk`` for the @K metrics and a full sort for the
AUC ranks, all on the factors' device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..serve import exclude_items_


def _csr_rows(indptr, indices, data, row):
    lo, hi = indptr[row], indptr[row + 1]
    return indices[lo:hi], data[lo:hi]


def _pad_lists(indptr, indices, data, rows, width):
    """[len(rows), width] padded item-id / value arrays (pad id = -1)."""
    ids = np.full((len(rows), width), -1, dtype=np.int64)
    vals = np.zeros((len(rows), width), dtype=np.float64)
    for i, r in enumerate(rows):
        ix, v = _csr_rows(indptr, indices, data, r)
        m = min(len(ix), width)
        ids[i, :m] = ix[:m]
        vals[i, :m] = v[:m]
    return ids, vals


def _eval_chunk(A_u, B, train_ids, test_ids, test_vals, k: int):
    """Per-user (P@K, Recall@K, NDCG@K, AUC) of one chunk of users."""
    scores = A_u @ B.t()  # [U, n_items]
    n_items = B.shape[0]
    # training items out of the candidate set
    tr_valid = train_ids >= 0
    cand = exclude_items_(scores.clone(), train_ids, tr_valid)

    te_valid = test_ids >= 0
    safe_te = torch.where(te_valid, test_ids, 0)
    n_test = te_valid.sum(1)

    # @K metrics off one topk
    _, topk = torch.topk(cand, k, dim=1)
    hit = (topk[:, :, None] == safe_te[:, None, :]) & te_valid[:, None, :]
    hit_any = hit.any(2)  # [U, k]
    p_at_k = hit_any.sum(1) / k
    recall = hit_any.sum(1) / torch.clamp_min(n_test, 1)

    # graded NDCG@K: a ranked item's gain is its held-out count
    gains = torch.where(te_valid, test_vals, 0.0)
    topk_gain = torch.einsum("ukt,ut->uk", hit.to(gains.dtype), gains)
    disc = 1.0 / torch.log2(torch.arange(k, dtype=gains.dtype,
                                         device=gains.device) + 2.0)
    dcg = topk_gain @ disc
    idcg = torch.topk(gains, k, dim=1)[0] @ disc  # the k largest gains
    ndcg = torch.where(idcg > 0, dcg / torch.clamp_min(idcg, 1e-30), 0.0)

    # ROC-AUC from each positive's rank among the candidates; the -inf
    # training items sort below everything and are taken off the rank
    s_sorted = torch.sort(cand, dim=1)[0]
    pos_scores = torch.gather(scores, 1, safe_te)
    n_tr = tr_valid.sum(1)
    ranks = torch.searchsorted(s_sorted, pos_scores)
    ranks = torch.where(te_valid, ranks - n_tr[:, None], 0).to(
        scores.dtype)
    n_pos = n_test
    n_neg = torch.clamp_min(n_items - n_tr - n_pos, 1)
    sum_ranks = (ranks * te_valid).sum(1)
    auc = (sum_ranks - (n_pos * (n_pos - 1)) / 2.0) / (
        torch.clamp_min(n_pos, 1) * n_neg)
    return p_at_k, recall, ndcg, torch.clamp(auc, 0.0, 1.0)


def ranking_metrics(
    A,
    B,
    X_train,
    X_test,
    k: int = 5,
    users: Optional[np.ndarray] = None,
    chunk: int = 256,
) -> Dict[str, float]:
    """Mean P@K, Recall@K, NDCG@K and ROC-AUC over test users.

    ``A``: [n_users, f] user factors; ``B``: [n_items, f] item factors,
    NumPy arrays or tensors (the metrics run on ``B``'s device, the CPU
    for NumPy arrays); ``X_train`` / ``X_test``: SciPy CSR
    (or convertible) of training / held-out counts, same shape.  ``users``
    restricts the evaluation to a subset (default: users with at least
    one held-out item).  Training items are left out of the candidates;
    AUC ranks against the whole remaining catalog."""
    Xtr = X_train.tocsr()
    Xte = X_test.tocsr()
    device = B.device if isinstance(B, torch.Tensor) else "cpu"
    B_d = torch.as_tensor(B, device=device)
    A_d = torch.as_tensor(A, device=device)

    if users is None:
        users = np.flatnonzero(np.diff(Xte.indptr) > 0)
    users = np.asarray(users)
    if users.size == 0:
        raise ValueError("no test users with held-out items")

    test_w = max(int(np.diff(Xte.indptr)[users].max()), 1)
    train_w = max(int(np.diff(Xtr.indptr)[users].max()) if Xtr.nnz else 1,
                  1)

    acc = {m: [] for m in ("p_at_k", "recall_at_k", "ndcg_at_k", "roc_auc")}
    for lo in range(0, users.size, chunk):
        u = users[lo:lo + chunk]
        tr_ids, _ = _pad_lists(Xtr.indptr, Xtr.indices, Xtr.data, u, train_w)
        te_ids, te_vals = _pad_lists(Xte.indptr, Xte.indices, Xte.data, u,
                                     test_w)
        out = _eval_chunk(
            A_d[torch.as_tensor(u, device=device)], B_d,
            torch.as_tensor(tr_ids, device=device),
            torch.as_tensor(te_ids, device=device),
            torch.as_tensor(te_vals, dtype=A_d.dtype, device=device), k)
        for name, arr in zip(acc, out):
            acc[name].append(arr.double().cpu().numpy())
    return {name: float(np.concatenate(v).mean()) for name, v in acc.items()}
