"""End-to-end workflow of the PyTorch port on synthetic power-law data
shaped like Last.FM-360K: train/test split, fits with all three solvers
at their published settings, ranking evaluation, top-N, cold-start
factors and a checkpoint round trip.  The same steps as
``examples/lastfm_style_workflow.py`` does with the JAX package.

Run on the GPU (the hand-written kernels) or, when asked, on the CPU:

    python examples/lastfm_style_workflow_torch.py [--scale 0.02] [--k 50]
        [--device cuda|cpu]
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=0.02,
                    help="fraction of Last.FM-360K size to synthesize")
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    import scipy.sparse as sp

    from poismf_torch import PoisMF
    from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,
                                         synth_lastfm_like, train_test_split)
    from poismf_torch.utils.metrics import ranking_metrics

    n_users = int(N_USERS * args.scale)
    n_items = int(N_ITEMS * args.scale)
    rng = np.random.default_rng(1)
    rows, cols, vals = synth_lastfm_like(
        rng, n_users, n_items, int(NNZ_TARGET * args.scale)
    )

    # per-user holdout split (the reference notebook uses recometrics here)
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n_users, n_items))
    Xtr, Xte, test_users = train_test_split(
        X, test_fraction=0.2, users_test=10_000, seed=1
    )
    print(f"{n_users} users x {n_items} items, "
          f"train nnz {Xtr.nnz}, test nnz {Xte.nnz}, device {args.device}")

    print("note: the first fit on the GPU includes building the kernels "
          "(about a minute; cached under build/ afterwards)")
    configs = [
        ("pg",   dict(k=10, method="pg", l2_reg=1e9, niter=10, maxupd=1)),
        ("cg",   dict(k=args.k, method="cg", l2_reg=1e4, niter=30, maxupd=5)),
        ("tncg", dict(k=args.k, method="tncg", l2_reg=1e3, niter=10,
                      maxupd=750, reuse_prev=True)),
    ]
    model = None
    for name, cfg in configs:
        m = PoisMF(device=args.device, **cfg)
        t0 = time.time()
        m.fit(Xtr.tocoo())
        fit_s = time.time() - t0
        mets = ranking_metrics(m.A, m.B, Xtr, Xte, k=5, users=test_users)
        print(f"{name:5s} fit {fit_s:7.1f}s  "
              f"P@5 {mets['p_at_k']:.4f}  NDCG@5 {mets['ndcg_at_k']:.4f}  "
              f"AUC {mets['roc_auc']:.4f}  "
              f"A zeros {float((m.A == 0).mean()):.2%}")
        model = m

    # serving surface
    user = 0
    print("topN(user 0):", model.topN(user, n=5).tolist())
    seen = Xtr.indices[Xtr.indptr[user]:Xtr.indptr[user + 1]]
    print("topN excluding seen:",
          model.topN(user, n=5, exclude=seen).tolist())

    # cold start: a brand-new user who consumed a few items
    new_items = np.asarray(model.topN(user, n=8))
    new_counts = np.full(new_items.shape[0], 3.0)
    factors = model.predict_factors((new_items, new_counts))
    print("cold-start factors norm:", float(np.linalg.norm(factors)))
    print("topN_new:",
          model.topN_new((new_items, new_counts), n=5).tolist())

    # persistence round trip
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poismf_model.npz")
        model.save(path)
        restored = PoisMF.load(path, device=args.device)
    assert np.allclose(restored.predict(0, 0), model.predict(0, 0),
                       equal_nan=True)
    print("checkpoint round-trip OK")
    return model


if __name__ == "__main__":
    main()
