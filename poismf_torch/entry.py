"""Entry points of the port, the twins of the JAX package's in
``__graft_entry__.py``:

``entry(device="cuda")``  -> (fn, args): one batched truncated-Newton
                             (TNCG) half-update of the user factors A
                             against fixed item factors B on a tiny
                             problem, the hot compute of the whole
                             framework.
``dryrun_multichip(n_devices, device="cuda")``: ``n_devices`` ranks, one
                             process each, fit the tiny problem
                             row-sharded (as ``PoisMF(mesh=...)`` fits)
                             by every method, and each fit is held to a
                             single-process fit of the same problem.

The device is the caller's: "cuda" runs the hand-written kernels (NCCL
ranks, one GPU each) and raises without enough cards; "cpu" runs the
plain versions (gloo ranks) and is never chosen silently.

    python -m poismf_torch.entry [--entry-only | --dryrun-only]
        [--ranks N] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

K = 8
# The sharded fits of every method, their parameters and the relative
# band of their train LL against the single-process fit.  The sharded
# solve is the same math modulo summation order (Bsum, the layout), to
# which the cg / tncg line searches are sensitive: pg and tncg keep the
# JAX package's bands (1e-5, 5e-2); cg's is wider than its 3e-2, as a
# float32 cg fit of this problem moves its LL over 4.7% under one-ulp
# changes of one initial factor (tests/test_torch_entry.py).
CASES = (
    ("pg", dict(niter=3, maxupd=5, initial_step=1e-3), 1e-5),
    ("cg", dict(niter=3, maxupd=5), 1e-1),
    ("tncg", dict(niter=2, maxupd=60, reuse_prev=True), 5e-2),
)
# where the ranks meet (a file:// store) and leave their results
BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "build")


def _tiny_problem(n_users=64, n_items=48, density=0.15, seed=1):
    """(rows, cols, vals, n_users, n_items) of a small random counts
    matrix, each pair at most once."""
    rng = np.random.default_rng(seed)
    nnz = int(n_users * n_items * density)
    rows = rng.integers(0, n_users, size=nnz)
    cols = rng.integers(0, n_items, size=nnz)
    key = rows.astype(np.int64) * n_items + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = (rng.poisson(3.0, size=rows.shape[0]) + 1.0).astype(np.float32)
    return rows.astype(np.int32), cols.astype(np.int32), vals, n_users, n_items


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _pad8(n):
    return ((n + 7) // 8) * 8


def _inputs(device):
    """Both orientations of the tiny problem and its initial A and B on
    ``device`` (the same NumPy draws as the JAX package's)."""
    from .sparse import build_both_orientations
    from .train import initialize_factors

    rows, cols, vals, n_users, n_items = _tiny_problem()
    by_user, by_item = build_both_orientations(
        rows, cols, vals, n_users, n_items, dtype=np.float32)
    rng = np.random.default_rng(1)
    A = initialize_factors(n_users, by_user.n_rows_pad, K, rng, np.float32,
                           device)
    B = initialize_factors(n_items, _pad8(n_items), K, rng, np.float32,
                           device)
    return by_user, by_item, A, B


def entry(device="cuda"):
    """(fn, args): ``fn(*args)`` is one TNCG half-update of the user
    factors (k=8, l2=1e3, maxupd=30, reuse_prev) against the fixed item
    factors on the planar ELL of the tiny problem, returning A
    [n_rows_pad, k] in its original row order."""
    from .models.poismf import resolve_device
    from .ops import ell as ell_ops
    from .ops import objective as obj
    from .solvers.tncg import tncg_update_ell

    dev = resolve_device(device)
    by_user, _, A, B = _inputs(dev)
    Bsum = obj.make_bsum(B, by_user.n_cols, 0.0)
    ell = ell_ops.ell_from_counts(by_user, device=dev)

    def step(A, B, ell, Bsum):
        planes = ell_ops.gather_planes(B, ell)
        out, _ = tncg_update_ell(ell_ops.permute_rows(A, ell.perm),
                                 planes, ell, Bsum, l2_reg=1e3, maxupd=30,
                                 reuse_prev=True)
        return ell_ops.permute_rows(out, ell.inv_perm)

    return step, (A, B, ell, Bsum)


def _train_ll(A, B, by_user):
    from .ops import objective as obj

    return float(obj.eval_llk(A[: by_user.n_rows], B[: by_user.n_cols],
                              by_user))


def _rank(rank, n_ranks, store, out_dir, device_type):
    """One rank: the sharded fit of every case; rank 0 then fits each
    case again in this process without a mesh."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh, run_poismf_sharded
    from .train import FitParams, run_poismf

    if device_type == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n_ranks)
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=n_ranks, device_id=dev)
    by_user, by_item, A0, B0 = _inputs(dev)
    out = {}
    try:
        mesh = make_mesh(device_type)
        for method, kw, _ in CASES:
            p = FitParams(k=K, method=method, l2_reg=1.0, early_stop=False,
                          **kw)
            A, B, status = run_poismf_sharded(A0, B0, by_user, by_item, p,
                                              mesh)
            out[f"{method}/A"], out[f"{method}/B"] = A.cpu().numpy(), \
                B.cpu().numpy()
            out[f"{method}/status"] = np.array(status)
            out[f"{method}/ll"] = np.array(_train_ll(A, B, by_user))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for method, kw, _ in CASES:
            p = FitParams(k=K, method=method, l2_reg=1.0, early_stop=False,
                          **kw)
            A, B, _ = run_poismf(A0, B0, by_user, by_item, p)
            out[f"{method}/single_ll"] = np.array(_train_ll(A, B, by_user))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Fit the tiny problem row-sharded over ``n_devices`` ranks (one
    process each: NCCL, one GPU a rank, on "cuda"; gloo on "cpu") by
    every method in ``CASES`` (l2=1, no early stop), and assert: status
    0, finite factors, the train LL within the case's band of a
    single-process fit of the same problem on the same kind of device,
    and the same factors bit for bit on every rank.  Raises on "cuda"
    when the host has fewer than ``n_devices`` cards.  Returns
    ``{method: (sharded LL, single LL)}``."""
    import torch.multiprocessing as mp

    device_type = torch.device(device).type
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device={device!r}: 'cuda' or 'cpu'")
    if n_devices < 1:
        raise ValueError(f"n_devices={n_devices}: at least 1")
    if device_type == "cuda":
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < n_devices:
            raise RuntimeError(
                f"dryrun_multichip: {n_devices} NCCL ranks need as many "
                f"GPUs, found {found}; pass device='cpu' for gloo ranks "
                "on the CPU")
        from .kernels import _lib

        _lib.library()  # built once, before the ranks load it
    os.makedirs(BUILD, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="dryrun_multichip_", dir=BUILD)
    try:
        mp.spawn(_rank, args=(n_devices, os.path.join(out_dir, "store"),
                              out_dir, device_type), nprocs=n_devices)
        ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
                 for r in range(n_devices)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    lls = {}
    for method, _, tol in CASES:
        r0 = ranks[0]
        for r, res in enumerate(ranks):
            _check(int(res[f"{method}/status"]) == 0,
                   f"{method}: rank {r} ended with status "
                   f"{int(res[f'{method}/status'])}")
            for side in ("A", "B"):
                M = res[f"{method}/{side}"]
                _check(np.isfinite(M).all(),
                       f"{method}: rank {r}'s {side} is not finite")
                _check(np.array_equal(M.view(np.uint32),
                                      r0[f"{method}/{side}"].view(np.uint32)),
                       f"{method}: rank {r}'s {side} differs from rank 0's")
        ll, ll1 = float(r0[f"{method}/ll"]), float(r0[f"{method}/single_ll"])
        _check(abs(ll1 - ll) / abs(ll1) < tol,
               f"{method}: train LL {ll:.9e} on {n_devices} ranks, "
               f"{ll1:.9e} in one process (band {tol})")
        lls[method] = (ll, ll1)
    return lls


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="The port's entry point and multi-rank dry run.")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--entry-only", action="store_true")
    mode.add_argument("--dryrun-only", action="store_true")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: every GPU; 8 with "
                         "--cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (plain versions, gloo ranks)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if not args.dryrun_only:
        fn, fargs = entry(device)
        out = fn(*fargs)
        if out.is_cuda:
            torch.cuda.synchronize()
        _check(bool(torch.isfinite(out).all()), "entry: non-finite factors")
        print("entry OK:", tuple(out.shape), flush=True)
    if not args.entry_only:
        n = args.ranks
        if n is None:
            n = 8 if args.cpu else torch.cuda.device_count()
        for method, (ll, ll1) in dryrun_multichip(n, device).items():
            print(f"# {method}: {n}-rank train LL {ll:.9e}, single process "
                  f"{ll1:.9e}", flush=True)
        print("dryrun_multichip OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
