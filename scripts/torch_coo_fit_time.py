#!/usr/bin/env python3
"""The two layouts on the same data in one process: wall seconds, peak
device memory, train LL and exact-zero shares of each main path fitted
on the planar ELL (``layout="ell"``) and on the flat COO
(``layout="coo"``).  One GPU, or the CPU with ``--cpu``.

    python3 scripts/torch_coo_fit_time.py [--fits tncg,cg,pg]
        [--layouts ell,coo] [--scale 1.0] [--nnz-chunk N] [--niter N]
        [--profile] [--cpu]

Fits each of ``chip_smoke.PATHS`` (tncg 1 epoch, cg 3 epochs, pg 10
epochs, their published configurations; chip_smoke.py's synthetic
Last.FM-360K-shaped data, seed 0) once per layout, in the order given,
with the kernel launch counts set to 0 just before each fit and read
just after, and neither layout cached from an earlier fit (each fit's
wall includes its layout's build); ``--nnz-chunk`` adds a COO fit with
that chunk (0: the largest divisor of the padded nnz that makes at
least 16 chunks).
``--niter`` overrides the epochs of every path.  ``--profile`` runs
each COO fit once more under ``torch.profiler`` and prints its ten CUDA
kernels of most device time and the device-busy share of the fit.  The
script puts its own tree first on ``sys.path``: run the copy inside the
tree you measure.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def profile_fit(torch, fit):
    """Run ``fit()`` under torch.profiler; print the ten CUDA kernels of
    most device time and the device-busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fit()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    total_us = sum(e.self_device_time_total for e in events)
    print(f"#   profiled: {wall:.2f} s wall, {total_us / 1e6:.2f} s of CUDA "
          f"kernels (device busy {total_us / 1e6 / wall:.1%})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"#     {e.self_device_time_total / 1e3:10.1f} ms "
              f"{e.count:8d} calls  {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fits", default="tncg,cg,pg")
    ap.add_argument("--layouts", default="ell,coo")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--nnz-chunk", type=int, default=None)
    ap.add_argument("--niter", type=int, default=None)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import torch

    import chip_smoke
    from poismf_torch import PoisMF, kernels, train
    from poismf_torch.sparse import ingest
    from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,
                                         synth_lastfm_like)

    dev = "cpu" if args.cpu else "cuda"
    if dev == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"# torch {torch.__version__}, device {dev}")
    n_users, n_items = int(N_USERS * args.scale), int(N_ITEMS * args.scale)
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(0), n_users,
                                         n_items,
                                         int(NNZ_TARGET * args.scale))
    X = (rows, cols, vals, (n_users, n_items))
    nnz_pad = ingest(X).by_user.nnz_pad
    print(f"# data: {n_users} x {n_items}, {rows.shape[0]} nonzeros "
          f"(padded {nnz_pad}; scale {args.scale})")
    runs = [(lay, None) for lay in args.layouts.split(",")]
    if args.nnz_chunk is not None:
        runs.append(("coo", args.nnz_chunk or chip_smoke.chunk_divisor(
            nnz_pad, chip_smoke.COO_MIN_CHUNKS)))

    for path in args.fits.split(","):
        kw = dict(chip_smoke.PATHS[path][0])
        if args.niter is not None:
            kw["niter"] = args.niter
        walls = {}
        for layout, chunk in runs:
            def fit():
                return PoisMF(random_state=chip_smoke.SEED, device=dev,
                              layout=layout, nnz_chunk=chunk, **kw).fit(X)

            # each fit builds its own layout, and holds no other
            train._ELL_CACHE.clear()
            train._COO_CACHE.clear()
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            model = fit()
            if dev == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            peak = (torch.cuda.max_memory_allocated() / 1e9 if dev == "cuda"
                    else float("nan"))
            launches = {n: c for n, c in kernels.launch_counts.items() if c}
            ll = model.eval_llk(include_missing=True)
            tag = layout + ("" if chunk is None else f" nnz_chunk={chunk}")
            walls[tag] = secs
            z_a, z_b = (model.A == 0).mean(), (model.B == 0).mean()
            print(f"# {path} {tag}: fit {secs:.2f} s (ingest and layout "
                  f"build included), peak device memory {peak:.2f} GB; "
                  f"train LL (all pairs) {ll:.6e}; exact zeros A {z_a:.4f} "
                  f"B {z_b:.4f}; kernel launches {launches}", flush=True)
            del model
            if args.profile and layout == "coo" and dev == "cuda":
                profile_fit(torch, fit)
        print(f"# {path} walls: " + ", ".join(f"{t} {s:.2f} s"
                                             for t, s in walls.items()))


if __name__ == "__main__":
    main()
