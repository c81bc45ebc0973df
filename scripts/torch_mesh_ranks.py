#!/usr/bin/env python3
"""The port's main paths fitted row-sharded over several ranks, one
process a GPU (NCCL), against the same fits on one GPU without a mesh.

    python3 scripts/torch_mesh_ranks.py [--ranks 4] [--fits tncg,cg,pg]
        [--scale 1.0] [--layout ell|coo] [--cpu]

Builds the kernels once (for the ELL), then spawns ``--ranks``
processes (a ``file://`` store under ``build/``).  Rank r fits
``chip_smoke.PATHS`` (tncg 1 epoch, cg 3 epochs, pg 10 epochs) on GPU r
through ``PoisMF(mesh=make_mesh("cuda"))``, on chip_smoke.py's synthetic
Last.FM-360K-shaped data (seed 0), with the kernel launch and collective
counts set to 0 just before each fit and read just after.  Then rank 0
fits each path again on its GPU without a mesh.  Prints per path and rank
the fit seconds (data ingest and layout build included), the train LL
over all pairs, the exact-zero shares, the peak device memory, the
launches and the collectives, and checks that every rank ends with the
same A and B bitwise (their SHA-256), that each rank's fit launched the
path's kernels, and that the mesh fit's train LL lies within 1e-2 and
its zero shares within 0.02 of the single-GPU fit (chip_smoke.py's mesh
band).  ``--layout coo`` fits every path on the flat COO, on the mesh
and on one GPU, and checks instead that no sweep kernel launched (tncg's
line search launches ls_round on every layout).
``--cpu`` runs gloo ranks on the CPU (plain versions, no launch check)
as a rehearsal at a small ``--scale``.  Exits nonzero when a check
fails.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

LL_RTOL, ZERO_TOL = 1e-2, 0.02


def _data(scale):
    from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,
                                         synth_lastfm_like)

    n_u, n_i = int(N_USERS * scale), int(N_ITEMS * scale)
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(0), n_u, n_i,
                                         int(NNZ_TARGET * scale))
    return rows, cols, vals, (n_u, n_i)


def _fit(torch, kw, dev, X, **where):
    """(model, fit seconds, peak GB, launches, collectives) of one fit of
    ``X``, with ``where`` (a mesh or a device) passed to the model."""
    import chip_smoke
    from poismf_torch import PoisMF, kernels
    from poismf_torch.parallel import collectives

    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    collectives.reset_counts()
    model = PoisMF(random_state=chip_smoke.SEED, **kw, **where)
    t0 = time.perf_counter()
    model.fit(X)
    if cuda:
        torch.cuda.synchronize()
    return (model, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
            {k: v for k, v in kernels.launch_counts.items() if v},
            dict(collectives.counts))


def _summary(model, secs, peak, launches, coll):
    A, B = model.A, model.B
    return dict(secs=secs, peak_gb=peak, launches=launches,
                collectives=coll, ll=model.eval_llk(include_missing=True),
                zeros_a=float((A == 0).mean()),
                zeros_b=float((B == 0).mean()),
                digest=hashlib.sha256(A.tobytes() + B.tobytes()).hexdigest())


def rank_main(rank, n_ranks, store, args, out_dir):
    import torch
    import torch.distributed as dist

    import chip_smoke
    from poismf_torch.parallel.mesh import make_mesh

    if args.cpu:
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=n_ranks)
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=n_ranks,
                                device_id=dev)
    X = _data(args.scale)
    out = {}

    def kw(path):
        return dict(chip_smoke.PATHS[path][0], layout=args.layout)

    try:
        mesh = make_mesh(dev.type)
        for path in args.fits.split(","):
            dist.barrier()
            out[f"mesh/{path}"] = _summary(*_fit(torch, kw(path), dev, X,
                                                 mesh=mesh))
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for path in args.fits.split(","):
            out[f"single/{path}"] = _summary(*_fit(torch, kw(path), dev, X,
                                                   device=dev))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--fits", default="tncg,cg,pg")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--layout", choices=("ell", "coo"), default="ell")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import torch
    import torch.multiprocessing as mp

    import chip_smoke

    if not args.cpu:
        if torch.cuda.device_count() < args.ranks:
            print(f"torch_mesh_ranks: {args.ranks} ranks need as many GPUs, "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        from poismf_torch.kernels import _lib

        if args.layout == "ell":
            _lib.library()  # built once, before the ranks load it
    out_dir = os.path.join(ROOT, "build", "mesh_ranks")
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, name))
    t0 = time.perf_counter()
    mp.spawn(rank_main, args=(args.ranks, os.path.join(out_dir, "store"),
                              args, out_dir), nprocs=args.ranks)
    print(f"# {args.ranks} ranks ({'gloo, CPU' if args.cpu else 'NCCL'}), "
          f"layout {args.layout}, scale {args.scale}: "
          f"{time.perf_counter() - t0:.1f} s in all", flush=True)
    res = []
    for r in range(args.ranks):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    ok = True
    for path in args.fits.split(","):
        one = res[0][f"single/{path}"]
        print(f"# {path} on one GPU, no mesh: fit {one['secs']:.2f} s, "
              f"train LL {one['ll']:.6e}, zeros A {one['zeros_a']:.4f} B "
              f"{one['zeros_b']:.4f}, peak {one['peak_gb']:.2f} GB, "
              f"launches {one['launches']}", flush=True)
        for r, rr in enumerate(res):
            m = rr[f"mesh/{path}"]
            rel = abs(m["ll"] - one["ll"]) / abs(one["ll"])
            print(f"# {path} mesh rank {r}: fit {m['secs']:.2f} s, train LL "
                  f"{m['ll']:.6e} (rel {rel:.3e} to one GPU), zeros A "
                  f"{m['zeros_a']:.4f} B {m['zeros_b']:.4f}, peak "
                  f"{m['peak_gb']:.2f} GB, launches {m['launches']}, "
                  f"collectives {m['collectives']}", flush=True)
            expected = (chip_smoke.PATHS[path][1] if args.layout == "ell"
                        else ())
            checks = {
                "factors equal on every rank":
                    m["digest"] == res[0][f"mesh/{path}"]["digest"],
                f"train LL within {LL_RTOL} of one GPU": rel <= LL_RTOL,
                f"zero shares within {ZERO_TOL}":
                    abs(m["zeros_a"] - one["zeros_a"]) <= ZERO_TOL
                    and abs(m["zeros_b"] - one["zeros_b"]) <= ZERO_TOL,
                "its kernels launched (COO: no sweep)": args.cpu or (
                    all(m["launches"].get(k, 0) > 0 for k in expected)
                    if expected
                    else not chip_smoke.sweeps_launched(m["launches"])),
            }
            for what, good in checks.items():
                if not good:
                    print(f"torch_mesh_ranks: FAILED: {path} rank {r}: "
                          f"{what}", file=sys.stderr)
                    ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
