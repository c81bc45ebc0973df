#!/usr/bin/env python3
"""The port's main paths fitted with and without a one-rank NCCL mesh, in
turns, on one NVIDIA GPU.

    python3 scripts/torch_mesh_fit_probe.py [--fits tncg,cg,pg] [--reps 2]
        [--scale 1.0] [--cpu]

Fits ``chip_smoke.PATHS`` (tncg 1 epoch, cg 3 epochs, pg 10 epochs, k=50 /
k=10, bf16 planes) on chip_smoke.py's synthetic Last.FM-360K-shaped data
(seed 0) through ``PoisMF(device="cuda")`` and through
``PoisMF(mesh=init_device_mesh("cuda", (1,)))``, single and mesh in turns
(single, mesh, mesh, single, ... ``--reps`` of each).  Prints per fit the
wall seconds (ingest and layout build included), the train LL over all
pairs, the exact-zero shares of A and B, the kernel launches, the
collectives (mesh) and, for tncg, each half-update's cascade rounds
(round, structure, active rows in, active rows out): what the two paths
share and where their schedules part.  ``--cpu`` runs the same on the
CPU (plain versions, a one-rank gloo mesh) as a rehearsal at a small
``--scale``.  Runs from the root of the tree it measures.
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fits", default="tncg,cg,pg")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import chip_smoke
    from poismf_torch import PoisMF, kernels, train
    from poismf_torch.parallel import collectives, ell_mesh
    from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,
                                         synth_lastfm_like)

    if not args.cpu:
        if not torch.cuda.is_available():
            print("torch_mesh_fit_probe: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    n_u, n_i = int(N_USERS * args.scale), int(N_ITEMS * args.scale)
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(0), n_u, n_i,
                                         int(NNZ_TARGET * args.scale))
    X = (rows, cols, vals, (n_u, n_i))

    # the single-device cascade's rounds, through the same hook
    traces = []
    cascade = train._tncg_cascade

    def traced(*a, trace=None, **kw):
        trace = [] if trace is None else trace
        traces.append(trace)
        return cascade(*a, trace=trace, **kw)

    train._tncg_cascade = traced
    store = os.path.join(ROOT, "build", "mesh_fit_probe_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    if args.cpu:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=0, world_size=1)
    else:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=0, world_size=1,
                                device_id=torch.device("cuda", 0))
    sync = torch.cuda.synchronize if not args.cpu else (lambda: None)
    try:
        mesh = init_device_mesh(dev, (1,))
        for path in args.fits.split(","):
            kw = chip_smoke.PATHS[path][0]
            order = ["single", "mesh", "mesh", "single"] * args.reps
            for how in order[:2 * args.reps]:
                model = PoisMF(random_state=chip_smoke.SEED, **kw,
                               **({"mesh": mesh} if how == "mesh"
                                  else {"device": dev}))
                traces.clear()
                ell_mesh.CASCADE_TRACE = None
                kernels.reset_launch_counts()
                collectives.reset_counts()
                sync()
                t0 = time.perf_counter()
                model.fit(X)
                sync()
                secs = time.perf_counter() - t0
                A, B = model.A, model.B
                launches = {k: v for k, v in kernels.launch_counts.items()
                            if v}
                print(f"# {path} {how}: fit {secs:.2f} s, train LL (all "
                      f"pairs) {model.eval_llk(include_missing=True):.6e}, "
                      f"zeros A {(A == 0).mean():.4f} B {(B == 0).mean():.4f}"
                      f", launches {launches}, collectives "
                      f"{dict(collectives.counts)}", flush=True)
                for h, trace in enumerate(traces):
                    print(f"#   half {h}: "
                          + " ".join(f"{r}:{s}:{a}->{b}"
                                     for r, s, a, b, *_ in trace), flush=True)
                del model, A, B
    finally:
        dist.destroy_process_group()
        os.remove(store)
    return 0


if __name__ == "__main__":
    sys.exit(main())
