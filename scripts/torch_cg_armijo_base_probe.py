#!/usr/bin/env python3
"""Where cg's Armijo test takes its base f from, on one GPU.

    python3 scripts/torch_cg_armijo_base_probe.py

The ray line search of ``poismf_torch/solvers/cg.py`` tests each trial
``f(x + a*d) <= f(x) - 0.01 a |d|^2``.  It takes ``f(x)`` from the ray
kernel at ``a = 0``, one sum in the trials' own order.  This script
compares that solver ("ray") with a copy that takes ``f(x)`` from the
full evaluation (fg) instead ("fg"), in the order fg, ray, fg, ray:

- the ``chip_smoke.py`` cg main path (3 epochs at Last.FM-360K scale):
  fit seconds, train LL, fg and rayf launches;
- a serving solve of 512 of ``chip_smoke.py``'s new users from that fit,
  on bf16 planes, at 15 and 150 cg iterations: the card's summed serving
  objective against the same solve on the CPU (plain versions), and the
  worst row;
- once, on the CPU: the same solves in float32 and in float64 (f32 /
  f64 planes), the precision the solve's result follows.

On the CPU both solvers give equal results (the plain versions sum f the
same way): the script checks that too.  Prints the card's name and power
limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import inspect
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def fg_base_solver():
    """A copy of ``cg_update_ell`` whose Armijo base is fg's f."""
    from poismf_torch.solvers import cg as cg_mod

    src = inspect.getsource(cg_mod)
    old = "& (f_c <= f_base[None] - CG_LNSRCH_C"
    assert src.count(old) == 1, "cg.py no longer has the ray base f"
    ns = dict(cg_mod.__dict__)
    exec(compile(src.replace(old, "& (f_c <= f[None] - CG_LNSRCH_C")
                 .replace("from ..ops", "from poismf_torch.ops"),
                 "cg_fg_base", "exec"), ns)
    return {"ray": cg_mod.cg_update_ell, "fg": ns["cg_update_ell"]}


def main():
    import torch

    from poismf_torch import PoisMF, kernels, serve, train
    from poismf_torch.sparse import build_counts
    from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,
                                         synth_lastfm_like)

    if not torch.cuda.is_available():
        print("torch_cg_armijo_base_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    solvers = fg_base_solver()
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(cs.SEED),
                                         N_USERS, N_ITEMS, NNZ_TARGET)
    X = (rows, cols, vals, (N_USERS, N_ITEMS))
    X_new = cs.serving_data(N_ITEMS)
    sub = X_new[:512].tocoo()
    X_sub = {dt: build_counts(sub.row, sub.col, sub.data, 512, N_ITEMS,
                              dtype=dt) for dt in (np.float32, np.float64)}

    def rel(f, g):
        return (abs(float(f.sum() - g.sum())) / abs(float(g.sum())),
                float(((f - g).abs() / g.abs()).max()))

    threshold = serve.ELL_SERVE_NNZ_THRESHOLD
    for n_run, name in enumerate(("fg", "ray", "fg", "ray")):
        serve.cg_update_ell = train.cg_update_ell = solvers[name]
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        model = PoisMF(random_state=cs.SEED, device="cuda",
                       **cs.PATHS["cg"][0]).fit(X)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        print(f"base {name}: cg fit {fit_s:.2f} s, train LL (all pairs) "
              f"{model.eval_llk(include_missing=True):.9e}, launches fg "
              f"{kernels.launch_counts['fg']} rayf "
              f"{kernels.launch_counts['rayf']}", flush=True)
        p = model._params()
        B, Bsum, Amean = model._B, model.Bsum, model.Amean
        cpu = (B.cpu(), Bsum.cpu(), Amean.cpu())

        def objective(A):
            return cs.serving_objective(torch, A[:512], model.B, Bsum,
                                        X_new[:512], p.l2_reg)

        for maxupd in (5, 50):
            q = dataclasses.replace(p, maxupd=maxupd)
            serve.ELL_SERVE_NNZ_THRESHOLD = 0  # bf16 planes, as the batch
            kernels.reset_launch_counts()
            f_card = objective(serve.factors_multiple(
                B, Bsum, Amean, X_sub[np.float32], q).cpu())
            n_rayf = kernels.launch_counts["rayf"]
            f_cpu = objective(serve.factors_multiple(*cpu, X_sub[np.float32],
                                                     q))
            other = "ray" if name == "fg" else "fg"
            serve.cg_update_ell = solvers[other]
            same = torch.equal(f_cpu, objective(serve.factors_multiple(
                *cpu, X_sub[np.float32], q)))
            serve.cg_update_ell = solvers[name]
            s, w = rel(f_card, f_cpu)
            print(f"  base {name}, {maxupd * p.niter} iterations: summed "
                  f"objective card {float(f_card.sum()):.9e} cpu "
                  f"{float(f_cpu.sum()):.9e}, rel {s:.3e}, worst row "
                  f"{w:.3e}; rayf launches {n_rayf}; CPU equal under both "
                  f"bases: {same}", flush=True)
            if n_run == 0:
                serve.ELL_SERVE_NNZ_THRESHOLD = 10**12  # planes in B's dtype
                f32 = objective(serve.factors_multiple(
                    *cpu, X_sub[np.float32], q))
                f64 = objective(serve.factors_multiple(
                    *(t.double() for t in cpu), X_sub[np.float64], q))
                s, w = rel(f32, f64)
                print(f"  CPU alone, {maxupd * p.niter} iterations, float32 "
                      f"against float64: rel {s:.3e}, worst row {w:.3e}",
                      flush=True)
            serve.ELL_SERVE_NNZ_THRESHOLD = threshold
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
