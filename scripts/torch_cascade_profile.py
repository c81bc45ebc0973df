#!/usr/bin/env python3
"""The tncg cascade's rounds, half by half, over a fit of several epochs
of the published tncg configuration, on one NVIDIA GPU.

    python3 scripts/torch_cascade_profile.py [--niter 3] [--runs on,off]
        [--events] [--scale 1.0] [--cpu]

Fits ``PoisMF(k=50, method="tncg", l2_reg=1e3, maxupd=750,
reuse_prev=True, plane_dtype="bfloat16")`` (``bench.py``'s flagship
configuration) for ``--niter`` epochs on chip_smoke.py's synthetic
Last.FM-360K-shaped data (seed 0), once per entry of ``--runs``: "on"
with the profile-adaptive compact plans, "off" under
``POISMF_ADAPTIVE_PLAN=0`` (a tree without those plans ignores it).
Prints per half-update its side, wall seconds and every round
(structure, active rows in -> out; where the tree records them, the
plan's denominator, 0 for a profile plan, and the adaptive plans built
by size class with their caps), the full-structure rounds it ran on
tails of at most half the rows, and the hand kernels' launches and the
slots they swept (P x R of each launch's bucket); per fit the wall
(ingest and layout build included), peak device memory, train LL over
all pairs, exact-zero shares, launches by kernel and rounds by
structure.  ``--events`` brackets each hand-kernel launch with two CUDA
events and prints per half their summed milliseconds: the kernels'
device time plus the card's wait for the host inside each bracket
(most of a short launch's bracket in these host-bound fits).  ``--cpu``
rehearses it on the CPU at a small ``--scale``.  The script puts its
own tree first on ``sys.path``: run the copy inside the tree you
measure.
"""

from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PUBLISHED = dict(k=50, method="tncg", l2_reg=1e3, maxupd=750,
                 reuse_prev=True, plane_dtype="bfloat16")


# the hand kernels' wrappers in poismf_torch.kernels that a tncg fit
# launches, and the argument whose last two dimensions are the bucket's
# [P, R] slots
WRAPPERS = {"fgh_bucket": 0, "hvp_bucket": 0, "raygtd_multi_bucket": 0}


def describe(trace):
    """(round list, full rounds on tails of at most half the rows, plans)
    of one half's trace."""
    n_all = trace[0][2]
    rounds, small_full, plans = [], 0, None
    for e in trace:
        r, s, a, b = e[:4]
        rounds.append(f"{r}:{s}:{a}->{b}")
        small_full += int(s == "full" and r > 0 and 2 * a <= n_all)
        if len(e) > 5:
            plans = e[5]
    return rounds, small_full, plans


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--niter", type=int, default=3)
    ap.add_argument("--runs", default="on,off")
    ap.add_argument("--events", action="store_true")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dev = "cpu" if args.cpu else "cuda"

    import torch

    from poismf_torch import PoisMF, kernels, train
    from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,
                                         synth_lastfm_like)

    if not args.cpu:
        if not torch.cuda.is_available():
            print("torch_cascade_profile: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        from poismf_torch.kernels import _lib

        _lib.library()  # the build stays out of the first half's time
    sync = torch.cuda.synchronize if not args.cpu else (lambda: None)
    n_u, n_i = int(N_USERS * args.scale), int(N_ITEMS * args.scale)
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(0), n_u, n_i,
                                         int(NNZ_TARGET * args.scale))
    X = (rows, cols, vals, (n_u, n_i))

    halves = []
    per_kernel = {}  # this half's {kernel: [launches, slots, events]}

    def wrap(name, fn):
        def call(*a, **kw):
            P, R = a[WRAPPERS[name]].shape[-2:]
            rec = per_kernel.setdefault(name, [0, 0, []])
            rec[0] += 1
            rec[1] += int(P) * int(R)
            if not args.events:
                return fn(*a, **kw)
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            rec[2].append(ev)
            return out
        return call

    if not args.cpu:
        for name in WRAPPERS:
            setattr(kernels, name, wrap(name, getattr(kernels, name)))
    cascade = train._tncg_cascade

    def traced(*a, trace=None, **kw):
        trace = [] if trace is None else trace
        ell = a[3]
        per_kernel.clear()
        sync()
        t0 = time.perf_counter()
        out = cascade(*a, trace=trace, **kw)
        sync()
        work = {name: (n, slots, sum(s.elapsed_time(e) for s, e in evs))
                for name, (n, slots, evs) in per_kernel.items()}
        halves.append((ell.n_rows, time.perf_counter() - t0, trace, work))
        return out

    train._tncg_cascade = traced
    for run in args.runs.split(","):
        if run == "off":
            os.environ["POISMF_ADAPTIVE_PLAN"] = "0"
        else:
            os.environ.pop("POISMF_ADAPTIVE_PLAN", None)
        halves.clear()
        kernels.reset_launch_counts()
        if not args.cpu:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        sync()
        t0 = time.perf_counter()
        model = PoisMF(random_state=0, device=dev, niter=args.niter,
                       **PUBLISHED).fit(X)
        sync()
        wall = time.perf_counter() - t0
        peak = (0.0 if args.cpu
                else torch.cuda.max_memory_allocated() / 1e9)
        launches = {k: v for k, v in kernels.launch_counts.items() if v}
        by_structure = collections.Counter(
            e[1] for _, _, trace, _ in halves for e in trace)
        small_full_total = 0
        print(f"# run {run} (niter {args.niter}): fit {wall:.2f} s, peak "
              f"device memory {peak:.2f} GB, train LL (all pairs) "
              f"{model.eval_llk(include_missing=True):.6e}, exact zeros "
              f"A {(model.A == 0).mean():.4f} B {(model.B == 0).mean():.4f}",
              flush=True)
        for h, (n_rows, secs, trace, work) in enumerate(halves):
            rounds, small_full, plans = describe(trace)
            small_full_total += small_full
            side = "item" if n_rows == n_i else "user"
            kern = "; ".join(
                f"{name[:-7]} {n} launches, {slots / 1e6:.1f}M slots"
                + (f", {ms:.1f} ms bracketed" if args.events else "")
                for name, (n, slots, ms) in work.items())
            print(f"#   half {h} ({side}, epoch {h // 2}): {secs:.2f} s; "
                  f"full rounds on tails <= 50%: {small_full}; adaptive "
                  f"plans {plans}; {kern}", flush=True)
            print("#     " + " ".join(rounds), flush=True)
        print(f"# run {run}: rounds by structure {dict(by_structure)}; full "
              f"rounds on tails <= 50%: {small_full_total}; launches "
              f"{launches}", flush=True)
        del model
    train._tncg_cascade = cascade
    return 0


if __name__ == "__main__":
    sys.exit(main())
