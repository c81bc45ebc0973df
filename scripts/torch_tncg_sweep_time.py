#!/usr/bin/env python3
"""Device time of the fgh and hvp kernels over one tncg epoch of the
PyTorch port, on one NVIDIA GPU.

    python3 scripts/torch_tncg_sweep_time.py [--scale 1.0]

Fits ``PoisMF(k=50, method="tncg", l2_reg=1e3, maxupd=750,
reuse_prev=True, plane_dtype="bfloat16", niter=1)`` (chip_smoke.py's tncg
main path) on synthetic Last.FM-360K-shaped data (seed 0).  Each call of
the kernels' C entry points (``poismf_fgh``, ``poismf_hvp``) is bracketed
by two CUDA events on the launch stream, so the time between them is the
kernel's (and its split-sum's) device time, plus any wait of the card for
the host inside the entry point.  Prints the launches and summed device
milliseconds of fgh and hvp (both variants), and the fit's wall seconds.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from poismf_torch import PoisMF  # noqa: E402
from poismf_torch.kernels import _lib  # noqa: E402
from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,  # noqa
                                     synth_lastfm_like)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    lib = _lib.library()
    events = {"poismf_fgh": [], "poismf_hvp": []}

    def timed(name, fn):
        def call(*a):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(*a)
            stop.record()
            events[name].append((start, stop))
            return rc
        return call

    for name in events:
        setattr(lib, name, timed(name, getattr(lib, name)))
    n_u, n_i = int(N_USERS * args.scale), int(N_ITEMS * args.scale)
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(0), n_u, n_i,
                                         int(NNZ_TARGET * args.scale))
    model = PoisMF(k=50, method="tncg", l2_reg=1e3, maxupd=750,
                   reuse_prev=True, plane_dtype="bfloat16", niter=1,
                   random_state=0, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.fit((rows, cols, vals, (n_u, n_i)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(torch.cuda.get_device_name(0))
    for name, pairs in events.items():
        ms = sum(a.elapsed_time(b) for a, b in pairs)
        print(f"{name[7:]}: {len(pairs)} launches, {ms:.1f} ms of device "
              f"time")
    print(f"tncg 1-epoch fit: {wall:.2f} s (ingest and ELL build included)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
