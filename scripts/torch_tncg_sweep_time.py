#!/usr/bin/env python3
"""Device time of the fgh, hvp and raygtd kernels over one tncg epoch of
the PyTorch port, and of the fg and rayf kernels over a 3-epoch cg fit, on
one NVIDIA GPU.

    python3 scripts/torch_tncg_sweep_time.py [--scale 1.0] [--shapes]

Fits ``PoisMF(k=50, method="tncg", l2_reg=1e3, maxupd=750,
reuse_prev=True, plane_dtype="bfloat16", niter=1)`` and then
``PoisMF(k=50, method="cg", l2_reg=1e4, maxupd=5, plane_dtype="bfloat16",
niter=3)`` (chip_smoke.py's tncg and cg main paths) on synthetic
Last.FM-360K-shaped data (seed 0).  Each call of the kernels' C entry
points (``poismf_fgh``, ``poismf_hvp``, ``poismf_raygtd``, ``poismf_fg``,
``poismf_rayf``) is bracketed by two CUDA events on the launch stream, so
the time between them is the kernel's (and its split-sum's) device time,
plus any wait of the card for the host inside the entry point: where the
card is starved by the host, as in these fits, that wait is most of a small
launch's bracket.  So the shapes of every raygtd and fg call are also
counted, and after the fit each distinct shape is replayed through the
public wrapper on synthetic planes (rows 50-100% full) behind a few
milliseconds of queued work, where the events between the queued launches
time the card alone; the counts times these medians are the kernel's
device time over the fit.  Prints, per fit, the launches and bracketed
milliseconds of each kernel (hvp: both variants), the replayed device
milliseconds of raygtd and fg, and the fit's wall seconds.
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
from poismf_torch import PoisMF, kernels  # noqa: E402
from poismf_torch.kernels import _lib  # noqa: E402
from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,  # noqa
                                     synth_lastfm_like)


def queued_ms(fn, reps=5):
    """Median device ms of back-to-back runs queued behind ~2 ms of work,
    so that no wait for the host lies between the events."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(4_000_000)
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1])
                            for i in range(reps)]))


def replay_ms(name, shapes, show):
    """Sum over the counted shapes of count x the wrapper's queued device
    time on synthetic planes of that shape; ``show`` prints each shape."""
    g = torch.Generator(device="cuda").manual_seed(0)
    total = 0.0
    for (k, P, R, flag), count in sorted(shapes.items()):
        before = total
        lens = ((0.5 + 0.5 * torch.rand(R, generator=g, device="cuda")) * P
                ).ceil()
        vals = ((torch.arange(P, device="cuda")[:, None] < lens[None])
                * 2.0).contiguous()
        if name == "poismf_raygtd":  # k holds C
            px = torch.rand((P, R), generator=g, device="cuda") + 0.5
            pd = torch.randn((P, R), generator=g, device="cuda")
            al = torch.full((k, R), 1e-2, device="cuda")
            total += count * queued_ms(
                lambda: kernels.raygtd_multi_bucket(px, pd, vals, al))
        else:  # fg: flag says bf16, and whether px is written
            bg = (torch.rand((k, P, R), generator=g, device="cuda") * 0.3
                  ).to(torch.bfloat16 if flag[0] else torch.float32)
            a_t = torch.rand((k, R), generator=g, device="cuda") + 0.01
            total += count * queued_ms(
                lambda: kernels.fg_bucket(bg, vals, a_t, want_pred=flag[1]))
        if show:
            print(f"  {name[7:]} k or C={k} P={P} R={R}: {count} launches x "
                  f"{(total - before) / count:.4f} ms")
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--shapes", action="store_true",
                    help="print every replayed shape with its launches")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    lib = _lib.library()
    events = {name: [] for name in ("poismf_fgh", "poismf_hvp",
                                    "poismf_raygtd", "poismf_fg",
                                    "poismf_rayf")}

    shapes = {"poismf_raygtd": {}, "poismf_fg": {}}

    def timed(name, fn):
        def call(*a):
            if name == "poismf_raygtd":  # (..., C, P, R, ...)
                key = (a[6], a[7], a[8], None)
            elif name == "poismf_fg":  # (bg, bf16, ..., px, scratch, k, P, R)
                key = (a[7], a[8], a[9], (bool(a[1]), a[5] is not None))
            if name in shapes:
                shapes[name][key] = shapes[name].get(key, 0) + 1
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
    print(torch.cuda.get_device_name(0))
    for label, kw in (
            ("tncg 1-epoch", dict(method="tncg", l2_reg=1e3, maxupd=750,
                                  reuse_prev=True, niter=1)),
            ("cg 3-epoch", dict(method="cg", l2_reg=1e4, maxupd=5, niter=3))):
        model = PoisMF(k=50, plane_dtype="bfloat16", random_state=0,
                       device="cuda", **kw)
        for pairs in events.values():
            pairs.clear()
        for seen in shapes.values():
            seen.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit((rows, cols, vals, (n_u, n_i)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for name, pairs in events.items():
            if pairs:
                ms = sum(a.elapsed_time(b) for a, b in pairs)
                print(f"{label} {name[7:]}: {len(pairs)} launches, {ms:.1f} "
                      f"ms between the events around them")
        print(f"{label} fit: {wall:.2f} s (ingest and ELL build included)",
              flush=True)
        del model
        for name, seen in shapes.items():
            if seen:
                n = sum(seen.values())  # the replay's own calls count too
                ms = replay_ms(name, dict(seen), args.shapes)
                print(f"{label} {name[7:]}: {n} launches of {len(seen)} "
                      f"shapes, {ms:.1f} ms of device time replayed",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
