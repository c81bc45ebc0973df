#!/usr/bin/env python3
"""Device time of the fgh, hvp and raygtd kernels over one tncg epoch of
the PyTorch port, of the fg and rayf kernels over a 3-epoch cg fit, and of
the pg kernel over a 10-epoch pg fit, on one NVIDIA GPU.

    python3 scripts/torch_tncg_sweep_time.py [--scale 1.0] [--shapes]
        [--fits tncg,cg,pg]

Fits ``PoisMF(k=50, method="tncg", l2_reg=1e3, maxupd=750,
reuse_prev=True, plane_dtype="bfloat16", niter=1)``, ``PoisMF(k=50,
method="cg", l2_reg=1e4, maxupd=5, plane_dtype="bfloat16", niter=3)`` and
``PoisMF(k=10, method="pg", l2_reg=1e9, maxupd=1, niter=10,
plane_dtype="bfloat16")`` (chip_smoke.py's three main paths; ``--fits``
picks some) on synthetic Last.FM-360K-shaped data (seed 0).  Each call of
the kernels' C entry points (``poismf_fgh``, ``poismf_hvp``,
``poismf_raygtd``, ``poismf_fg``, ``poismf_rayf``, ``poismf_pg``) is
bracketed by two CUDA events on the launch stream, so
the time between them is the kernel's (and its split-sum's) device time,
plus any wait of the card for the host inside the entry point: where the
card is starved by the host, as in these fits, that wait is most of a small
launch's bracket.  So the shapes of every raygtd, fg, rayf and pg call
are also counted, and after the fit each distinct shape is replayed
through the public wrapper on synthetic planes (rows 50-100% full) behind
a few milliseconds of queued work, where the events between the queued
launches time the card alone; the counts times these medians are the
kernel's device time over the fit.  Prints, per fit, the launches and
bracketed milliseconds of each kernel (hvp: both variants), the replayed
device milliseconds of raygtd, fg, rayf and pg, the fit's wall seconds,
its train LL (over all pairs and over the nonzeros) and, for cg, the ray
line search's rounds (``ell.f_ray_multi_ell`` calls).  Only the C entry
points' names and the public API are used, so the script also times an
older tree of the port (run it from that tree's root).
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
from poismf_torch.ops import ell as ell_ops  # noqa: E402
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
        if name in ("poismf_raygtd", "poismf_rayf"):  # k holds C
            px = torch.rand((P, R), generator=g, device="cuda") + 0.5
            pd = torch.randn((P, R), generator=g, device="cuda")
            al = torch.full((k, R), 1e-2, device="cuda")
            fn = (kernels.raygtd_multi_bucket if name == "poismf_raygtd"
                  else kernels.rayf_multi_bucket)
            total += count * queued_ms(lambda: fn(px, pd, vals, al))
        elif name == "poismf_pg":  # flag says bf16
            bg = (torch.rand((k, P, R), generator=g, device="cuda") * 0.3
                  ).to(torch.bfloat16 if flag[0] else torch.float32)
            a_t = torch.rand((k, R), generator=g, device="cuda") + 0.01
            total += count * queued_ms(
                lambda: kernels.pg_bucket(bg, vals, a_t))
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
    ap.add_argument("--fits", default="tncg,cg,pg",
                    help="the fits to run, of tncg, cg and pg")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    lib = _lib.library()
    events = {name: [] for name in ("poismf_fgh", "poismf_hvp",
                                    "poismf_raygtd", "poismf_fg",
                                    "poismf_rayf", "poismf_pg")}

    shapes = {"poismf_raygtd": {}, "poismf_fg": {}, "poismf_rayf": {},
              "poismf_pg": {}}

    def timed(name, fn):
        def call(*a):
            if name in ("poismf_raygtd", "poismf_rayf"):  # (.., C, P, R, ..)
                key = (a[6], a[7], a[8], None)
            elif name == "poismf_pg":  # (bg, bf16, vals, a_t, out, scr, k..)
                key = (a[6], a[7], a[8], (bool(a[1]),))
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
    real_ray, rounds = ell_ops.f_ray_multi_ell, [0]

    def counted_ray(*a, **kw):
        rounds[0] += 1
        return real_ray(*a, **kw)

    ell_ops.f_ray_multi_ell = counted_ray
    n_u, n_i = int(N_USERS * args.scale), int(N_ITEMS * args.scale)
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(0), n_u, n_i,
                                         int(NNZ_TARGET * args.scale))
    print(torch.cuda.get_device_name(0))
    fits = {
        "tncg": ("tncg 1-epoch", dict(k=50, method="tncg", l2_reg=1e3,
                                      maxupd=750, reuse_prev=True, niter=1)),
        "cg": ("cg 3-epoch", dict(k=50, method="cg", l2_reg=1e4, maxupd=5,
                                  niter=3)),
        "pg": ("pg 10-epoch", dict(k=10, method="pg", l2_reg=1e9, maxupd=1,
                                   niter=10)),
    }
    for label, kw in (fits[f] for f in args.fits.split(",")):
        model = PoisMF(plane_dtype="bfloat16", random_state=0,
                       device="cuda", **kw)
        for pairs in events.values():
            pairs.clear()
        for seen in shapes.values():
            seen.clear()
        rounds[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.fit((rows, cols, vals, (n_u, n_i)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"{label} train LL: {model.eval_llk(include_missing=True):.9e}"
              f" over all pairs, {model.eval_llk():.9e} over the nonzeros; "
              f"{rounds[0]} ray line-search rounds")
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
