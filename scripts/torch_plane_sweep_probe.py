#!/usr/bin/env python3
"""Time the fgh, hvp and pg plane sweeps (poismf_torch/csrc/plane_sweep.cuh)
on one NVIDIA GPU under other launch plans than the wrapper's.

    python3 scripts/torch_plane_sweep_probe.py [--P 2048] [--R 3840] [--k 50]
        [--kernels fgh,hvp,hvp_bv,pg]

Synthetic bucket of the given shape (bf16 and f32 planes, seed 0, the
last 9.4% of each row's slots padding, as in the Last.FM-scale item
side's largest bucket).  For each plan (kg, pt, stages, splits) it checks
the kernel against the wrapper's own plan (bitwise for the same splits)
and prints the median ms of 7 runs with CUDA events and the achieved
GB/s of the bg plane; the wrapper's plan is also held against the plain
version.  The wrapper's plan is marked with '*'."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from poismf_torch import kernels  # noqa: E402
from poismf_torch.kernels import _lib  # noqa: E402


def time_ms(fn, reps=7):
    """Median device ms of ``reps`` back-to-back runs, queued behind ~10 ms
    of work so that no wait for the host is timed."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(20_000_000)
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    torch.cuda.synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1])
                            for i in range(reps)]))


def launch(kernel, bg, slots, rows, plan, w2=None, px=None, bv=None):
    k, P, R = bg.shape
    out_rows = _lib.SWEEP_OUT_ROWS[kernel](k)
    f32 = dict(dtype=torch.float32, device=bg.device)
    out = torch.empty((out_rows, R), **f32)
    splits = -(-P // plan.p_per_split)
    scratch = torch.empty((splits, out_rows, R), **f32) if splits > 1 \
        else None
    lib, bf16 = _lib.library(), int(bg.dtype == torch.bfloat16)
    common = (k, P, R, plan.kg, plan.pt, plan.stages, plan.p_per_split)
    if kernel == "fgh":
        rc = lib.poismf_fgh(bg.data_ptr(), bf16, slots.data_ptr(),
                            rows.data_ptr(), out.data_ptr(), w2.data_ptr(),
                            _lib.ptr(px), _lib.ptr(scratch), *common, 1.0,
                            _lib.stream_of(bg))
    elif kernel == "pg":
        rc = lib.poismf_pg(bg.data_ptr(), bf16, slots.data_ptr(),
                           rows.data_ptr(), out.data_ptr(), _lib.ptr(scratch),
                           *common, _lib.stream_of(bg))
    else:
        rc = lib.poismf_hvp(bg.data_ptr(), bf16, slots.data_ptr(),
                            rows.data_ptr(), out.data_ptr(), _lib.ptr(bv),
                            _lib.ptr(scratch), *common, _lib.stream_of(bg))
    _lib.check(rc, kernel)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--P", type=int, default=2048)
    ap.add_argument("--R", type=int, default=3840)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--kernels", default="fgh,hvp,hvp_bv",
                    help="of fgh, hvp, hvp_bv and pg")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    k, P, R = args.k, args.P, args.R
    print(torch.cuda.get_device_name(0), f"P={P} R={R} k={k}")
    g = torch.Generator(device="cuda").manual_seed(0)
    vals = torch.poisson(torch.full((P, R), 2.0, device="cuda"), generator=g)
    vals = vals + 1.0
    vals[int(P * 0.906):] = 0.0
    a_t = torch.rand((k, R), generator=g, device="cuda") * 0.3 + 0.01
    for pdt in (torch.bfloat16, torch.float32):
        bg = (torch.rand((k, P, R), generator=g, device="cuda") * 0.3).to(pdt)
        gb = bg.numel() * bg.element_size() / 1e9
        w2 = torch.empty((P, R), device="cuda")
        px = torch.empty((P, R), device="cuda")
        bv = torch.empty((P, R), device="cuda")
        for variant in args.kernels.split(","):
            kernel = "hvp" if variant == "hvp_bv" else variant
            base = _lib.sweep_plan(kernel, bg, vals)
            slots = w2 if kernel == "hvp" else vals
            kw = (dict(w2=w2, px=px) if kernel == "fgh"
                  else dict(bv=bv if variant == "hvp_bv" else None)
                  if kernel == "hvp" else {})
            launch("fgh", bg, vals, a_t, _lib.sweep_plan("fgh", bg, vals),
                   w2=w2, px=px)  # w2 for hvp
            ref = launch(kernel, bg, slots, a_t, base, **kw)
            plain = (torch.cat([o[None] if o.dim() == 1 else o for o in
                                kernels.fgh_bucket_torch(bg, vals, a_t)[:3]])
                     if kernel == "fgh"
                     else kernels.hvp_bucket_torch(bg, w2, a_t)[0]
                     if kernel == "hvp"
                     else kernels.pg_bucket_torch(bg, vals, a_t))
            fin = torch.isfinite(plain)
            err = float(((ref - plain).abs() / (plain.abs() + 1e-4 * float(
                plain[fin].abs().max())))[fin].max())
            print(f"  {variant} {str(pdt)[6:]}: the wrapper's plan against "
                  f"the plain version: max rel err {err:.2e}", flush=True)
            del plain
            plans, seen = [base], {(base.pt, base.stages, base.p_per_split)}
            for pt in (2, 4, 8):
                for stages in (2, 3, 4):
                    for spl in (base.p_per_split, -(-P // 4),
                                -(-P // 8), P):
                        per = -(-spl // pt) * pt
                        if (pt, stages, per) not in seen:
                            seen.add((pt, stages, per))
                            plans.append(_lib.SweepPlan(
                                base.kg, pt, stages, per, -(-P // per),
                                0, 0, 0))
            for plan in plans:
                try:
                    out = launch(kernel, bg, slots, a_t, plan, **kw)
                except RuntimeError as e:
                    print(f"  {variant} {str(pdt)[6:]} {plan}: {e}")
                    continue
                torch.cuda.synchronize()
                same = (torch.equal(out, ref) if plan.splits == base.splits
                        else torch.allclose(out, ref, rtol=1e-4, atol=1e-3))
                ms = time_ms(lambda: launch(kernel, bg, slots, a_t, plan,
                                            **kw))
                print(f"{'*' if plan is base else ' '} {variant:6s} "
                      f"{str(pdt)[6:]:8s} kg={plan.kg} pt={plan.pt} "
                      f"stages={plan.stages} splits={plan.splits:4d}: "
                      f"{ms:.4f} ms, {gb / ms * 1e3:.0f} GB/s of bg"
                      f"{'' if same else '  MISMATCH'}", flush=True)
        del bg
    return 0


if __name__ == "__main__":
    sys.exit(main())
