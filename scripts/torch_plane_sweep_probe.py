#!/usr/bin/env python3
"""Time the fgh, hvp, pg, f_gtd, f_gtd_fused and f_gtd_multi plane sweeps
(poismf_torch/csrc/plane_sweep.cuh) on one NVIDIA GPU under other launch
plans than the wrapper's.

    python3 scripts/torch_plane_sweep_probe.py [--P 2048] [--R 3840] [--k 50]
        [--kernels fgh,hvp,hvp_bv,pg,f_gtd,f_gtd_fused,f_gtd_multi]

Synthetic bucket of the given shape (bf16 and f32 planes, seed 0, the
last 9.4% of each row's slots padding, as in the Last.FM-scale item
side's largest bucket).  For each plan (kg, pt, stages, splits) it checks
the kernel against the wrapper's own plan (bitwise for the same splits
and slot tile) and prints the median ms of 7 runs with CUDA events and
the achieved GB/s of the bg plane; the wrapper's plan is also held
against the plain version.  The wrapper's plan is marked with '*'.
f_gtd_fused takes a random direction d_t, f_gtd its <B, d> plane;
f_gtd_multi steps along d_t at C = 4 and at C = 8 candidates (a [k] Bsum,
l2 = 1e3, the linear terms on every row), also at 1-slot tiles."""

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


def launch(kernel, bg, slots, rows, plan, w2=None, px=None, bv=None,
           direction=None, alphas=None, bsum=None):
    k, P, R = bg.shape
    C = 1 if alphas is None else alphas.shape[0]
    out_rows = _lib.SWEEP_OUT_ROWS[kernel](k, C)
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
    elif kernel == "f_gtd_multi":
        # rows: the factors x, direction: d_t
        rc = lib.poismf_f_gtd_multi(
            bg.data_ptr(), bf16, slots.data_ptr(), rows.data_ptr(),
            direction.data_ptr(), alphas.data_ptr(), bsum.data_ptr(), 0,
            None, 1e3, 1.0, 0, out.data_ptr(), _lib.ptr(scratch), C,
            *common, _lib.stream_of(bg))
    elif kernel in ("f_gtd", "f_gtd_fused"):
        # direction: the bd plane (f_gtd) or d_t (f_gtd_fused)
        rc = getattr(lib, f"poismf_{kernel}")(
            bg.data_ptr(), bf16, slots.data_ptr(), rows.data_ptr(),
            direction.data_ptr(), out.data_ptr(), _lib.ptr(scratch), *common,
            _lib.stream_of(bg))
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
                    help="of fgh, hvp, hvp_bv, pg, f_gtd, f_gtd_fused and "
                         "f_gtd_multi")
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
    d_t = torch.randn((k, R), generator=g, device="cuda") * 0.1
    steps = torch.tensor([1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0],
                         device="cuda")[:, None]
    bsum = torch.rand(k, generator=g, device="cuda") * 100.0
    variants = [v for name in args.kernels.split(",")
                for v in ((f"{name} C=4", f"{name} C=8")
                          if name == "f_gtd_multi" else (name,))]
    for pdt in (torch.bfloat16, torch.float32):
        bg = (torch.rand((k, P, R), generator=g, device="cuda") * 0.3).to(pdt)
        gb = bg.numel() * bg.element_size() / 1e9
        w2 = torch.empty((P, R), device="cuda")
        px = torch.empty((P, R), device="cuda")
        bv = torch.empty((P, R), device="cuda")
        bd = (bg.float() * d_t[:, None, :]).sum(0)
        for variant in variants:
            kernel = ("hvp" if variant == "hvp_bv"
                      else variant.split()[0])
            C = int(variant.split("C=")[1]) if "C=" in variant else 1
            alphas = steps[:C].contiguous() * torch.ones((1, R),
                                                         device="cuda")
            base = _lib.sweep_plan(kernel, bg, vals,
                                   *((bd,) if kernel == "f_gtd" else ()),
                                   C=C)
            slots = w2 if kernel == "hvp" else vals
            kw = (dict(w2=w2, px=px) if kernel == "fgh"
                  else dict(bv=bv if variant == "hvp_bv" else None)
                  if kernel == "hvp"
                  else dict(direction=bd) if kernel == "f_gtd"
                  else dict(direction=d_t) if kernel == "f_gtd_fused"
                  else dict(direction=d_t, alphas=alphas, bsum=bsum)
                  if kernel == "f_gtd_multi"
                  else {})
            launch("fgh", bg, vals, a_t, _lib.sweep_plan("fgh", bg, vals),
                   w2=w2, px=px)  # w2 for hvp
            ref = launch(kernel, bg, slots, a_t, base, **kw)
            plain = (torch.cat([o[None] if o.dim() == 1 else o for o in
                                kernels.fgh_bucket_torch(bg, vals, a_t)[:3]])
                     if kernel == "fgh"
                     else kernels.hvp_bucket_torch(bg, w2, a_t)[0]
                     if kernel == "hvp"
                     else torch.stack(kernels.f_gtd_bucket_torch(bg, vals,
                                                                 a_t, bd))
                     if kernel == "f_gtd"
                     else torch.stack(kernels.f_gtd_fused_bucket_torch(
                         bg, vals, a_t, d_t))
                     if kernel == "f_gtd_fused"
                     else torch.cat(kernels.f_gtd_multi_bucket_torch(
                         bg, vals, a_t, d_t, alphas, bsum, 1e3, 1.0, False))
                     if kernel == "f_gtd_multi"
                     else kernels.pg_bucket_torch(bg, vals, a_t))
            fin = torch.isfinite(plain)
            err = float(((ref - plain).abs() / (plain.abs() + 1e-4 * float(
                plain[fin].abs().max())))[fin].max())
            print(f"  {variant} {str(pdt)[6:]}: the wrapper's plan against "
                  f"the plain version: max rel err {err:.2e}", flush=True)
            del plain
            plans, seen = [base], {(base.pt, base.stages, base.p_per_split)}
            for pt in ((1, 2, 4, 8) if kernel == "f_gtd_multi"
                       else (2, 4, 8)):
                for stages in (2, 3, 4):
                    for spl in (base.p_per_split, -(-P // 4),
                                -(-P // 8), P):
                        per = -(-spl // pt) * pt
                        if (pt, stages, per) not in seen:
                            seen.add((pt, stages, per))
                            plans.append(_lib.SweepPlan(
                                base.kg, pt, stages, per, -(-P // per),
                                0, 0, 0, base.slot_planes))
            for plan in plans:
                try:
                    out = launch(kernel, bg, slots, a_t, plan, **kw)
                except RuntimeError as e:
                    print(f"  {variant} {str(pdt)[6:]} {plan}: {e}")
                    continue
                torch.cuda.synchronize()
                # the row sums (fgh's nll, f_gtd's nll and g.d) are added in
                # an order that follows the slot tile as well as the splits
                same = (torch.equal(out, ref)
                        if (plan.splits, plan.pt) == (base.splits, base.pt)
                        else torch.allclose(out, ref, rtol=1e-4, atol=1e-3))
                ms = time_ms(lambda: launch(kernel, bg, slots, a_t, plan,
                                            **kw))
                print(f"{'*' if plan is base else ' '} {variant:6s} "
                      f"{str(pdt)[6:]:8s} kg={plan.kg} pt={plan.pt} "
                      f"stages={plan.stages} splits={plan.splits:4d}: "
                      f"{ms:.4f} ms, {gb / ms * 1e3:.0f} GB/s of bg"
                      f"{'' if same else '  MISMATCH'}", flush=True)
        del bg, bd
    return 0


if __name__ == "__main__":
    sys.exit(main())
