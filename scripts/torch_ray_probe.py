#!/usr/bin/env python3
"""Probe the ray kernel (``poismf_torch/csrc/raygtd.cu``) on one NVIDIA GPU:
other launch plans, and what the copies and the arithmetic cost alone,
for both of its instances: with the g.d sums (raygtd, ray) and without
them (rayf).

    python3 scripts/torch_ray_probe.py

Synthetic [P, R] planes from seed 0 at the shapes of the Last.FM-scale
tncg path's largest item-side bucket (P=2048 x 3,840 rows, rows 82-100%
full: 9% padding) and shortest user-side bucket (P=16 x 103,424 rows, rows
of 1..16 counts: 47% padding), and of two buckets between and below them,
C = 1 and 4 candidates.  For each instance it

- checks the kernel against its plain version under the wrapper's plan;
- times ``poismf_raygtd`` / ``poismf_rayf`` under the wrapper's plan and
  under other warps per block and splits (median of 7 runs, CUDA events,
  twice);
- builds raygtd.cu three more times with ``-DPOISMF_RAY_VARIANT=1`` (loads
  and one add per value: the copies alone), ``=2`` (the terms on values
  made in registers: the arithmetic alone) and ``=3`` (the log and the
  division from the card's approximate units) into ``build/probe/`` and
  times them under the wrapper's plan; the last is also held against the
  plain version.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from poismf_torch import kernels  # noqa: E402
from poismf_torch.kernels import _lib  # noqa: E402

# (P, R, least share of a row's slots that hold a count)
SHAPES = ((2048, 3840, 0.82), (2048, 256, 0.5), (256, 8192, 0.5),
          (64, 2048, 0.5), (16, 103424, 0.0))
# instance: (C entry point, outputs a candidate, plain version -> nll rows
# first)
INSTANCES = {
    "raygtd": ("poismf_raygtd", 2, lambda *a: torch.stack(
        kernels.raygtd_multi_bucket_torch(*a))),
    "rayf": ("poismf_rayf", 1, lambda *a: kernels.rayf_multi_bucket_torch(
        *a)[None]),
}


def time_ms(fn, reps=7):
    """Median device ms of ``reps`` back-to-back runs: the card is first
    kept busy for some milliseconds, so that the runs and the events
    between them queue up and no wait for the host is timed."""
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


def variant_library(n: int) -> ctypes.CDLL:
    out = os.path.join(ROOT, "build", "probe")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"libray_variant{n}.so")
    subprocess.run(
        [_lib._nvcc(), *_lib.NVCC_FLAGS[:-2], f"-DPOISMF_RAY_VARIANT={n}",
         "-I", str(_lib.CSRC), "-shared", "-o", so,
         str(_lib.CSRC / "raygtd.cu")], check=True, timeout=900)
    lib = ctypes.CDLL(so)
    for fn, _, _ in INSTANCES.values():
        getattr(lib, fn).argtypes = getattr(_lib.library(), fn).argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    lib = _lib.library()
    variants = {n: variant_library(n) for n in (1, 2, 3)}
    g = torch.Generator(device="cuda").manual_seed(0)
    f32 = dict(dtype=torch.float32, device="cuda")
    for P, R, fill in SHAPES:
        lens = (fill + (1 - fill) * torch.rand(R, generator=g, device="cuda")
                ) * P
        lens = lens.ceil().clamp_(1, P)
        vals = torch.poisson(torch.full((P, R), 2.0, device="cuda"),
                             generator=g) + 1.0
        vals *= torch.arange(P, device="cuda")[:, None] < lens[None]
        px = torch.rand((P, R), generator=g, device="cuda") + 0.5
        pd = torch.randn((P, R), generator=g, device="cuda")
        nnz = int((vals > 0).sum())
        print(f"# P={P} R={R}: {nnz} nonzero slots of {P * R} "
              f"({1 - nnz / (P * R):.1%} padding)")
        for C in (1, 4):
            alphas = (torch.tensor([1e-3, 1e-2, 3e-2, 3.0][:C],
                                   device="cuda")[:, None]
                      * (0.5 + torch.rand((1, R), generator=g,
                                          device="cuda")))
            for inst, (entry, ns, plain) in INSTANCES.items():
                probe(inst, entry, ns, plain, lib, variants, px, pd, vals,
                      alphas, nnz, f32)
    return 0


def probe(inst, entry, ns, plain, lib, variants, px, pd, vals, alphas, nnz,
          f32):
    P, R = px.shape
    C = alphas.shape[0]
    ref = plain(px, pd, vals, alphas)
    plan = kernels.raygtd.plan_of(px, pd, vals, C, gud=ns == 2)
    out = torch.empty((ns, C, R), **f32)
    scratch = torch.empty((_lib.RAY_MAX_SPLITS, ns, C, R), **f32)

    def call(library, warps, per):
        rc = getattr(library, entry)(
            px.data_ptr(), pd.data_ptr(), vals.data_ptr(),
            alphas.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            C, P, R, warps, per, _lib.stream_of(px))
        _lib.check(rc, inst)

    out.fill_(7.0)
    call(lib, plan.warps, plan.p_per_split)
    for o, r in zip(out, ref):
        assert torch.equal(torch.isfinite(o), torch.isfinite(r))
        fin = torch.isfinite(r)
        err = float((o[fin] - r[fin]).abs().max())
        tol = 1e-4 * float(r[fin].abs().max())
        assert err <= tol, (inst, C, err, tol)
    nbytes = 4 * P * R + 8 * nnz + (1 + ns) * C * 4 * R
    tag = f"{inst} C={C} P={P} R={R}"
    print(f"# {tag}: agrees with the plain version; byte bound "
          f"{nbytes / 3.35e12 * 1e3:.4f} ms; wrapper's plan {plan}")
    plans = {(plan.warps, plan.p_per_split)}
    for warps in (1, 2, 4, 8):
        for splits in (1, 2, 4, 8, 16, 32):
            per = -(-P // splits)
            if (per >= 4 * warps and (splits > 1 or P <= 256)
                    and warps * splits * R >= 2 ** 17
                    and warps * ns * (1 << (C - 1).bit_length()) * 512
                    <= 48 * 1024):
                plans.add((warps, per))
    for warps, per in sorted(plans):
        t = [time_ms(lambda: call(lib, warps, per)) for _ in "ab"]
        print(f"{tag} warps={warps} p_per_split={per} "
              f"splits={-(-P // per)}: {t[0]:.4f} / {t[1]:.4f} ms",
              flush=True)
    for n, what in ((1, "copies alone"), (2, "arithmetic alone"),
                    (3, "approximate log and division")):
        t = time_ms(lambda: call(variants[n], plan.warps, plan.p_per_split))
        print(f"{tag} {what}, wrapper's plan: {t:.4f} ms", flush=True)
    same = all(torch.equal(torch.isnan(o), torch.isnan(r))
               and torch.equal(torch.isinf(o), torch.isinf(r))
               for o, r in zip(out, ref))
    fin = torch.isfinite(ref[0])
    err = float(((out[0] - ref[0])[fin].abs()
                 / (ref[0][fin].abs() + 1e-3)).max())
    print(f"{tag} approximate log and division: nll within {err:.2e} of "
          f"the plain version's (relative), inf/NaN pattern "
          f"{'identical' if same else 'DIFFERS'}")


if __name__ == "__main__":
    sys.exit(main())
