#!/usr/bin/env python3
"""Two checks of the ray kernels' trial objectives on one NVIDIA GPU.

    python3 scripts/torch_ray_trial_probe.py

1. Trials that land exactly on zero: the inf/NaN pattern of rayf, raygtd
   (4 candidates) and ray (1) against their plain versions.  The inputs of
   ``tests/test_torch_cuda.py``'s zero-trial test, made here from seed 0:
   [64, 1024] planes, and on a third of the rows one slot whose
   ``px = -(alpha_c pd)`` (one float32 rounding), so that the plain
   version's trial ``px + (alpha_c pd)`` is exactly 0 at candidate c (+inf
   in nll_c) and negative at the larger steps (NaN).  A kernel that
   computes the trial as one fused multiply-add gets the product's
   rounding error instead, of either sign.  Prints, per kernel, the (row,
   candidate) pairs at +inf and at NaN for the plain version and the
   kernel, and the pairs where they differ.
2. Trials at step zero: the CG line search compares rayf's trial nll
   against fg's nll at the iterate, and at a step of zero the two are the
   same sum over a row's slots, of the same terms.  On a synthetic bucket
   (P=256 x 8,192 rows, k=50, bf16 planes, 9.4% padding) it prints how far
   rayf's nll at alpha = 0 lies from fg's (rows that differ, largest
   absolute and relative difference), for the kernels on the card, the
   plain versions on the card and the plain versions on the CPU.

Only the wrappers' public signatures are used, so the script also runs on
an older tree of the port (run it from that tree's root).
"""

from __future__ import annotations

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from poismf_torch import kernels  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    g = torch.Generator(device="cuda").manual_seed(0)
    P, R, C = 64, 1024, 4
    vals = torch.poisson(torch.full((P, R), 1.5, device="cuda"),
                         generator=g) + 1.0
    px = torch.rand((P, R), generator=g, device="cuda") + 0.5
    pd = torch.randn((P, R), generator=g, device="cuda") * 0.1
    alphas = torch.tensor([0.1, 0.2, 0.4, 0.8], device="cuda")[:, None] \
        * (0.5 + torch.rand((1, R), generator=g, device="cuda"))
    rows = torch.arange(0, R, 3, device="cuda")
    slot, cand = rows % P, rows % C
    d = -(0.3 + torch.rand(rows.shape, generator=g, device="cuda"))
    pd[slot, rows] = d
    px[slot, rows] = -(alphas[cand, rows] * d)
    for name, kern, plain, al in (
            ("rayf", kernels.rayf_multi_bucket,
             kernels.rayf_multi_bucket_torch, alphas),
            ("raygtd", lambda *a: kernels.raygtd_multi_bucket(*a)[0],
             lambda *a: kernels.raygtd_multi_bucket_torch(*a)[0], alphas),
            ("ray", lambda *a: kernels.ray_bucket(*a)[0][None],
             lambda *a: kernels.ray_bucket_torch(*a)[0][None],
             alphas[C - 1:C])):
        ref, out = plain(px, pd, vals, al), kern(px, pd, vals, al)
        torch.cuda.synchronize()
        differ = int(((torch.isnan(ref) != torch.isnan(out))
                      | (torch.isinf(ref) != torch.isinf(out))).sum())
        print(f"{name} C={al.shape[0]}: plain {int(torch.isposinf(ref).sum())}"
              f" +inf, {int(torch.isnan(ref).sum())} NaN; kernel "
              f"{int(torch.isposinf(out).sum())} +inf, "
              f"{int(torch.isnan(out).sum())} NaN; {differ} of "
              f"{ref.numel()} (row, candidate) pairs differ", flush=True)
    step_zero(g)
    return 0


def step_zero(g):
    P, R, k = 256, 8192, 50
    vals = torch.poisson(torch.full((P, R), 2.0, device="cuda"),
                         generator=g) + 1.0
    vals[int(P * 0.906):] = 0.0
    bg = (torch.rand((k, P, R), generator=g, device="cuda") * 0.3
          ).to(torch.bfloat16)
    a_t = torch.rand((k, R), generator=g, device="cuda") * 0.3 + 0.01
    pd = torch.randn((P, R), generator=g, device="cuda") * 0.1
    zero = torch.zeros((4, R), device="cuda")
    for label, fg, rayf, dev in (
            ("kernels on the card", kernels.fg_bucket,
             kernels.rayf_multi_bucket, "cuda"),
            ("plain versions on the card", kernels.fg_bucket_torch,
             kernels.rayf_multi_bucket_torch, "cuda"),
            ("plain versions on the CPU", kernels.fg_bucket_torch,
             kernels.rayf_multi_bucket_torch, "cpu")):
        nll, _, px = fg(*(t.to(dev) for t in (bg, vals, a_t)))
        trial = rayf(px, pd.to(dev), vals.to(dev), zero.to(dev))
        diff = (trial - nll[None]).abs().double()
        rel = float((diff / nll[None].abs().double()).max())
        print(f"step zero, {label}: rayf's nll differs from fg's on "
              f"{int((diff > 0).any(0).sum())} of {R} rows; largest "
              f"difference {float(diff.max()):.3e} (nll up to "
              f"{float(nll.abs().max()):.3e}), relative {rel:.2e}",
              flush=True)


if __name__ == "__main__":
    sys.exit(main())
