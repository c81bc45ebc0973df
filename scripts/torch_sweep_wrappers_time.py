#!/usr/bin/env python3
"""Time fgh, hvp, hvp_bv, fg, f, raygtd (4 candidates), ray, rayf (4
candidates) and pg (k=10 and k=50) through their public wrappers
(``poismf_torch.kernels.fgh_bucket``, ``hvp_bucket``, ``fg_bucket``,
``f_bucket``, ``raygtd_multi_bucket``, ``ray_bucket``,
``rayf_multi_bucket``, ``pg_bucket``) on one NVIDIA GPU, at the shapes of
the Last.FM-scale paths' largest item-side bucket (P=2048 x 3,840 rows) and
shortest user-side bucket (P=16 x 103,424 rows), k=50 (pg also at its
published k=10), bf16 and f32 planes.

    python3 scripts/torch_sweep_wrappers_time.py

Synthetic planes from seed 0, the last 9.4% of each row's slots padding.
Only the wrappers' public signatures are used, so the script times any
tree of the port (run it from that tree's root).  Prints, for each kernel,
shape and plane type, the median device ms of 7 runs between CUDA events
(queued behind ~10 ms of work, so that no wait for the host is timed) and
the host's microseconds per call (200 calls enqueued without a
synchronisation: what a launch costs the solver's loop); k is 50 where
the name does not say otherwise.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from poismf_torch import kernels  # noqa: E402

SHAPES = ((2048, 3840), (16, 103424))
K = 50


def host_us(fn, calls=200):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def time_ms(fn, reps=7):
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


def main():
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    g = torch.Generator(device="cuda").manual_seed(0)
    for P, R in SHAPES:
        vals = torch.poisson(torch.full((P, R), 2.0, device="cuda"),
                             generator=g) + 1.0
        vals[int(P * 0.906):] = 0.0
        a_t = torch.rand((K, R), generator=g, device="cuda") * 0.3 + 0.01
        v_t = torch.randn((K, R), generator=g, device="cuda") * 0.1
        for pdt in (torch.bfloat16, torch.float32):
            bg = (torch.rand((K, P, R), generator=g, device="cuda")
                  * 0.3).to(pdt)
            _, _, _, w2, px = kernels.fgh_bucket(bg, vals, a_t)
            pd = kernels.hvp_bucket(bg, w2, v_t, True)[1]
            alphas = (torch.tensor([1e-3, 3e-3, 1e-2, 3e-2],
                                   device="cuda")[:, None]
                      * (0.5 + torch.rand((1, R), generator=g,
                                          device="cuda")))
            bg10, a_t10 = bg[:10].contiguous(), a_t[:10].contiguous()
            for name, fn in (
                    ("fgh", lambda: kernels.fgh_bucket(bg, vals, a_t)),
                    ("hvp", lambda: kernels.hvp_bucket(bg, w2, v_t)),
                    ("hvp_bv", lambda: kernels.hvp_bucket(bg, w2, v_t,
                                                          True)),
                    ("fg", lambda: kernels.fg_bucket(bg, vals, a_t)),
                    ("f", lambda: kernels.f_bucket(bg, vals, a_t)),
                    ("raygtd", lambda: kernels.raygtd_multi_bucket(
                        px, pd, vals, alphas)),
                    ("ray", lambda: kernels.ray_bucket(px, pd, vals,
                                                       alphas[:1])),
                    ("rayf", lambda: kernels.rayf_multi_bucket(
                        px, pd, vals, alphas)),
                    ("pg k=10", lambda: kernels.pg_bucket(bg10, vals,
                                                          a_t10)),
                    ("pg k=50", lambda: kernels.pg_bucket(bg, vals, a_t))):
                print(f"{name:7s} P={P} R={R} {str(pdt)[6:]}: "
                      f"{time_ms(fn):.4f} ms, host {host_us(fn):.1f} us a "
                      f"call", flush=True)
            del bg, bg10, w2, px, pd
    return 0


if __name__ == "__main__":
    sys.exit(main())
