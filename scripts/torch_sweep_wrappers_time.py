#!/usr/bin/env python3
"""Time fgh, hvp, hvp_bv, fg, f, raygtd (4 candidates), ray, rayf (4
candidates), pg (k=10 and k=50), f_gtd, f_gtd_fused and f_gtd_multi (4
candidates) through their public wrappers (``poismf_torch.kernels.fgh_bucket``,
``hvp_bucket``, ``fg_bucket``, ``f_bucket``, ``raygtd_multi_bucket``,
``ray_bucket``, ``rayf_multi_bucket``, ``pg_bucket``, ``f_gtd_bucket``,
``f_gtd_fused_bucket``, ``f_gtd_multi_bucket``) on one NVIDIA GPU, at the
shapes of the Last.FM-scale
paths' largest item-side bucket (P=2048 x 3,840 rows) and shortest
user-side bucket (P=16 x 103,424 rows), k=50 (pg also at its published
k=10), bf16 and f32 planes.

    python3 scripts/torch_sweep_wrappers_time.py [--digests out.json]
        [--ptxas]

Synthetic planes from seed 0, the last 9.4% of each row's slots padding.
Only the wrappers' public signatures are used, so the script times any
tree of the port (run it from that tree's root).  Prints, for each kernel,
shape and plane type, the median device ms of 7 runs between CUDA events
(queued behind ~10 ms of work, so that no wait for the host is timed) and
the host's microseconds per call (200 calls enqueued without a
synchronisation: what a launch costs the solver's loop); k is 50 where
the name does not say otherwise.  f_gtd reads the <B, d> plane of the
direction that f_gtd_fused takes; f_gtd_multi steps from the same factors
along it (the steps raygtd takes, a [k] Bsum, l2 = 1e3, the linear terms on
every row).

``--digests`` writes a SHA-256 digest of every output of fgh, hvp,
hvp_bv, fg, f, pg (k=10 and 50), f_gtd, f_gtd_fused and f_gtd_multi at
each shape and plane type to a JSON file, so that two trees' kernel
libraries can be compared bit for bit on the same inputs (run both in one
call, on one card); ``--ptxas`` prints the compiler's register and spill
lines of the library it built.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from poismf_torch import kernels  # noqa: E402
from poismf_torch.kernels import _lib  # noqa: E402

SHAPES = ((2048, 3840), (16, 103424))
K = 50
# the kernels whose outputs --digests records
DIGESTED = ("fgh", "hvp", "hvp_bv", "fg", "f", "pg k=10", "pg k=50",
            "f_gtd", "f_gtd_fused", "f_gtd_multi")


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


def digest(out):
    """SHA-256 (16 hex digits) of each tensor a wrapper returned."""
    out = out if isinstance(out, tuple) else (out,)
    return [hashlib.sha256(t.contiguous().cpu().numpy().tobytes())
            .hexdigest()[:16] for t in out if t is not None]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--digests", default=None,
                    help="JSON file for the digests of the outputs of "
                         + ", ".join(DIGESTED))
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's register and spill lines")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(torch.cuda.get_device_name(0))
    _lib.library()
    if args.ptxas:
        for line in _lib.build_info.get("log", "").splitlines():
            if any(w in line for w in ("Function properties", "registers",
                                       "spill")):
                print("ptxas: " + line.strip())
    digests = {}
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
            bd = pd  # <B, v_t>: f_gtd's hoisted plane
            bsum = torch.rand(K, generator=g, device="cuda") * 100.0
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
                    ("pg k=50", lambda: kernels.pg_bucket(bg, vals, a_t)),
                    ("f_gtd", lambda: kernels.f_gtd_bucket(bg, vals, a_t,
                                                           bd)),
                    ("f_gtd_fused", lambda: kernels.f_gtd_fused_bucket(
                        bg, vals, a_t, v_t)),
                    ("f_gtd_multi", lambda: kernels.f_gtd_multi_bucket(
                        bg, vals, a_t, v_t, alphas, bsum, 1e3))):
                tag = f"{name} P={P} R={R} {str(pdt)[6:]}"
                if args.digests and name in DIGESTED:
                    digests[tag] = digest(fn())
                print(f"{name:7s} P={P} R={R} {str(pdt)[6:]}: "
                      f"{time_ms(fn):.4f} ms, host {host_us(fn):.1f} us a "
                      f"call", flush=True)
            del bg, bg10, w2, px, pd, bd, bsum
    if args.digests:
        with open(args.digests, "w") as f:
            json.dump(digests, f, indent=1)
        print(f"{len(digests)} output digests -> {args.digests}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
