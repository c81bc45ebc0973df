#!/usr/bin/env python3
"""Time the PyTorch port's serving solves on one GPU.

    python3 scripts/torch_serving_time.py [--reps 3]

Fits each of ``chip_smoke.py``'s main-path configurations on the same
synthetic Last.FM-360K-scale data (tncg cut to one epoch, cg to 3, pg in
full), then runs ``chip_smoke.py``'s serving phase from it ``--reps``
times (its timings, launch counts and checks: ``transform`` of 16,384 new
users, for tncg ``predict_factors`` of 8 single users and
``topN_batched(exclude_seen=True)`` for 1,024 training users), and
``transform`` once more under ``torch.profiler``: the summed time of the
device kernels, the share of the traced wall the card was busy, the hand
kernels' part, and the kernels that took most.

Prints the card's name and power limit first.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def device_ms(prof):
    """(summed kernel ms, the hand kernels' ms, top kernels) of a
    torch.profiler run: device-side events only (the aten ops that
    launched them carry the same time and are left out)."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        if t > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((t / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    hand = sum(r[0] for r in rows if "poismf::" in r[1])
    return sum(r[0] for r in rows), hand, rows[:8]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from poismf_torch import PoisMF
    from poismf_torch.kernels import _lib
    from poismf_torch.sparse import ingest
    from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,
                                         synth_lastfm_like)

    if not torch.cuda.is_available():
        print("torch_serving_time: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(cs.SEED),
                                         N_USERS, N_ITEMS, NNZ_TARGET)
    X = (rows, cols, vals, (N_USERS, N_ITEMS))
    data = ingest(X)
    X_new = cs.serving_data(N_ITEMS)
    q = np.random.default_rng(cs.SEED).choice(N_USERS, 1024, replace=False)
    _lib.library()
    for path, (kw, _) in cs.PATHS.items():
        model = PoisMF(random_state=cs.SEED, device="cuda", **kw).fit(X)
        for _ in range(args.reps):
            cs.serving_phase(torch, model, path, X_new, data, q, {})
        # last, as the profiler may leave the host slower after it
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.transform(X_new)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        dev, hand, top = device_ms(prof)
        print(f"{path} transform traced: {traced:.3f} s; device kernels "
              f"{dev:.1f} ms ({dev / 1e3 / traced:.1%} of the traced wall), "
              f"of which the hand kernels {hand:.1f} ms", flush=True)
        for ms, name, n in top:
            print(f"  {ms:9.2f} ms  {n:7d} x  {name[:90]}")
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
