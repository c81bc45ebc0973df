#!/usr/bin/env python3
"""Do two fits of the same data and seed give the same factors bit for
bit?  One GPU, or the CPU with ``--cpu``.

    python3 scripts/torch_repeat_fits.py [--fits tncg,cg,pg] [--scale 1.0]
        [--predict] [--mesh] [--assemble] [--cpu]

Fits each of ``chip_smoke.PATHS`` (tncg 1 epoch, cg 3 epochs, pg 10
epochs; chip_smoke.py's synthetic Last.FM-360K-shaped data, seed 0)
twice in one process, with the kernel launch counts set to 0 just before
each fit and read just after, and prints per fit the seconds (ingest and
layout build included), the launches and the SHA-256 of A and B.  A
checksum of the updated factors is kept after every half-update (an
integer sum of their bits, on the device); where the two fits differ,
the first half-update that differs is printed, and (unless
``--no-trace``) a third and fourth fit record a checksum of every ELL
op's and kernel wrapper's output, in call order, to name the first call
that differs.

``--predict`` also times ``PoisMF.predict`` over every training pair of
the tncg model and prints its peak device memory.  ``--mesh`` fits each
path twice more on a one-rank NCCL mesh (``PoisMF(mesh=...)``, the
row-sharded fit) and compares those two.  ``--assemble`` first times
``ops.ell._assemble`` alone on the item side's ELL (host us, device ms
and CUDA kernels a call).  The script puts its own
tree first on ``sys.path``: run the copy inside the tree you measure.
Exits nonzero when two fits of a path differ.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the ELL ops that a solver calls, and the kernel wrappers under them
OPS = ("gather_planes", "fgh_ell", "fg_ell", "f_ell", "hvp_ell",
       "hvp_bv_ell", "bdot_ell", "pg_grad_ell", "f_gtd_ray_ell",
       "f_gtd_ray_multi_ell", "f_ray_multi_ell", "bd_axpy_ell",
       "bd_select_ell", "adjusted_bsum_ell", "_assemble")
KERNELS = ("fgh_bucket", "hvp_bucket", "fg_bucket", "f_bucket", "pg_bucket",
           "raygtd_multi_bucket", "rayf_multi_bucket", "ray_bucket")


def _tensors(x):
    import torch

    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


def checksum(torch, t):
    """A device scalar: the sum of ``t``'s bits as integers (exact, so it
    is itself the same on every run)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    t = t.detach().contiguous()
    if t.dtype.is_floating_point:
        t = t.view(ints[t.element_size()])
    return t.sum(dtype=torch.int64)


class Recorder:
    """Wraps ``train._half_update`` and ``train.pg_epoch_ell`` (and with
    ``ops``, the ELL ops and kernel wrappers) to append (label, checksum)
    per output tensor of each call."""

    def __init__(self, torch, ops):
        self.torch, self.ops, self.log, self.saved = torch, ops, [], []

    def _wrap(self, mod, name, label):
        real = getattr(mod, name)
        torch = self.torch

        def wrapped(*args, **kw):
            out = real(*args, **kw)
            for i, t in enumerate(_tensors(out)):
                self.log.append((f"{label}[{i}]", checksum(torch, t)))
            return out

        self.saved.append((mod, name, real))
        setattr(mod, name, wrapped)

    def __enter__(self):
        from poismf_torch import kernels, train
        from poismf_torch.ops import ell as ell_ops

        self._wrap(train, "_half_update", "half-update")
        # pg runs its epochs, both halves, outside _half_update
        self._wrap(train, "pg_epoch_ell", "half-update (pg epoch; A, B)")
        if self.ops:
            for name in OPS:
                if hasattr(ell_ops, name):
                    self._wrap(ell_ops, name, name)
            for name in KERNELS:
                self._wrap(kernels, name, name)
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self.saved):
            setattr(mod, name, real)

    def values(self):
        vals = [int(v) for v in self.torch.stack(
            [c for _, c in self.log]).cpu()] if self.log else []
        return [(label, v) for (label, _), v in zip(self.log, vals)]


def fit_once(torch, dev, kw, X, ops=False, mesh=None):
    import chip_smoke
    from poismf_torch import PoisMF, kernels

    where = dict(mesh=mesh) if mesh is not None else dict(device=dev)
    model = PoisMF(random_state=chip_smoke.SEED, **kw, **where)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with Recorder(torch, ops) as rec:
        t0 = time.perf_counter()
        model.fit(X)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    digest = hashlib.sha256(model.A.tobytes() + model.B.tobytes()
                            ).hexdigest()
    return model, secs, launches, digest, rec.values()


def first_difference(a, b):
    """(index, label A, label B) of the first entry that differs."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x[0], y[0]
    if len(a) != len(b):
        n = min(len(a), len(b))
        return n, (a[n][0] if n < len(a) else "end"), (
            b[n][0] if n < len(b) else "end")
    return None


def compare_pair(torch, dev, path, kw, X, tag, mesh=None, trace=True):
    """Two fits of ``path``; True when A and B are bitwise equal."""
    runs = [fit_once(torch, dev, kw, X, mesh=mesh) for _ in range(2)]
    for i, (model, secs, launches, digest, halves) in enumerate(runs):
        print(f"# {tag}{path} fit {'AB'[i]}: {secs:.2f} s, train LL "
              f"{model.eval_llk(include_missing=True):.9e}, "
              f"{len(halves)} half-updates, launches {launches}, "
              f"sha256(A, B) {digest[:16]}", flush=True)
    same = runs[0][3] == runs[1][3]
    print(f"# {tag}{path}: A and B {'EQUAL' if same else 'DIFFER'} bitwise "
          f"between the two fits; launches "
          f"{'equal' if runs[0][2] == runs[1][2] else 'differ'}", flush=True)
    if not same and trace:
        d = first_difference(runs[0][4], runs[1][4])
        if d is not None:
            print(f"# {tag}{path}: first differing half-update output: "
                  f"number {d[0]} ({d[1]}; B is updated first)", flush=True)
        traced = [fit_once(torch, dev, kw, X, ops=True, mesh=mesh)[4]
                  for _ in range(2)]
        d = first_difference(*traced)
        if d is None:
            print(f"# {tag}{path}: the traced fits agree in all "
                  f"{len(traced[0])} op outputs", flush=True)
        else:
            half = sum(lbl.startswith("half-update")
                       for lbl, _ in traced[0][:d[0]])
            print(f"# {tag}{path}: first differing op output: call "
                  f"{d[0]} of {len(traced[0])}, {d[1]} (in half-update "
                  f"{half}; the op before it: "
                  f"{traced[0][d[0] - 1][0] if d[0] else 'none'})",
                  flush=True)
    return same, runs[0][0]


def predict_all(torch, dev, model, X):
    """``predict`` over every training pair; prints seconds and peak GB."""
    rows, cols = X[0], X[1]
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    out = model.predict(rows, cols)
    if cuda:
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    print(f"# predict over {rows.shape[0]} training pairs: {secs:.2f} s, "
          f"peak device memory {peak:.2f} GB "
          f"({peak - base if cuda else float('nan'):.2f} GB above the "
          f"factors), finite {bool(np.isfinite(out).all())}", flush=True)


def assemble_timing(torch, X, reps=200):
    """``ops.ell._assemble`` alone on the item side's ELL (its buckets all
    hold extension chunks), per output shape: host us a call (calls
    issued back to back), device ms a call (CUDA events, the calls
    queued behind ~10 ms of device work), CUDA kernels a call (from
    ``torch.profiler``) and whether two calls agree bit for bit."""
    from poismf_torch.ops import ell as ell_ops
    from poismf_torch.sparse import ingest

    ell = ell_ops.ell_from_counts(ingest(X).by_item, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((), (4,), (50,)):
        pieces = [torch.randn((b.n_rows,) + shape, generator=g,
                              device="cuda") for b in ell.buckets]

        def call():
            return ell_ops._assemble(ell, pieces, shape, torch.float32)

        same = torch.equal(call().view(torch.int32), call().view(torch.int32))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(20_000_000)
        ev[0].record()
        for _ in range(reps):
            call()
        ev[1].record()
        torch.cuda.synchronize()
        dev_ms = ev[0].elapsed_time(ev[1]) / reps
        try:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                call()
                torch.cuda.synchronize()
            kern = str(sum(1 for e in prof.events()
                           if e.device_type.name == "CUDA"))
        except Exception as e:  # the profiler may not trace this card
            kern = f"not measured ({type(e).__name__})"
        print(f"# _assemble, item side ({len(ell.buckets)} buckets, "
              f"{ell.n_rows_ell} slots), shape {shape}: host "
              f"{host_us:.1f} us a call, device {dev_ms:.4f} ms a call, "
              f"CUDA kernels a call {kern}; two calls bitwise "
              f"{'equal' if same else 'DIFFERENT'}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fits", default="tncg,cg,pg")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--predict", action="store_true")
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--no-trace", action="store_true",
                    help="do not look for the first differing output")
    ap.add_argument("--assemble", action="store_true",
                    help="also time _assemble alone (GPU only)")
    args = ap.parse_args()

    import torch

    import chip_smoke
    from poismf_torch.utils.data import (N_ITEMS, N_USERS, NNZ_TARGET,
                                         synth_lastfm_like)

    dev = torch.device("cpu" if args.cpu else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_repeat_fits: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        from poismf_torch.kernels import _lib

        t0 = time.perf_counter()
        _lib.library()
        print(f"# kernels built in {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"# tree {ROOT}, torch {torch.__version__}", flush=True)
    n_u, n_i = int(N_USERS * args.scale), int(N_ITEMS * args.scale)
    rows, cols, vals = synth_lastfm_like(np.random.default_rng(
        chip_smoke.SEED), n_u, n_i, int(NNZ_TARGET * args.scale))
    X = (rows, cols, vals, (n_u, n_i))
    if args.assemble and not args.cpu:
        assemble_timing(torch, X)
    ok = True
    for path in filter(None, args.fits.split(",")):
        same, model = compare_pair(torch, dev, path, chip_smoke.PATHS[path][0],
                                   X, "", trace=not args.no_trace)
        ok &= same
        if path == "tncg" and args.predict:
            predict_all(torch, dev, model, X)
        del model
    if args.mesh:
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        store = os.path.join(ROOT, "build", "repeat_fits_store")
        os.makedirs(os.path.dirname(store), exist_ok=True)
        if os.path.exists(store):
            os.remove(store)
        backend = "gloo" if args.cpu else "nccl"
        kw = {} if args.cpu else dict(device_id=torch.device("cuda", 0))
        if not args.cpu:
            torch.cuda.set_device(0)
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=0, world_size=1, **kw)
        try:
            mesh = init_device_mesh(dev.type, (1,))
            for path in filter(None, args.fits.split(",")):
                same, _ = compare_pair(torch, dev, path,
                                       chip_smoke.PATHS[path][0], X,
                                       "one-rank mesh ", mesh=mesh,
                                       trace=not args.no_trace)
                ok &= same
        finally:
            dist.destroy_process_group()
            os.remove(store)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
