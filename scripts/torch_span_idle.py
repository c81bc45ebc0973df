#!/usr/bin/env python3
"""The card's idle time in the benchmark's cells put down to the port's
spans, the host syncs by site, and what recording costs, on one NVIDIA
GPU.

    python3 scripts/torch_span_idle.py [--cells tncg-lastfm.fit,...]
        [--seed N] [--seconds 40] [--cost 1] [--cpu]

(``--cells ""``: the clock check alone.)

Per cell of ``BENCHMARK.json`` (default: all), the cell's own set-up
(``benchmark/kinds/<kind>.py``), then its measured window three ways, the
fit cells' cascade state dropped before each as set-up leaves it:

* traced: ``profiling.SPANS`` set to a ``Recorder`` and ``torch.profiler``
  on the card's activity alone over the window, the window's ends taken
  on ``time.time_ns()`` after a synchronise; the idle intervals split
  over the innermost span timeline (``benchmark/spans.py``).  Prints the
  cell's ``device_idle`` (as ``benchmark/trace.idle_share`` reads it),
  the idle shares under ``solver.*``, ``cascade.*`` and ``topn.lists``,
  the share of the idle time inside program spans, host syncs a fit
  epoch, a note of idle seconds by span and syncs by site, and the
  longest gaps, each under its innermost span;
* with ``--cost 1``, untraced, in turns with recording off, on, on, off:
  the cell's end-to-end metric of each window.

First, on the card, the recorder's clock against the profiler's device
times (:func:`clock`).

Every number is a device-clock or host-clock reading of this run; the
last line is the card's name and power limit.  ``--cpu`` rehearses the
flow at a tiny size on the CPU (no profiler, no device metric).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import core, env  # noqa: E402

env.pin_caches()

import torch  # noqa: E402

from benchmark import spans as bs  # noqa: E402
from benchmark import trace as tr  # noqa: E402
from poismf_torch.utils import profiling  # noqa: E402

TINY = {"n_users": 200, "n_items": 80, "nnz": 2000}


def _reset(cell, state):
    if cell.traffic["kind"] == "fit":
        for ell in state["pair"]:
            ell.host.pop("cascade", None)


def _sync(device):
    if device.startswith("cuda"):
        torch.cuda.synchronize()


def traced(cell, kind, run, state):
    """One window with the recorder and the profiler on; prints its
    readings."""
    from torch.profiler import ProfilerActivity, profile

    _reset(cell, state)
    rec = profiling.Recorder()
    on_card = run.device.startswith("cuda")
    run.trace = True
    profiling.SPANS = rec
    try:
        _sync(run.device)
        with (profile(activities=[ProfilerActivity.CUDA]) if on_card
              else contextlib.nullcontext()) as prof:
            _sync(run.device)
            t0 = time.time_ns()
            kind.window(run, state)
            _sync(run.device)
            t1 = time.time_ns()
    finally:
        profiling.SPANS = None
        run.trace = False
    window_s = (t1 - t0) * 1e-9
    epochs = run.window.get("epochs")
    kind.release(run, state)
    print(f"{cell.name}: traced window {window_s:.3f} s, {len(rec.spans)} "
          f"spans, {rec.n_syncs} host syncs"
          + (f", {epochs} epochs" if epochs else ""), flush=True)
    if epochs:
        print(f"  host_syncs_per_epoch.fit {rec.n_syncs / epochs:.1f}")
    if prof is None:
        return
    ops = tr._device_ops(prof)
    summary = tr.summarize(ops, window_s)
    idle = bs.idle_intervals(ops, t0, t1)
    by = bs.split(idle, bs.innermost(rec.spans))
    idle_s = sum(by.values())
    print(f"  device_idle {100.0 * (window_s - summary.busy_s) / window_s:.3f}"
          f" % (summarize), {100.0 * idle_s / window_s:.3f} % (split)")
    for name, prefix in (("device_idle.solver", "solver"),
                         ("device_idle.cascade", "cascade"),
                         ("device_idle.lists", "topn.lists")):
        print(f"  {name} {bs.layer_share(by, window_s, prefix):.3f} %")
    print("  " + bs.note(by, window_s, rec.syncs))
    timeline = bs.innermost(rec.spans)
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:10]
    for a, b in longest:
        name = bs.NONE
        for s, e, n in timeline:
            if s <= a < e:
                name = n
                break
        print(f"  gap {(b - a) * 1e-6:.3f} ms under {name}")


def cost(cell, kind, run, state, turns=("off", "on", "on", "off")):
    """Untraced windows with recording off and on in turns; prints each
    window's end-to-end metric."""
    for turn in turns:
        _reset(cell, state)
        profiling.SPANS = profiling.Recorder() if turn == "on" else None
        try:
            _sync(run.device)
            kind.window(run, state)
            _sync(run.device)
        finally:
            profiling.SPANS = None
        e2e = kind.end_to_end(run)
        kind.release(run, state)
        print(f"{cell.name}: recording {turn}: "
              + ", ".join(f"{k} {v!r}" for k, v in e2e.items()), flush=True)


def clock(reps: int = 20) -> None:
    """The recorder's clock against the profiler's device times: per
    repeat a span, 20 ms of host sleep, a ``time.time_ns()`` stamp, one
    kernel launch, a synchronise and a second stamp.  The offset of the
    device clock over the host's lies between the largest (device end -
    second stamp) and the least (device start - first stamp), since a
    kernel starts after its launch and ends before the synchronise
    returns; prints both bounds, and the device start less the span's
    start + 20 ms, in microseconds."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(1 << 20, device="cuda")
    x.add_(1.0)
    torch.cuda.synchronize()
    rec = profiling.Recorder()
    before, after = [], []
    profiling.SPANS = rec
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                with profiling.span("probe"):
                    time.sleep(0.02)
                    before.append(time.time_ns())
                    x.mul_(1.0)
                torch.cuda.synchronize()
                after.append(time.time_ns())
    finally:
        profiling.SPANS = None
    ops = sorted(tr._device_ops(prof), key=lambda o: o.start_ns)
    if len(ops) != reps:
        print(f"clock: {len(ops)} device operations for {reps} launches")
        return
    low = max(o.start_ns + o.dur_ns - t for o, t in zip(ops, after)) * 1e-3
    high = min(o.start_ns - t for o, t in zip(ops, before)) * 1e-3
    late = sorted((o.start_ns - s.start_ns - 20_000_000) * 1e-3
                  for o, s in zip(ops, rec.spans))
    print(f"clock: device clock - time.time_ns() in [{low:.1f}, {high:.1f}]"
          f" us over {reps} launches; device start - (span start + 20 ms): "
          f"min {late[0]:.1f} median {late[reps // 2]:.1f} us", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", default=None)
    ap.add_argument("--seed", type=int, default=2**31 + 977)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--cost", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    spec = core.load_spec()
    names = ([n for n in args.cells.split(",") if n]
             if args.cells is not None
             else [w["name"] for w in spec["workloads"]])
    device = "cpu" if args.cpu else "cuda"
    if not args.cpu and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if not args.cpu:
        clock()
    for name in names:
        cell = core.find_cell(spec, name)
        if args.cpu:
            cell.config.update(TINY, **({"l2_reg": 1.0, "niter": 2}
                                        if cell.traffic["kind"] == "fit"
                                        else {}))
        kind = core.kind_module(cell)
        run = core.Run(cell, args.seed, args.seconds, False, device)
        t = time.perf_counter()
        state = kind.setup(run)
        _sync(device)
        print(f"{name}: set-up {time.perf_counter() - t:.3f} s", flush=True)
        traced(cell, kind, run, state)
        if args.cost:
            cost(cell, kind, run, state)
        del state
        if not args.cpu:
            torch.cuda.empty_cache()
    if not args.cpu:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
