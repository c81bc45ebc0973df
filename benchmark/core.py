"""The harness: finds a cell's configuration, traffic mix, limits and
metric readers by name, runs set-up, the measured window and the check
against the plain reference, and prints the result line.

Everything that belongs to one configuration, mix, cell or per-layer
metric is a file of its own under ``benchmark/``:

* ``configs/<config>.json``: the fit's hyperparameters and the data's
  scale and laws (``BENCHMARK.json`` names the file);
* ``traffic/<mix>.json``: the mix's parameters and its ``kind``, the
  general driver in ``kinds/<kind>.py`` that reads them (a fit mix's
  check finds the method's solver entry in
  ``kinds/fit_solvers/<method>.py``);
* ``limits/<cell>.json``: each compared number's limit;
* ``metrics/<metric>.py``: a ``read(run)`` that returns the per-layer
  metric from the traced run, or None where it finds nothing to read;
  an end-to-end metric whose ``source`` is ``device_trace`` has one too,
  which reads the trace that every run of its cells on the card takes.

A traced run (``--trace 1``) records the program's spans and host syncs
(``poismf_torch.utils.profiling.SPANS`` holds a fresh ``Recorder`` from
before set-up to the window's end, and None again after it, whatever
happens); an untraced run, which gives the end-to-end metrics, records
nothing, and profiles the card's activity alone where a cell's
end-to-end metric is read from the device trace.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from . import kinds

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "poismf_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(spec: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``spec`` with its files read."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if _applies(m, name) and m["moves"] in reported]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_read_json(root / cfg["file"]),
        traffic=_read_json(root / "benchmark" / "traffic"
                           / f"{w['traffic']}.json"),
        limits=_read_json(root / "benchmark" / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=layer,
    )


def kind_module(cell: Cell):
    return kinds.load(cell.traffic["kind"])


def shrink(cell: Cell) -> Cell:
    """``cell`` at a rehearsal's tiny size on the CPU: its kind's ``TINY``
    keys over its configuration, then the configuration's own ``tiny``
    block, where it has one."""
    cell.config.update(kind_module(cell).TINY)
    cell.config.update(cell.config.get("tiny", {}))
    return cell


def metric_reader(name: str, root: Path = ROOT):
    """``read`` of ``metrics/<name>.py``."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What one run knows; the metric readers read it."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    setup: dict = dataclasses.field(default_factory=dict)
    window: dict = dataclasses.field(default_factory=dict)
    shape: dict = dataclasses.field(default_factory=dict)
    summary: object = None  # trace.TraceSummary in a traced run on the card
    spy: object = None  # trace.KernelSpy in a traced run on the card
    ops: object = None  # the trace's trace.DeviceOp list, there
    window_ns: object = None  # the trace's (start, end) on time.time_ns()
    spans: object = None  # profiling.Recorder in a traced run
    syncs: object = None  # its host syncs in the window: site -> [n, s]
    derived: dict = dataclasses.field(default_factory=dict)  # readers' own
    notes: List[str] = dataclasses.field(default_factory=list)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def note(self, msg: str) -> None:
        """A line for standard error (printed before the checks)."""
        self.notes.append(msg)


def _sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def _window(kind, run, state, fault) -> None:
    """``kind.window``; in a traced run, the recorder's host syncs in it
    kept on ``run.syncs``."""
    rec = run.spans
    before = {} if rec is None else {k: tuple(c) for k, c in rec.syncs.items()}
    kind.window(run, state, fault)
    if rec is not None:
        run.syncs = {}
        for site, (n, s) in rec.syncs.items():
            n0, s0 = before.get(site, (0, 0.0))
            if n > n0:
                run.syncs[site] = [n - n0, s - s0]


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: Optional[float] = None,
            fault=None, judge: str = "program") -> dict:
    """Set-up, window and check of one run; returns the result dict
    (before the forbidden-module look, which the caller makes).
    ``fault`` (tests only) wraps the timed call; ``judge`` "control"
    judges the reference in lower precision in the program's place."""
    import torch

    from poismf_torch.utils import profiling

    from . import spans as bs
    from . import trace as tr

    t_start = time.perf_counter() if t_start is None else t_start
    kind = kind_module(cell)
    run = Run(cell, int(seed), float(seconds), bool(trace), device)
    on_card = device.startswith("cuda")
    device_e2e = [m for m in cell.end_to_end
                  if m["source"] == "device_trace"]
    if trace:
        run.spans = profiling.Recorder()
        profiling.SPANS = run.spans
    try:
        state = kind.setup(run)
        _sync(device)
        run.setup["setup_s"] = time.perf_counter() - t_start
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        if trace and on_card:
            with tr.KernelSpy() as spy, tr.DeviceTrace(run.spans) as dt:
                _window(kind, run, state, fault)
            run.summary, run.spy, run.ops = dt.summary, spy, dt.ops
            run.window_ns = (dt.start_ns, dt.end_ns)
        elif device_e2e and on_card:
            with tr.DeviceTrace() as dt:
                _window(kind, run, state, fault)
            run.summary, run.ops = dt.summary, dt.ops
            run.window_ns = (dt.start_ns, dt.end_ns)
        else:
            _window(kind, run, state, fault)
    finally:
        profiling.SPANS = None
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    judged = kind.release(run, state)
    del state
    if on_card:
        torch.cuda.empty_cache()
    checks = kind.check(run, judged, judge)
    correct = all(v <= lim for _, v, lim in checks)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        by_span = bs.window_split(run)
        if by_span is not None:
            a, b = run.window_ns
            run.note(bs.note(by_span, (b - a) * 1e-9, run.syncs))
    else:
        e2e = kind.end_to_end(run)
        e2e["setup_s"] = run.setup["setup_s"]
        for m in device_e2e:
            e2e[m["name"]] = metric_reader(m["name"])(run)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end if e2e[m["name"]] is not None}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name() if on_card
                    else "cpu"),
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": run.window["attempted"],
           "failed": run.window["failed"], "metrics": metrics,
           "device": dev}
    if trace and run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
        out["breakdown"] = run.summary.breakdown()
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    out["_notes"] = run.notes
    return out


def readings(cell: Cell, seed: int, seconds: float, device: str = "cuda",
             fault=None, planted=()) -> dict:
    """The compared numbers of one run, judged on the program's answers
    and on the control's (the reference in the lower precision, in the
    program's place) from the same window, and on the answers with each
    fault of ``planted`` planted on them (the kind's ``planted``); a run
    with ``fault`` planted under its timed call is judged as the program
    only.  For the readings that set a limit (``benchmark/calibrate.py``)."""
    import torch

    kind = kind_module(cell)
    run = Run(cell, int(seed), float(seconds), False, device)
    t = time.perf_counter()
    state = kind.setup(run)
    out = {"setup_s": time.perf_counter() - t}
    kind.window(run, state, fault)
    out["window"] = {k: v for k, v in run.window.items()
                     if isinstance(v, (int, float))}
    judged = kind.release(run, state)
    del state
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    for judge in (("program",) if fault else ("program", "control")):
        t = time.perf_counter()
        out[judge] = {n: v for n, v, _ in kind.check(run, judged, judge)}
        out[judge + "_check_s"] = time.perf_counter() - t
    for name in planted:
        out["fault:" + name] = {n: v for n, v, _ in kind.check(
            run, kind.planted(judged, name), "program")}
    out["notes"] = run.notes
    return out


def forbidden_modules() -> List[str]:
    """The top-level names of ``sys.modules`` that the run may not hold."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def emit(out: dict) -> None:
    """The notes and each compared number beside its limit on standard
    error (last), then the result line on standard output (last)."""
    for line in out.pop("_notes", []):
        print(line, file=sys.stderr)
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse(argv)
    cell = find_cell(load_spec(), args.workload)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = execute(cell, args.seed, args.seconds, bool(args.trace),
                  "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded in the run: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    emit(out)
    return 0
