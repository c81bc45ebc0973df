"""The traced run's instruments: a ``torch.profiler`` window of the card's
activity alone (no CPU ops, so a fit's hundreds of thousands of launches
stay a few hundred MB and no Chrome trace is written), its reduction to
busy time, launches, time by kernel and idle gaps, and a spy on the
hand-kernel wrappers that records each call's shapes for the kernels'
roofline without a sync inside the window."""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

import torch

from . import peaks
from . import spans as bs

# The hand kernels' entry points in ``poismf_torch/csrc`` (every plane
# sweep is an instance of one template, every ray search of another, and
# a split sweep ends in ``sum_splits_kernel``).
HAND_KERNEL = re.compile(r"\b(plane_sweep_kernel|ray_kernel|"
                         r"sum_splits_kernel)\b")


@dataclasses.dataclass
class DeviceOp:
    name: str
    kind: str  # "kernel", "memcpy" or "memset"
    start_ns: int
    dur_ns: int


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    launches: int
    by_name: Dict[str, Tuple[int, float]]  # name -> (calls, seconds)
    gaps: List[Tuple[str, float]]  # the longest idle gaps, longest first

    @property
    def device_op_s(self) -> float:
        return sum(s for _, s in self.by_name.values())

    def seconds_matching(self, pattern: re.Pattern) -> float:
        return sum(s for n, (_, s) in self.by_name.items()
                   if pattern.search(n))

    def breakdown(self) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return {"device_ops": [[n, s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in self.gaps[:10]]}


def idle_share(run) -> Optional[float]:
    """Share of the traced window in which no operation ran on the card,
    in % (None without a trace): every ``device_idle.<kind>`` metric's
    reader."""
    if run.summary is None:
        return None
    s = run.summary
    return 100.0 * (s.window_s - s.busy_s) / s.window_s


def short_name(name: str, width: int = 120) -> str:
    """A kernel's name without its argument list, at most ``width``."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    head = head.strip()
    return head[:width]


def summarize(ops: List[DeviceOp], window_s: float, n_gaps: int = 10,
              timeline=None) -> TraceSummary:
    """Busy seconds (the union of the ops' intervals), kernel launches,
    calls and seconds by name, and the ``n_gaps`` longest gaps between
    ops, each named by the ops on its two sides and, with ``timeline``
    (``spans.innermost`` of the program's spans), first by the innermost
    span open where it starts."""
    by_name: Dict[str, Tuple[int, float]] = {}
    launches = 0
    for op in ops:
        n = short_name(op.name)
        c, s = by_name.get(n, (0, 0.0))
        by_name[n] = (c + 1, s + op.dur_ns * 1e-9)
        launches += op.kind == "kernel"
    busy_ns, gaps = 0, []
    cur_start = cur_end = None
    cur_last = ""
    for op in sorted(ops, key=lambda o: o.start_ns):
        end = op.start_ns + op.dur_ns
        if cur_end is None:
            cur_start, cur_end, cur_last = op.start_ns, end, op.name
            continue
        if op.start_ns > cur_end:
            busy_ns += cur_end - cur_start
            gaps.append((f"after {short_name(cur_last, 60)} / before "
                         f"{short_name(op.name, 60)}",
                         (op.start_ns - cur_end) * 1e-9, cur_end))
            cur_start, cur_end, cur_last = op.start_ns, end, op.name
        elif end >= cur_end:
            cur_end, cur_last = end, op.name
    if cur_end is not None:
        busy_ns += cur_end - cur_start
    gaps.sort(key=lambda g: -g[1])
    named = [(name if timeline is None
              else f"{bs.name_at(timeline, at)}: {name}", s)
             for name, s, at in gaps[:n_gaps]]
    return TraceSummary(window_s=window_s, busy_s=busy_ns * 1e-9,
                        launches=launches, by_name=by_name, gaps=named)


def _device_ops(prof) -> List[DeviceOp]:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        kind = ("memcpy" if name.startswith("Memcpy") else "memset"
                if name.startswith("Memset") else "kernel")
        out.append(DeviceOp(name, kind, e.start_ns(), e.duration_ns()))
    return out


class DeviceTrace:
    """``with DeviceTrace(spans) as t: ...`` profiles the card's activity
    over the block (synchronised at both ends); ``t.summary`` is then its
    :class:`TraceSummary` (its gaps named by the spans of ``spans``, a
    ``profiling.Recorder``, where given), ``t.ops`` its operations and
    ``t.start_ns``, ``t.end_ns`` its ends on ``time.time_ns()``, the clock
    of the operations and of the program's spans."""

    def __init__(self, spans=None):
        self.spans = spans
        self.summary: Optional[TraceSummary] = None
        self.ops: Optional[List[DeviceOp]] = None
        self.start_ns = self.end_ns = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.end_ns = time.time_ns()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.ops = _device_ops(self._prof)
            timeline = (None if self.spans is None
                        else bs.innermost(self.spans.spans))
            self.summary = summarize(self.ops, window_s, timeline=timeline)
        self._prof = None
        return False


# wrapper in poismf_torch.kernels -> (work name, argument layout)
_PLANE = {"fgh_bucket": "fgh", "fg_bucket": "fg", "f_bucket": "f",
          "f_gtd_bucket": "f_gtd", "f_gtd_fused_bucket": "f_gtd_fused",
          "pg_bucket": "pg", "f_gtd_multi_bucket": "f_gtd_multi"}
_RAY = {"raygtd_multi_bucket": "raygtd", "rayf_multi_bucket": "rayf",
        "ray_bucket": "ray"}


class KernelSpy:
    """Records every hand-kernel wrapper call's shapes while installed:
    (work name, k, P, R, plane itemsize, candidates, vals key).  The
    nonzero slots of each vals plane are counted after the window, from
    the planes it keeps alive until then (compact rounds build theirs in
    the window); an hvp call finds its bucket's vals through the bg plane
    that the sweep before it read."""

    def __init__(self):
        self.calls: List[tuple] = []
        self._vals: Dict[int, torch.Tensor] = {}
        self._bg_vals: Dict[int, int] = {}
        self._saved: Dict[str, object] = {}

    def _key(self, vals: torch.Tensor) -> int:
        key = vals.data_ptr()
        self._vals.setdefault(key, vals)
        return key

    def _plane(self, fn, name):
        def spy(bg, vals, *a, **kw):
            key = self._key(vals)
            self._bg_vals[bg.data_ptr()] = key
            k, P, R = bg.shape
            C = a[2].shape[0] if name == "f_gtd_multi" else 4
            self.calls.append((name, k, P, R, bg.element_size(), C, key))
            return fn(bg, vals, *a, **kw)
        return spy

    def _ray(self, fn, name):
        def spy(px, pd, vals, alphas, *a, **kw):
            P, R = vals.shape
            C = 1 if name == "ray" else alphas.shape[0]
            self.calls.append((name, 0, P, R, 4, C, self._key(vals)))
            return fn(px, pd, vals, alphas, *a, **kw)
        return spy

    def _hvp(self, fn):
        def spy(bg, w2, v_t, want_bv=False, **kw):
            k, P, R = bg.shape
            self.calls.append(("hvp_bv" if want_bv else "hvp", k, P, R,
                               bg.element_size(), 4,
                               self._bg_vals.get(bg.data_ptr())))
            return fn(bg, w2, v_t, want_bv=want_bv, **kw)
        return spy

    def __enter__(self):
        from poismf_torch import kernels

        for attr, name in _PLANE.items():
            self._saved[attr] = getattr(kernels, attr)
            setattr(kernels, attr, self._plane(self._saved[attr], name))
        for attr, name in _RAY.items():
            self._saved[attr] = getattr(kernels, attr)
            setattr(kernels, attr, self._ray(self._saved[attr], name))
        self._saved["hvp_bucket"] = kernels.hvp_bucket
        kernels.hvp_bucket = self._hvp(self._saved["hvp_bucket"])
        return self

    def __exit__(self, *exc):
        from poismf_torch import kernels

        for attr, fn in self._saved.items():
            setattr(kernels, attr, fn)
        return False

    def bound_s(self) -> Optional[float]:
        """The summed least seconds of the recorded calls; None without a
        call, or where an hvp call's bucket was not found."""
        if not self.calls:
            return None
        nnz = {key: int((v > 0).sum()) for key, v in self._vals.items()}
        total = 0.0
        for name, k, P, R, itemsize, C, key in self.calls:
            if key is None:
                return None
            total += peaks.bound_s(*peaks.kernel_work(
                name, k, P, R, itemsize, nnz[key], C))
        return total
