"""The card's idle time put down to the program's spans.

The program records its spans on the host (``poismf_torch.utils.profiling``
with ``SPANS`` set to a ``Recorder``) on ``time.time_ns()``, the clock
``torch.profiler`` reports the card's operations on.  Spans nest on the
one host thread, so at each instant at most one span is the innermost
open one; :func:`innermost` turns the spans into that timeline, and
:func:`split` divides the idle intervals of a window (:func:`idle_intervals`,
the same intervals whose lengths ``trace.summarize`` reports as gaps)
exactly over it, ``(none)`` where no span is open.

In a traced run on the card the harness keeps the program's recorder on
the run (``run.spans``), with the window's device operations
(``run.ops``) and its ends on that clock (``run.window_ns``):
:func:`window_split` and :func:`share_under` read them for the per-layer
metrics.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

NONE = "(none)"

Interval = Tuple[int, int]  # [start_ns, end_ns)


def idle_intervals(ops, start_ns: int, end_ns: int) -> List[Interval]:
    """The intervals of ``[start_ns, end_ns)`` in which no operation of
    ``ops`` (``trace.DeviceOp``s) ran on the card, in time order."""
    out, cur = [], start_ns
    for op in sorted(ops, key=lambda o: o.start_ns):
        s, e = max(op.start_ns, start_ns), min(op.start_ns + op.dur_ns,
                                               end_ns)
        if s > cur:
            out.append((cur, min(s, end_ns)))
        cur = max(cur, e)
        if cur >= end_ns:
            break
    if cur < end_ns:
        out.append((cur, end_ns))
    return [(a, b) for a, b in out if b > a]


def innermost(spans: Iterable) -> List[Tuple[int, int, str]]:
    """``(start_ns, end_ns, name)`` pieces, in time order and disjoint,
    each naming the innermost span open over it, from spans (objects with
    ``name``, ``start_ns`` and ``end_ns``) that nest; instants in no span
    are left out."""
    out: List[Tuple[int, int, str]] = []
    stack: List[list] = []  # [name, end_ns, cursor_ns]

    def pop_until(t):
        while stack and stack[-1][1] <= t:
            name, end, cur = stack.pop()
            if end > cur:
                out.append((cur, end, name))
            if stack:
                stack[-1][2] = max(stack[-1][2], end)

    order = sorted(enumerate(spans), key=lambda p: (p[1].start_ns, p[0]))
    for _, s in order:
        if s.end_ns is None:
            continue
        pop_until(s.start_ns)
        if stack and s.start_ns > stack[-1][2]:
            out.append((stack[-1][2], s.start_ns, stack[-1][0]))
            stack[-1][2] = s.start_ns
        stack.append([s.name, s.end_ns, s.start_ns])
    pop_until(float("inf"))
    return out


def split(intervals: Sequence[Interval],
          timeline: Sequence[Tuple[int, int, str]]) -> Dict[str, float]:
    """Seconds of ``intervals`` under each name of ``timeline``
    (:func:`innermost`), and under ``(none)`` where no piece covers
    them; the values sum to the intervals' length."""
    out: Dict[str, float] = {}
    j = 0
    for a, b in intervals:
        while j < len(timeline) and timeline[j][1] <= a:
            j += 1
        covered, k = 0, j
        while k < len(timeline) and timeline[k][0] < b:
            s, e, name = timeline[k]
            ov = min(b, e) - max(a, s)
            if ov > 0:
                out[name] = out.get(name, 0.0) + ov * 1e-9
                covered += ov
            k += 1
        if b - a > covered:
            out[NONE] = out.get(NONE, 0.0) + (b - a - covered) * 1e-9
    return out


def name_at(timeline: Sequence[Tuple[int, int, str]], t: int) -> str:
    """The innermost span of ``timeline`` (:func:`innermost`) open at the
    instant ``t``, ``(none)`` where none is."""
    i = bisect.bisect_right(timeline, (t, float("inf"))) - 1
    if i >= 0 and timeline[i][0] <= t < timeline[i][1]:
        return timeline[i][2]
    return NONE


def _under(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


def window_split(run) -> Optional[Dict[str, float]]:
    """The traced window's idle seconds by innermost span (:func:`split`
    of its :func:`idle_intervals`), worked out once a run; None without
    the program's spans or without a trace of the card."""
    if run.spans is None or run.ops is None:
        return None
    if "idle_by_span" not in run.derived:
        a, b = run.window_ns
        run.derived["idle_by_span"] = split(idle_intervals(run.ops, a, b),
                                            innermost(run.spans.spans))
    return run.derived["idle_by_span"]


def share_under(run, prefix: str) -> Optional[float]:
    """The share of the traced window idle under spans named ``prefix``
    or ``prefix.*`` (:func:`layer_share`), in %; None where no such span
    was open in the window, or without spans or a trace of the card."""
    by = window_split(run)
    if by is None:
        return None
    a, b = run.window_ns
    if not any(_under(s.name, prefix) and s.start_ns < b
               and s.end_ns is not None and s.end_ns > a
               for s in run.spans.spans):
        return None
    return layer_share(by, (b - a) * 1e-9, prefix)


def layer_share(by_name: Dict[str, float], window_s: float,
                prefix: str) -> float:
    """The idle seconds under spans named ``prefix`` or ``prefix.*``, as
    a share of the window, in %."""
    s = sum(v for n, v in by_name.items() if _under(n, prefix))
    return 100.0 * s / window_s


def note(by_name: Dict[str, float], window_s: float, syncs: dict) -> str:
    """One line: the window's idle seconds by innermost span (largest
    first, with the share of the idle time in spans), then the host syncs
    by site (count, blocked seconds)."""
    idle = sum(by_name.values())
    in_spans = idle - by_name.get(NONE, 0.0)
    parts = [f"{n} {v:.6f}" for n, v in
             sorted(by_name.items(), key=lambda kv: -kv[1])]
    sync = [f"{site} {c} ({s:.6f} s)" for site, (c, s) in
            sorted(syncs.items(), key=lambda kv: -kv[1][0])]
    return (f"idle by span: {idle:.6f} s of a {window_s:.6f} s window, "
            f"{100.0 * in_spans / idle if idle else 0.0:.2f}% in program "
            f"spans: " + ", ".join(parts) + "; host syncs by site: "
            + ", ".join(sync))
