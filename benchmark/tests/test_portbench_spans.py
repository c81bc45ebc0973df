"""``benchmark/spans.py``: the idle intervals agree with
``trace.summarize``'s gaps, and their split over the innermost span
timeline is exact, nanosecond for nanosecond, on synthetic device
operations and nested spans (gaps with no span open, gaps across span
edges, spans that start or end with their parent)."""

import collections
import random

import pytest

from benchmark import spans as bs
from benchmark import trace as tr

S = collections.namedtuple("S", "name start_ns end_ns")


def _nested(rng, a, b, depth, out, tag):
    """Spans inside [a, b) in opening order (a parent before its
    children), some sharing an edge with their parent."""
    t = a
    while t < b and depth < 4:
        s = t if rng.random() < 0.3 else rng.randint(t, b)
        e = b if rng.random() < 0.2 else rng.randint(s, b)
        if e <= s:
            break
        out.append(S(f"{tag}{depth}.{len(out)}", s, e))
        if rng.random() < 0.7:
            _nested(rng, s, e, depth + 1, out, tag)
        t = e if rng.random() < 0.5 else rng.randint(e, b)
    return out


def _ops(rng, n, lo, hi):
    out = []
    for i in range(n):
        s = rng.randint(lo, hi)
        out.append(tr.DeviceOp(f"k{i}", "kernel", s, rng.randint(0, 40)))
    return out


def _by_ns(ops, spans, lo, hi):
    """Each idle nanosecond of [lo, hi) under its innermost span."""
    busy = set()
    for op in ops:
        busy.update(range(op.start_ns, op.start_ns + op.dur_ns))
    out = collections.Counter()
    for t in range(lo, hi):
        if t in busy:
            continue
        open_ = [(s.start_ns, i, s.name) for i, s in enumerate(spans)
                 if s.start_ns <= t < s.end_ns]
        out[max(open_)[2] if open_ else bs.NONE] += 1
    return out


@pytest.mark.parametrize("seed", range(40))
def test_split_is_exact(seed):
    rng = random.Random(seed)
    spans = _nested(rng, 50, 900, 0, [], "a")
    spans += _nested(rng, 950, 1500, 0, [], "b")
    ops = _ops(rng, rng.randint(0, 30), 0, 1600)
    lo, hi = 20, 1550
    idle = bs.idle_intervals(ops, lo, hi)
    got = bs.split(idle, bs.innermost(spans))
    want = _by_ns(ops, spans, lo, hi)
    assert {n: round(v * 1e9) for n, v in got.items()} == dict(want)
    assert sum(b - a for a, b in idle) == sum(want.values())


@pytest.mark.parametrize("seed", range(10))
def test_idle_intervals_are_summarize_gaps(seed):
    rng = random.Random(100 + seed)
    ops = _ops(rng, 60, 0, 5000)
    lo = min(o.start_ns for o in ops)
    hi = max(o.start_ns + o.dur_ns for o in ops)
    s = tr.summarize(ops, 1.0, n_gaps=10_000)
    idle = bs.idle_intervals(ops, lo, hi)
    lens = sorted(((b - a) * 1e-9 for a, b in idle), reverse=True)
    assert lens == pytest.approx([g for _, g in s.gaps], abs=1e-15)
    assert sum(lens) == pytest.approx((hi - lo) * 1e-9 - s.busy_s,
                                      abs=1e-12)


def test_layer_share_and_note():
    by = {"solver.tncg": 0.2, "solver.tncg.ls": 0.1, "cascade.host": 0.3,
          bs.NONE: 0.4, "solverx": 5.0}
    assert bs.layer_share(by, 10.0, "solver") == pytest.approx(3.0)
    assert bs.layer_share(by, 10.0, "cascade") == pytest.approx(3.0)
    line = bs.note(by, 10.0, {"solver.tncg.ls": [7, 0.5]})
    assert "93.33% in program spans" in line
    assert "solver.tncg.ls 7 (0.500000 s)" in line
