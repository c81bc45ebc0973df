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


NAMES = ("fit", "half.users", "solver.tncg", "solver.tncg.ls", "solver.cg",
         "cascade.round", "cascade.host", "topn", "topn.lists", "ell.gather")
SHARES = {"device_idle.solver.fit": "solver",
          "device_idle.cascade.fit": "cascade",
          "device_idle.lists.topn": "topn.lists"}


def _traced_run(seed):
    """A traced run on the card as the harness leaves it, with random
    nested spans of the program's names (some before the window) and
    random device operations."""
    from benchmark import core
    from poismf_torch.utils import profiling

    rng = random.Random(seed)
    rec = profiling.Recorder()
    for s in _nested(rng, 0, 2000, 0, [], "x"):
        span = profiling.Span(rng.choice(NAMES), s.start_ns, None, 0)
        span.end_ns = s.end_ns
        rec.spans.append(span)
    cell = core.find_cell(core.load_spec(), "tncg-lastfm.fit")
    run = core.Run(cell, seed, 1.0, True, "cuda")
    run.spans, run.ops = rec, _ops(rng, rng.randint(0, 40), 0, 2100)
    run.window_ns = (rng.randint(50, 300), rng.randint(1700, 2050))
    return run


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("metric", sorted(SHARES))
def test_span_metric_is_its_share_of_the_split(metric, seed):
    from benchmark import core

    run = _traced_run(seed)
    lo, hi = run.window_ns
    got = core.metric_reader(metric)(run)
    prefix = SHARES[metric]
    under = [s for s in run.spans.spans
             if s.name == prefix or s.name.startswith(prefix + ".")]
    if not any(s.start_ns < hi and s.end_ns > lo for s in under):
        assert got is None
        return
    by_ns = _by_ns(run.ops, run.spans.spans, lo, hi)
    want = sum(n for name, n in by_ns.items()
               if name == prefix or name.startswith(prefix + "."))
    assert got == pytest.approx(100.0 * want / (hi - lo), abs=1e-9)
    by = bs.split(bs.idle_intervals(run.ops, lo, hi),
                  bs.innermost(run.spans.spans))
    assert got == pytest.approx(bs.layer_share(by, (hi - lo) * 1e-9, prefix))


def test_span_metrics_need_spans_and_a_trace_of_the_card():
    from benchmark import core

    for metric in SHARES:
        read = core.metric_reader(metric)
        run = _traced_run(1)
        run.spans = None
        assert read(run) is None
        run = _traced_run(1)
        run.ops = None
        assert read(run) is None


def test_host_syncs_per_epoch():
    from benchmark import core

    read = core.metric_reader("host_syncs_per_epoch.fit")
    run = _traced_run(2)
    run.syncs = {"solver.tncg.ls": [700, 1.5], "cascade.mask": [13, 0.1]}
    run.window["epochs"] = 4
    assert read(run) == pytest.approx(713 / 4)
    run.device = "cpu"
    assert read(run) is None


def test_gaps_named_by_the_innermost_span():
    spans = [S("solver.tncg", 0, 100), S("solver.tncg.ls", 40, 60)]
    ops = [tr.DeviceOp("k0", "kernel", 0, 10),
           tr.DeviceOp("k1", "kernel", 45, 5),
           tr.DeviceOp("k2", "kernel", 90, 30),
           tr.DeviceOp("k3", "kernel", 150, 1)]
    s = tr.summarize(ops, 1.0, timeline=bs.innermost(spans))
    assert s.gaps == [("solver.tncg.ls: after k1 / before k2", 40 * 1e-9),
                      ("solver.tncg: after k0 / before k1", 35 * 1e-9),
                      ("(none): after k2 / before k3", 30 * 1e-9)]
    assert bs.name_at(bs.innermost(spans), 50) == "solver.tncg.ls"


def test_kernel_time_per_kuser_and_the_rate():
    """The top-N cell's end-to-end time is the trace's kernel time (copies
    left out) per 1,000 users; the rate per layer is users over the
    window's wall.  Neither reads without its source."""
    from benchmark import core

    card = core.metric_reader("topn_kernel_ms_per_kuser")
    rate = core.metric_reader("topn.users_per_s")
    cell = core.find_cell(core.load_spec(), "tncg-lastfm.topn")
    run = core.Run(cell, 1, 1.0, False, "cuda")
    assert card(run) is None and rate(run) is None
    run.ops = [tr.DeviceOp("gemm", "kernel", 0, 3_000_000),
               tr.DeviceOp("Memcpy HtoD", "memcpy", 1_000_000, 4_000_000),
               tr.DeviceOp("topk", "kernel", 9_000_000, 1_000_000)]
    run.window.update(users=2048, window_s=0.5)
    assert card(run) == pytest.approx(4.0 / 2.048)
    assert rate(run) == pytest.approx(4096.0)
