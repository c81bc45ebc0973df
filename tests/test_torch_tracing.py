"""PyTorch port: the program's spans and host-sync counter
(``poismf_torch.utils.profiling``).

On the CPU: recording off records nothing; recording changes no result
(tncg, cg and pg fits on the ELL and the COO, bitwise); the span tree of
a fit (one ``half.items`` and one ``half.users`` an epoch, each with its
``ell.gather``; a ``cascade.round`` per ``train.CASCADE_TRACE`` entry;
every span inside its parent); the counter against the helper calls by
site; ``profiling.trace`` writing the spans and counts into its Chrome
trace; and the spans of ``topN_batched``.

On the card (``-m cuda``; skip without one): the spans' clock against
the profiler's device times, and the counter against every synchronizing
call that ``torch.cuda.set_sync_debug_mode("warn")`` reports.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is
absent::

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""

import collections
import json
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from poismf_torch import PoisMF, train  # noqa: E402
from poismf_torch.utils import profiling  # noqa: E402


def _data(n_u=150, n_i=60, nnz=1100, seed=1):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_u * n_i, nnz))
    vals = rng.poisson(3.0, key.shape[0]) + 1.0
    return key // n_i, key % n_i, vals, (n_u, n_i)


def _fit(device="cpu", **kw):
    """A 2-epoch fit; tncg's at a light l2 from warm starts, which reaches
    the cascade's compact rounds on this data."""
    if kw["method"] == "tncg":
        kw = dict(dict(l2_reg=1e-3, reuse_prev=True), **kw)
    kw = dict(dict(k=6, niter=2, random_state=3), **kw)
    return PoisMF(device=device, **kw).fit(_data())


@pytest.fixture
def recorder():
    rec = profiling.Recorder()
    profiling.SPANS = rec
    try:
        yield rec
    finally:
        profiling.SPANS = None


def test_recording_off_records_nothing(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("recorded with SPANS None")

    monkeypatch.setattr(profiling, "_Open", refuse)
    monkeypatch.setattr(profiling.Recorder, "count", refuse)
    assert profiling.SPANS is None
    m = _fit(method="tncg")
    m.topN_batched([0, 1, 2], n=3, exclude_seen=True)
    assert profiling.span("fit") is profiling.span("topn")


@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_recording_changes_no_result(method, layout):
    kw = dict(method=method, layout=layout, plane_dtype="bfloat16")
    off = _fit(**kw)
    profiling.SPANS = rec = profiling.Recorder()
    try:
        on = _fit(**kw)
    finally:
        profiling.SPANS = None
    assert np.array_equal(off.A, on.A) and np.array_equal(off.B, on.B)
    names = collections.Counter(s.name for s in rec.spans)
    assert names["fit"] == 1 and names["ingest"] == 1
    assert names["half.items"] == names["half.users"] == 2
    assert names["solver." + method] >= 4
    assert all(s.end_ns is not None for s in rec.spans)


def _children(rec, i):
    return [s for s in rec.spans if s.parent == i]


@pytest.mark.parametrize("method", ["tncg", "cg"])
def test_span_tree_of_a_fit(method, recorder, monkeypatch):
    monkeypatch.setattr(train, "CASCADE_TRACE", [])
    _fit(method=method, early_stop=False, plane_dtype="bfloat16")
    spans = recorder.spans
    fits = [i for i, s in enumerate(spans) if s.name == "fit"]
    assert len(fits) == 1
    halves = [(i, s) for i, s in enumerate(spans) if s.name.startswith(
        "half.")]
    assert [s.name for _, s in halves] == ["half.items", "half.users"] * 2
    for i, s in halves:
        assert s.parent == fits[0]
        kids = [c.name for c in _children(recorder, i)]
        assert kids.count("ell.gather") == 1 and kids[0] == "ell.gather"
    assert (sum(s.name == "cascade.round" for s in spans)
            == len(train.CASCADE_TRACE) > 0)
    for i, s in enumerate(spans):
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            assert s.root == i
            continue
        p = spans[s.parent]
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.root == p.root
    solver = "solver.tncg" if method == "tncg" else "solver.cg"
    assert all(spans[s.parent].name == "cascade.round" for s in spans
               if s.name in (solver, "cascade.build"))
    assert all(spans[s.parent].name in ("cascade.round", "half.items",
                                        "half.users")
               for s in spans if s.name == "cascade.host")
    inner = {"tncg": ("solver.tncg.cg", "solver.tncg.ls"),
             "cg": ("solver.cg.ls",)}[method]
    assert all(spans[s.parent].name == solver for s in spans
               if s.name in inner)
    assert {s.name for s in spans} >= set(inner) | {"cascade.host",
                                                    "cascade.build"}


def test_counter_counts_each_helper_call_by_site(recorder, monkeypatch):
    calls = collections.Counter()
    for name in ("host", "to_device"):
        fn = getattr(profiling, name)

        def counted(*a, _fn=fn, **kw):
            calls[a[-1]] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(profiling, name, counted)
    m = _fit(method="tncg", plane_dtype="bfloat16")
    m.topN_batched([0, 5, 7], n=4, exclude_seen=True)
    _fit(method="cg", layout="coo")
    assert {site: c for site, (c, _) in recorder.syncs.items()} == calls
    assert recorder.n_syncs == sum(calls.values())
    assert {"solver.tncg.outer", "solver.tncg.cg", "solver.tncg.ls",
            "solver.tncg.stats", "cascade.mask", "cascade.build",
            "cascade.early_stop", "fit.init", "ell.build", "topn.upload",
            "topn.fetch", "solver.cg.outer", "solver.cg.ls",
            "coo.upload"} <= set(calls)
    assert all(s >= 0.0 for _, s in recorder.syncs.values())


def test_trace_writes_the_spans_and_counts(tmp_path):
    profiling.SPANS = rec = profiling.Recorder()
    try:
        _fit(method="cg")
    finally:
        profiling.SPANS = None
    path = tmp_path / "trace.json"
    with profiling.trace(str(path)):
        _fit(method="cg")
    assert profiling.SPANS is None
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "poismf_span"]
    assert [e["name"] for e in spans] == [s.name for s in rec.spans]
    assert [e["args"]["parent"] for e in spans] == [s.parent
                                                    for s in rec.spans]
    (event,) = [e for e in doc["traceEvents"]
                if e.get("cat") == "poismf_host_syncs"]
    assert {k: v["count"] for k, v in event["args"].items()} == {
        site: c for site, (c, _) in rec.syncs.items()}
    # one timeline: the fit's own operations lie inside its span
    (fit,) = [e for e in spans if e["name"] == "fit"]
    ops = [e for e in doc["traceEvents"] if e.get("ph") == "X"
           and e.get("cat") == "cpu_op" and e["name"] == "aten::where"]
    assert ops and all(fit["ts"] <= e["ts"] <= fit["ts"] + fit["dur"]
                       for e in ops)


@pytest.mark.parametrize("exclude_seen", [True, False])
def test_top_n_batched_spans(exclude_seen, recorder):
    profiling.SPANS = None
    m = _fit(method="cg")
    profiling.SPANS = recorder
    m.topN_batched([0, 3, 9, 11], n=5, exclude_seen=exclude_seen)
    spans = recorder.spans
    assert spans[0].name == "topn" and spans[0].parent is None
    kids = [s.name for s in spans[1:]]
    want = ["topn.rank", "topn.fetch"]
    assert kids == (["topn.lists"] + want if exclude_seen else want)
    assert all(s.parent == 0 and s.root == 0 for s in spans[1:])
    assert recorder.syncs["topn.fetch"][0] == 2
    assert recorder.syncs["topn.upload"][0] == (3 if exclude_seen else 1)


# ----------------------------------------------------------------- card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.cuda.init()


@pytest.mark.cuda
def test_span_clock_matches_the_profilers_device_times(cuda, recorder,
                                                       monkeypatch):
    from benchmark import spans as bs
    from benchmark import trace as tr

    got = {}
    summarize = tr.summarize

    def keep(ops, window_s, *a, **kw):
        got["ops"] = ops
        return summarize(ops, window_s, *a, **kw)

    monkeypatch.setattr(tr, "summarize", keep)
    x = torch.ones(1 << 20, device="cuda")
    x.add_(1.0)  # context and kernel loaded before the window
    torch.cuda.synchronize()
    with tr.DeviceTrace():
        x.add_(1.0)
        torch.cuda.synchronize()
        with profiling.span("probe"):
            time.sleep(0.02)
            x.mul_(2.0)
        torch.cuda.synchronize()
    probe = recorder.spans[0]
    ops = sorted(got["ops"], key=lambda o: o.start_ns)
    assert len(ops) == 2, [o.name for o in ops]
    first, second = ops
    assert second.start_ns >= probe.start_ns + 20_000_000 - 500_000, (
        second.start_ns - probe.start_ns)
    gap = [(first.start_ns + first.dur_ns, second.start_ns)]
    idle = bs.split(gap, bs.innermost(recorder.spans))
    assert idle["probe"] >= 0.0195, idle
    assert idle["probe"] > 10 * idle.get(bs.NONE, 0.0), idle


@pytest.mark.cuda
def test_counter_sees_every_sync_the_card_reports(cuda, recorder):
    X = _data(300, 120, 4000)
    runs = [dict(method="tncg", niter=1), dict(method="cg", niter=3)]
    kw = dict(k=16, random_state=2, plane_dtype="bfloat16")
    PoisMF(device="cuda", **kw, **runs[0]).fit(X)  # builds the kernels
    recorder.spans.clear()
    recorder.syncs.clear()
    torch.cuda.synchronize()
    # switching the mode on warns once itself: outside the record
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for run in runs:
                m = PoisMF(device="cuda", **kw, **run).fit(X)
            m.topN_batched(np.arange(0, 300, 7), n=5, exclude_seen=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen if "synchronizing" in str(w.message)]
    if len(syncs) != recorder.n_syncs:
        where = collections.Counter(f"{w.filename}:{w.lineno}"
                                    for w in syncs)
        counted = sorted((k, c) for k, (c, _) in recorder.syncs.items())
        pytest.fail(f"{len(syncs)} synchronizing calls at "
                    f"{sorted(where.items())}; counted {recorder.n_syncs}: "
                    f"{counted}")
    assert {"solver.tncg.ls", "solver.cg.ls", "cascade.mask", "topn.fetch",
            "fit.init"} <= set(recorder.syncs)
