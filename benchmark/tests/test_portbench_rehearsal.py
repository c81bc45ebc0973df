"""A rehearsal of every cell on the CPU at a tiny size, through the
harness's own path (the look for a chip skipped): the result line has
the contract's shape and no device metric, the port agrees with the
plain reference under the cell's own limits, and each fault planted
under the timed call makes ``correct`` come out false.  The program's
spans are recorded in traced runs alone, and never outlive the run."""

import io
import json
from contextlib import redirect_stdout

import pytest

from benchmark import core, faults
from poismf_torch.utils import profiling

SPEC = core.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
DEVICE_METRICS = {"launches_per_epoch.fit", "topn.device_ms_per_batch",
                  "hand_kernels_roofline", "fit_mfu", "device_idle.fit",
                  "device_idle.topn", "device_idle.solver.fit",
                  "device_idle.cascade.fit", "host_syncs_per_epoch.fit",
                  "device_idle.lists.topn", "topn_kernel_ms_per_kuser"}
SEED = 2**31 + 4242


def tiny_cell(name):
    return core.shrink(core.find_cell(SPEC, name))


def _run(name, trace=False, fault=None, judge="program"):
    cell = tiny_cell(name)
    return core.execute(cell, SEED, 0.05, trace, "cpu", fault=fault,
                        judge=judge)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_shape(name, trace):
    out = _run(name, bool(trace))
    buf = io.StringIO()
    with redirect_stdout(buf):
        core.emit(out)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["device"]["platform"] == "cpu"
    assert line["attempted"] >= 1 and line["failed"] == 0
    cell = core.find_cell(SPEC, name)
    if trace:
        assert not set(line["metrics"]) & DEVICE_METRICS
        allowed = {m["name"] for m in cell.per_layer}
        assert set(line["metrics"]) <= allowed
    else:
        # an end-to-end metric of the card's trace has no CPU reading
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end
                                        if m["source"] == "host_clock"}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name,fault", [
    (w["name"], f) for w in SPEC["workloads"]
    for f in core.kind_module(core.find_cell(SPEC, w["name"])).FAULTS])
def test_fault_is_not_correct(name, fault):
    kind = core.find_cell(SPEC, name).traffic["kind"]
    out = _run(name, fault=faults.make(kind, fault))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program(name):
    """The reference in the lower precision, in the program's place,
    reads above the program on at least one compared number."""
    prog = _run(name)["checks"]
    ctrl = _run(name, judge="control")["checks"]
    assert any(ctrl[n]["value"] > prog[n]["value"] for n in prog)


@pytest.mark.parametrize("name", [
    w["name"] for w in SPEC["workloads"]
    if core.find_cell(SPEC, w["name"]).traffic["kind"] == "fit"])
def test_every_solve_is_told_its_half(monkeypatch, name):
    """Every reference solve of the fit check, the control's included,
    gets the half it stands for: its side, the judged epoch (the last)
    and the run's configuration."""
    from benchmark.kinds import fit_solvers

    entry = fit_solvers.load(tiny_cell(name).config["method"])
    seen = []

    def solve(how, g, x0, s, l2, maxupd, half, _real=entry.solve):
        seen.append(half)
        return _real(how, g, x0, s, l2, maxupd, half)

    monkeypatch.setattr(entry, "solve", solve)
    calls = {}
    for judge in ("program", "control"):
        seen.clear()
        cell = tiny_cell(name)
        out = core.execute(cell, SEED, 0.05, False, "cpu", judge=judge)
        assert {h.side for h in seen} == {"items", "users"}, out["checks"]
        assert all(h.epoch == cell.config["niter"] - 1
                   and h.config is cell.config for h in seen)
        calls[judge] = len(seen)
    assert calls["control"] > calls["program"]


@pytest.mark.parametrize("trace", [0, 1])
def test_spans_recorded_in_traced_runs_alone(monkeypatch, trace):
    """``profiling.SPANS`` holds one recorder through a traced run's
    set-up and window, none in an untraced run, and none after either."""
    name = "tncg-lastfm.fit"
    kind = core.kind_module(core.find_cell(SPEC, name))
    seen = []
    for fn in ("setup", "window"):
        def spy(*a, _fn=getattr(kind, fn), **kw):
            seen.append(profiling.SPANS)
            return _fn(*a, **kw)
        monkeypatch.setattr(kind, fn, spy)
    out = _run(name, bool(trace))
    assert profiling.SPANS is None
    assert out["correct"], out["checks"]
    if trace:
        assert isinstance(seen[0], profiling.Recorder)
        assert seen == [seen[0]] * 2 and seen[0].spans
    else:
        assert seen == [None, None]


def test_spans_off_after_a_failed_window(monkeypatch):
    kind = core.kind_module(core.find_cell(SPEC, "tncg-lastfm.topn"))

    def window(run, state, fault=None):
        assert profiling.SPANS is not None
        raise RuntimeError("window failed")

    monkeypatch.setattr(kind, "window", window)
    with pytest.raises(RuntimeError, match="window failed"):
        _run("tncg-lastfm.topn", True)
    assert profiling.SPANS is None
