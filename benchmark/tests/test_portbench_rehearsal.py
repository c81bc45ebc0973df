"""A rehearsal of every cell on the CPU at a tiny size, through the
harness's own path (the look for a chip skipped): the result line has
the contract's shape and no device metric, the port agrees with the
plain reference under the cell's own limits, and each fault planted
under the timed call makes ``correct`` come out false."""

import io
import json
from contextlib import redirect_stdout

import pytest

from benchmark import core, faults

SPEC = core.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
DEVICE_METRICS = {"launches_per_epoch.fit", "topn.device_ms_per_batch",
                  "hand_kernels_roofline", "fit_mfu", "device_idle.fit",
                  "device_idle.topn"}
# a tiny problem in the regime of the full one: the data terms outweigh
# the l2 penalty, as they do at 17.2M nonzeros
TINY = {"n_users": 200, "n_items": 80, "nnz": 2000}
TINY_FIT = dict(TINY, l2_reg=1.0, niter=2)
SEED = 2**31 + 4242


def tiny_cell(name):
    cell = core.find_cell(SPEC, name)
    cell.config.update(TINY_FIT if cell.traffic["kind"] == "fit" else TINY)
    return cell


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
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        assert all(m["value"] > 0 for m in line["metrics"].values())
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("name,fault", [
    (w["name"], f) for w in SPEC["workloads"]
    for f in faults.FAULTS[core.find_cell(SPEC, w["name"]).traffic["kind"]]])
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
