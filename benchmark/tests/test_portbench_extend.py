"""The harness takes a fit cell of another solver, a cell of another
traffic kind and a per-layer metric that reads the program's recorder as
new files and new entries alone: a copy of ``benchmark/`` and
``BENCHMARK.json`` gains a pg fit cell with a solver entry of its own
(which judges the user half's outcome on the schedule of the half that
the check names, so the user-half faults fail it) and a cell of a
test-only kind (``predict_test``: ``PoisMF.predict`` over the
counts' pairs) with a per-layer metric over the program's host-sync
counter, and a fresh process runs each through ``core.execute``
on the CPU at the tiny size, sound and with a fault planted under the
timed call.  The copy leaves out any pg entry the harness already has,
so that the test's own is a new file."""

import json
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PG_ENTRY = '''
"""pg (test-only): each half's first pg_grad_ell, judged by the gradient
it gives at the half's start; the user half's outcome against the
published step from the half's start, on the schedule of the half that
the check names (``step_gap``)."""

import torch

from ...reference import pg as ref_pg
from . import gradient_gap

EVALUATED = "pg_grad_ell"
EVALUATION = "grad_err"
OUTCOME = {"items": [], "users": [("step_gap", "pg", "rows")]}


def keep(x, out, pos):
    return dict(x=x.index_select(0, pos), d=out.index_select(0, pos))


def evaluation(groups, sample, got, start, s, l2, fixed_low):
    if got is not None:
        x = got["x"].to(torch.float64)
        got = dict(got, g=s + 2.0 * l2 * x - got["d"].to(torch.float64))
    return gradient_gap(groups, sample, got, start, s, l2, fixed_low)


def solve(how, g, x0, s, l2, maxupd, half):
    step, divisor = ref_pg.schedule(half.config["initial_step"], half.epoch,
                                    half.side, l2)
    return ref_pg.pg_steps(g, x0, s, step, divisor, maxupd)
'''

PREDICT_KIND = '''
"""predict_test (test-only): ``PoisMF.predict`` over every pair of the
counts until the window closes; the last answers against float64
``A B^T`` at the same pairs."""

import time

import numpy as np
import torch

from . import topn

FAULTS = ("altered",)
TINY = {"n_users": 200, "n_items": 80, "nnz": 2000}


def fault(name):
    def wrap(fn):
        def call(users, items):
            out = np.array(fn(users, items), copy=True)
            out[::7] *= 1.5
            return out
        return call
    return wrap


def setup(run):
    host = topn.counts(run)
    model, A, B = topn.serving_model(run, host)
    model.predict(host[0][:8], host[1][:8])
    return dict(host=host, model=model, A=A, B=B)


def window(run, st, fault=None):
    model = st["model"]
    call = model.predict if fault is None else fault(model.predict)
    calls, t0 = 0, time.perf_counter()
    while True:
        got = call(st["host"][0], st["host"][1])
        calls += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window.update(window_s=time.perf_counter() - t0, attempted=calls,
                      failed=0, pairs=calls * got.shape[0], got=got)


def release(run, st):
    return dict(host=st["host"], A=st["A"], B=st["B"],
                got=run.window.pop("got"))


def check(run, j, judge="program"):
    rows, cols = (torch.from_numpy(a.astype(np.int64)) for a in j["host"][:2])
    A, B = j["A"].double()[rows], j["B"].double()[cols]
    want = (A * B).sum(1)
    if judge == "program":
        got = torch.from_numpy(np.asarray(j["got"], dtype=np.float64))
    else:
        low = torch.bfloat16
        got = (A.to(low).double() * B.to(low).double()).sum(1)
    err = float((got - want).abs().max() / want.abs().max())
    return [("pred_err", err, float(run.cell.limits["pred_err"]))]


def end_to_end(run):
    return {"predict_test_pairs_per_s":
            run.window["pairs"] / run.window["window_s"]}
'''

SYNC_METRIC = '''
"""predict_test.syncs (test-only): the program's host syncs in a traced
window over its calls."""


def read(run):
    if run.syncs is None:
        return None
    return sum(n for n, _ in run.syncs.values()) / run.window["attempted"]
'''

DRIVE = '''
import json
import sys

sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])  # the program
from benchmark import core, faults

assert core.ROOT == core.Path(sys.argv[1]).resolve(), core.ROOT
spec = core.load_spec()
out = {}
for name, trace, fault in (("pg-test.fit", 0, None),
                           ("pg-test.fit", 0, "unchanged"),
                           ("pg-test.fit", 0, "unchanged.users"),
                           ("pg-test.fit", 0, "half.users"),
                           ("tncg-lastfm.predict_test", 0, None),
                           ("tncg-lastfm.predict_test", 1, None),
                           ("tncg-lastfm.predict_test", 0, "altered")):
    cell = core.shrink(core.find_cell(spec, name))
    wrap = fault and faults.make(cell.traffic["kind"], fault)
    res = core.execute(cell, 2**31 + 606, 0.05, bool(trace), "cpu",
                       fault=wrap)
    out[f"{name}/{trace}/{fault}"] = dict(
        correct=res["correct"], checks=res["checks"],
        metrics={k: m["value"] for k, m in res["metrics"].items()},
        niter=cell.config["niter"] if "niter" in cell.config else None)
print(json.dumps(out))
'''


def _copy(tmp: Path) -> Path:
    """The harness and ``BENCHMARK.json`` copied to ``tmp``, with the new
    cells' files and entries added."""
    bench = tmp / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "kinds" / "fit_solvers" / "pg.py").unlink(missing_ok=True)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/tncg-lastfm.json").read_text())
    cfg.update(name="pg-test", method="pg", l2_reg=1e9, maxupd=1, niter=10,
               initial_step=1e-7, reuse_prev=False,
               tiny={"niter": 3, "initial_step": 1e-3})
    new = {
        "configs/pg-test.json": json.dumps(cfg),
        "kinds/fit_solvers/pg.py": PG_ENTRY,
        "limits/pg-test.fit.json": json.dumps(
            {"grad_err.items": 0.05, "grad_err.users": 0.05,
             "step_gap.users": 0.05}),
        "kinds/predict_test.py": PREDICT_KIND,
        "traffic/predict_test.json": json.dumps(
            {"kind": "predict_test", "sample_seed": 1}),
        "limits/tncg-lastfm.predict_test.json": json.dumps(
            {"pred_err": 1e-4}),
        "metrics/predict_test.syncs.py": SYNC_METRIC,
    }
    for rel, text in new.items():
        path = bench / rel
        assert not path.exists(), rel
        path.write_text(textwrap.dedent(text))
    spec["configs"].append(dict(
        name="pg-test", source="https://github.com/david-cortes/poismf",
        file="benchmark/configs/pg-test.json", reduced=[], why="test"))
    spec["workloads"] += [
        dict(name="pg-test.fit", config="pg-test", traffic="fit", chips=1,
             why="test"),
        dict(name="tncg-lastfm.predict_test", config="tncg-lastfm",
             traffic="predict_test", chips=1, why="test")]
    for m in spec["end_to_end"]:
        if m["name"] == "fit_epoch_s":
            m["workloads"].append("pg-test.fit")
    spec["end_to_end"].append(dict(
        name="predict_test_pairs_per_s", unit="pairs/s", better="higher",
        bound=0.25, source="host_clock",
        workloads=["tncg-lastfm.predict_test"]))
    spec["per_layer"].append(dict(
        name="predict_test.syncs", unit="syncs", better="lower",
        source="program_span", layer="serve", moves="predict_test_pairs_per_s",
        workloads=["tncg-lastfm.predict_test"]))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return tmp


def test_new_solver_and_kind_as_new_files(tmp_path):
    root = _copy(tmp_path)
    (tmp_path / "drive.py").write_text(DRIVE)
    proc = subprocess.run(
        [sys.executable, str(tmp_path / "drive.py"), str(root), str(ROOT)],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    pg, pg_bad = got["pg-test.fit/0/None"], got["pg-test.fit/0/unchanged"]
    assert pg["correct"], pg
    assert set(pg["checks"]) == {"grad_err.items", "grad_err.users",
                                 "step_gap.users"}
    assert set(pg["metrics"]) == {"fit_epoch_s", "setup_s"}
    assert pg["niter"] == 3  # the configuration's own tiny block
    assert not pg_bad["correct"], pg_bad
    # the user-half faults touch only the returned user rows: the outcome
    # judged on the half's own schedule is what sees them
    for fault in ("unchanged.users", "half.users"):
        bad = got[f"pg-test.fit/0/{fault}"]
        assert not bad["correct"], (fault, bad)
        step = bad["checks"]["step_gap.users"]
        assert step["value"] > step["limit"], (fault, bad)
    sound = got["tncg-lastfm.predict_test/0/None"]
    traced = got["tncg-lastfm.predict_test/1/None"]
    bad = got["tncg-lastfm.predict_test/0/altered"]
    assert sound["correct"] and traced["correct"], (sound, traced)
    assert set(sound["metrics"]) == {"predict_test_pairs_per_s", "setup_s"}
    # predict uploads users and items and fetches the answers: 3 a call
    assert traced["metrics"]["predict_test.syncs"] == 3
    assert not bad["correct"], bad
