"""The benchmark's files against its contract: every cell, configuration,
mix, limit and metric found by name, every traffic kind and fit solver
entry with what the harness reads of it, and no module under
``benchmark/`` importing JAX or the JAX package (nor, under
``reference/``, the program)."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import core, kinds
from benchmark.kinds import fit_solvers

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = core.load_spec()


def _modules(folder: Path):
    return sorted(p.stem for p in folder.glob("*.py") if p.stem != "__init__")


KINDS = _modules(BENCH / "kinds")
SOLVERS = _modules(BENCH / "kinds" / "fit_solvers")


def test_top_level_keys_and_paths():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_found_by_name(w):
    cell = core.find_cell(SPEC, w["name"])
    assert w["chips"] == 1 and cell.chips == 1
    assert NAME.match(w["name"]) and len(w["why"]) <= 200
    assert core.kind_module(cell).__name__.endswith(cell.traffic["kind"])
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(core.metric_reader(m["name"]))
    kind = core.kind_module(cell)
    for fn in ("setup", "window", "release", "check", "end_to_end"):
        assert callable(getattr(kind, fn))
    assert all(isinstance(v, (int, float)) and v > 0
               for v in cell.limits.values())


@pytest.mark.parametrize("name", KINDS)
def test_kind_module(name):
    kind = kinds.load(name)
    for fn in ("setup", "window", "release", "check", "end_to_end",
               "fault"):
        assert callable(getattr(kind, fn))
    assert kind.FAULTS and isinstance(kind.TINY, dict)
    for fault in kind.FAULTS:
        assert callable(kind.fault(fault))


@pytest.mark.parametrize("method", SOLVERS)
def test_fit_solver_entry(method):
    from poismf_torch.ops import ell

    entry = fit_solvers.load(method)
    assert callable(getattr(ell, entry.EVALUATED))
    for fn in ("keep", "evaluation", "solve"):
        assert callable(getattr(entry, fn))
    assert NAME.match(entry.EVALUATION)
    assert set(entry.OUTCOME) == {"items", "users"}


@pytest.mark.parametrize("w", [w for w in SPEC["workloads"]
                               if core.find_cell(SPEC, w["name"])
                               .traffic["kind"] == "fit"],
                         ids=lambda w: w["name"])
def test_fit_limits_name_the_entrys_numbers(w):
    cell = core.find_cell(SPEC, w["name"])
    entry = fit_solvers.load(cell.config["method"])
    names = {f"{entry.EVALUATION}.{side}" for side in entry.OUTCOME}
    names |= {f"{label}.{side}" for side, rows in entry.OUTCOME.items()
              for label, _, _ in rows}
    assert set(cell.limits) == names


@pytest.mark.parametrize("load,name", [(kinds.load, "no_such_kind"),
                                       (fit_solvers.load, "no_such_method")])
def test_unknown_name_says_which_file(load, name):
    with pytest.raises(ValueError, match=re.escape(f"{name}.py not found")):
        load(name)


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/configs/")
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for key in c["reduced"]:
        assert key in cfg["published"] and cfg[key] != cfg["published"][key]
        assert not key.endswith(("_dim", "_rank")) and key != "k"
    assert any(w["config"] == c["name"] for w in SPEC["workloads"])


def test_metrics_shape():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
        for w in m["workloads"]:
            assert core._applies(e2e[m["moves"]], w)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    names = set(_imports(path))
    assert not names & {"jax", "jaxlib", "flax", "poismf_tpu"}
    if "reference" in path.relative_to(BENCH).parts:
        assert "poismf_torch" not in names
        assert "benchmark" not in names or path.name == "__init__.py"


def test_forbidden_check_compares_whole_names(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "poismf_tpu_like", object())
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert core.forbidden_modules() == ["jax"]


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_params_pass_initial_step_only_where_stated(c):
    """The program runs the configuration's ``initial_step`` where the
    file states one, and its own default where it does not."""
    from poismf_torch.train import FitParams

    from benchmark.kinds import fit

    cfg = json.loads((ROOT / c["file"]).read_text())
    default = FitParams().initial_step
    assert fit.params(cfg).initial_step == cfg.get("initial_step", default)
    cfg.pop("initial_step", None)
    assert fit.params(cfg).initial_step == default
    cfg["initial_step"] = 3e-6
    assert fit.params(cfg).initial_step == 3e-6
