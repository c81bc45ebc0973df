"""PyTorch port, the direction of its imports: the kernels layer
(``poismf_torch/kernels/``: the wrappers, their plain versions and the
route rule) imports none of the layers that call it, so the package's
imports point one way, models -> train / serve -> solvers -> ops ->
kernels -> csrc.  Read from the sources with ``ast``; nothing is
imported."""

import ast
from pathlib import Path

import pytest

KERNELS = Path(__file__).resolve().parents[1] / "poismf_torch" / "kernels"
ABOVE = {"ops", "solvers", "train", "models", "serve", "parallel", "io"}


def _imported(tree: ast.Module, package: str):
    """The absolute names of the modules each import statement of the
    module in ``package`` names (a ``from X import y`` names X and
    X.y)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            parts = package.split(".")
            parts = parts[:len(parts) - node.level + 1] if node.level else []
            base = ".".join(parts + ([node.module] if node.module else []))
            yield node.lineno, base
            for alias in node.names:
                yield node.lineno, f"{base}.{alias.name}"


def _layer(name: str):
    """The layer of ``poismf_torch`` that the module ``name`` lies in, or
    None for a module outside the package."""
    parts = name.split(".")
    return parts[1] if parts[0] == "poismf_torch" and len(parts) > 1 \
        else None


@pytest.mark.parametrize("path", sorted(KERNELS.glob("*.py")),
                         ids=lambda p: p.name)
def test_kernels_import_no_layer_above_them(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    wrong = sorted({(line, name) for line, name
                    in _imported(tree, "poismf_torch.kernels")
                    if _layer(name) in ABOVE})
    assert not wrong, f"{path.name} imports a layer above the kernels: " \
                      f"{wrong}"


def test_the_walk_sees_each_form_of_import():
    """The forms a module of the kernels package could reach a layer
    above by: relative from the package and from its parent, absolute,
    and a plain import."""
    src = ("from ..ops import ell\n"
           "from .. import solvers\n"
           "from poismf_torch.train import run_poismf\n"
           "import poismf_torch.serve\n"
           "from . import _lib\n"
           "import torch\n")
    layers = {_layer(name) for _, name
              in _imported(ast.parse(src), "poismf_torch.kernels")}
    assert ABOVE & layers == {"ops", "solvers", "train", "serve"}
    assert "kernels" in layers
