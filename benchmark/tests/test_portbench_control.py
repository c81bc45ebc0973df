"""The controls on the card, at each cell's own size: the plain
reference in the next precision below the configuration's, put in the
program's place, fails one of the cell's compared numbers, while the
program on the same window passes them all.  One seed and a short window
a cell; the limits' full readings (a dozen seeds and more) are
``benchmark/calibrate.py``'s.

    python -m pytest benchmark/tests/test_portbench_control.py -m cuda
"""

import pytest

from benchmark import core

SPEC = core.load_spec()


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in SPEC["workloads"]])
def test_control_fails_and_program_passes(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size on the card")
    cell = core.find_cell(SPEC, name)
    res = core.readings(cell, 2**31 + 909, 1.0, "cuda")
    lim = cell.limits
    assert all(v <= lim[n] for n, v in res["program"].items()), res
    assert any(v > lim[n] for n, v in res["control"].items()), res
