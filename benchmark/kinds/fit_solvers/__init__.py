"""The fit check's solver entries: each is a file
``fit_solvers/<method>.py``, found by the configuration's ``method``
(:func:`load`), that says what the check (``kinds/fit.py``) keeps of each
half's first objective evaluation and how it judges that and the half's
outcome:

* ``EVALUATED``: the ``poismf_torch.ops.ell`` function whose first call
  after each half's plane gather is kept;
* ``keep(x, out, pos)``: what is kept of that call, as a dict of tensors
  (``x`` its point, ``out`` its output, ``pos`` the sampled rows'
  positions in ELL order), by ``index_select`` on the card (no sync);
* ``EVALUATION``: the name of the number that judges what was kept, and
  ``evaluation(groups, sample, got, start, s, l2, fixed_low)`` its value
  (``got`` what was kept, None where nothing was);
* ``OUTCOME``: per side (``items``, ``users``), the numbers that judge the
  half's outcome, each ``(label, how, compare)``: the reference's solve
  from the half's start and how the two ends are compared
  (``kinds/fit._outcome_gap``); ``solve(how, g, x0, s, l2, maxupd, half)``
  runs the solve ``how`` names for the half ``half``
  (``kinds/fit.Half``: its side, the judged epoch and the run's
  configuration, from which a solver with a schedule works out its
  step; the others ignore it).

The comparisons that the gradient solvers share are here.
"""

import importlib
from pathlib import Path

import numpy as np
import torch

from ...reference import rows as ref

HERE = Path(__file__).resolve().parent


def load(method: str):
    """The solver entry of the fit method ``method``."""
    path = HERE / f"{method}.py"
    if not path.is_file():
        raise ValueError(f"no fit solver entry for method {method!r}: "
                         f"{path} not found")
    return importlib.import_module(f"{__name__}.{method}")


def keep_fg(x, out, pos):
    """The point, ``f`` and the gradient of an evaluation that returns
    ``(f, g, ...)``, at the rows ``pos``."""
    return dict(x=x.index_select(0, pos), f=out[0].index_select(0, pos),
                g=out[1].index_select(0, pos))


def gradient_gap(groups, sample, got, start, s, l2, fixed_low):
    """The widest gap between the kept gradient and the reference's at
    the same point, over the sampled rows, as a share of ``|s|``; with
    ``fixed_low`` the reference in that precision is judged in the
    program's place.  Infinite where no evaluation was kept or it was not
    at the half's start."""
    if got is None:
        return float("inf")
    worst = 0.0
    for g in groups:
        at = torch.searchsorted(sample, g.rows)
        x = got["x"][at].to(torch.float64)
        if not torch.equal(got["x"][at], start[g.rows]):
            return float("inf")
        g_ref = ref.gradient(g, x, s, l2)
        if fixed_low is None:
            g_got = got["g"][at].to(torch.float64)
        else:
            g_got = ref.gradient(ref.regather(g, fixed_low), x, s, l2)
        gap = float(((g_got - g_ref).norm(dim=1) / s.norm()).max())
        worst = max(worst, gap if np.isfinite(gap) else float("inf"))
    return worst
