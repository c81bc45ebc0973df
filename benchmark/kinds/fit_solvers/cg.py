"""cg: the first fg call of each half (the entry probe), judged by its
gradient; both halves' outcomes (five iterations a half) against the
published CG run by the reference from the same start (``cg_gap``: the
gap between the two ends' objective sums, as a share of the reference's
decrease)."""

from ...reference import rows as ref
from . import gradient_gap, keep_fg

EVALUATED = "fg_ell"
keep = keep_fg
EVALUATION = "grad_err"
evaluation = gradient_gap
OUTCOME = {"items": [("cg_gap", "cg", "absolute")],
           "users": [("cg_gap", "cg", "absolute")]}


def solve(how, g, x0, s, l2, maxupd, half):
    return ref.cg_iterate(g, x0, s, l2, maxupd)
