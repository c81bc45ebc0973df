"""tncg: the first fgh sweep of each half, judged by its gradient; the item
half's outcome against each row's exact minimiser (``excess``: the share
of the reachable decrease left unreached), the user half's against the
published truncated Newton run by the reference from the same start,
since light users stall under the published rules short of the minimiser
(``tnc_gap``: the decrease the program falls short of the reference by,
summed over the rows where it falls short, as a share of the reference's
decrease; the program's multi-candidate search may end lower, which is
no fault)."""

from ...reference import rows as ref
from . import gradient_gap, keep_fg

EVALUATED = "fgh_ell"
keep = keep_fg
EVALUATION = "grad_err"
evaluation = gradient_gap
OUTCOME = {"items": [("excess", "exact", "signed")],
           "users": [("tnc_gap", "tnc", "shortfall")]}


def solve(how, g, x0, s, l2, maxupd, half):
    if how == "exact":
        return ref.solve_exact(g, x0, s, l2)
    return ref.tnc_iterate(g, x0, s, l2, maxupd)
