"""pg: the first pg_grad_ell of each half, judged by its data term
``sum_i (x_i / pred_i) b_i`` (``data_err``: the widest gap between the
kept data term and the reference's at the same point, as a share of the
larger of that row's reference norm and the median row's; at pg's l2 of
1e9 the ``2 l2 a`` of the gradient swamps the data term, so a gradient
gap would compare nothing); both halves' outcomes (``maxupd`` proximal
steps a half) against the published step run by the reference from the
same start, on the schedule the half stands for (``pg_gap``: the widest
distance between a row's two ends, as a share of the larger of that
row's move in the reference and the median row's; row by row, since at
the published fit the gap of the objective sums reads lower on the fp8
control than on the program, PERF.md §2)."""

import numpy as np
import torch

from ...reference import pg as ref_pg
from ...reference import rows as ref

EVALUATED = "pg_grad_ell"
EVALUATION = "data_err"
OUTCOME = {"items": [("pg_gap", "pg", "rows")],
           "users": [("pg_gap", "pg", "rows")]}


def keep(x, out, pos):
    """The point and the data term at the rows ``pos``."""
    return dict(x=x.index_select(0, pos), d=out.index_select(0, pos))


def evaluation(groups, sample, got, start, s, l2, fixed_low):
    """``data_err``; with ``fixed_low`` the reference in that precision is
    judged in the program's place.  Infinite where no evaluation was kept
    or it was not at the half's start."""
    if got is None:
        return float("inf")
    gaps, norms = [], []
    for g in groups:
        at = torch.searchsorted(sample, g.rows)
        if not torch.equal(got["x"][at], start[g.rows]):
            return float("inf")
        x = got["x"][at].to(torch.float64)
        d_ref = ref_pg.data_term(g, x)
        if fixed_low is None:
            d_got = got["d"][at].to(torch.float64)
        else:
            d_got = ref_pg.data_term(ref.regather(g, fixed_low), x)
        gaps.append((d_got - d_ref).norm(dim=1))
        norms.append(d_ref.norm(dim=1))
    gap, norm = torch.cat(gaps), torch.cat(norms)
    worst = float((gap / norm.clamp_min(float(norm.median()))).max())
    return worst if np.isfinite(worst) else float("inf")


def solve(how, g, x0, s, l2, maxupd, half):
    """The published steps of the half ``half`` from ``x0``: its step and
    divisor worked out again from the configuration's ``initial_step``
    and the judged epoch."""
    if "initial_step" not in half.config:
        raise KeyError("a pg configuration states its initial_step: the "
                       "reference works the judged step out from it")
    step, divisor = ref_pg.schedule(half.config["initial_step"], half.epoch,
                                    half.side, l2)
    return ref_pg.pg_steps(g, x0, s, step, divisor, maxupd)
