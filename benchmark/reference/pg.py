"""The published proximal gradient half-update, plainly in float64.

poismf.c's ``pg_iteration`` (poismf.c:139-188; ``calc_grad_pgd``
:126-133) takes, for every target row ``a`` with counts ``x_i`` on the
fixed side's rows ``b_i``, ``maxupd`` steps::

    a <- max(0, (a + step * (d(a) - s)) * divisor),
    d(a) = sum_i (x_i / <a, b_i>) b_i,   s = colsums(fixed) + l1,

and zeroes the rows without nonzeros (:166-169).  ``run_poismf`` sets
the schedule (poismf.c:511, 532): the epoch's step ``h`` is the initial
step halved once an epoch, the divisor ``1 / (1 + 2 l2 h)`` is worked
out once an epoch from the item half's step, and the user half steps at
``h / 2`` with that same divisor.  ``step *= w_mult`` (:151) with
``w_mult`` 1.

Departures from poismf.c, none of which changes the arithmetic of a
step: rows are held in the padded groups of ``rows.py`` and stepped all
at once rather than one at a time under OpenMP; a prediction is floored
at 1e-30 before it divides (poismf.c divides by it as it is), so that a
row whose predictions all vanish gives a finite data term; the whole
computation is in float64, as the notebook's fit was (``use_float``
False).
"""

from __future__ import annotations

import torch

from .rows import LOG_FLOOR, Group, _pred


def schedule(initial_step: float, epoch: int, side: str, l2: float):
    """(step, divisor) of the ``side`` half ("items" or "users") of epoch
    ``epoch`` (from 0) of a fit that starts at ``initial_step``."""
    h = float(initial_step) * 0.5 ** int(epoch)
    divisor = 1.0 / (1.0 + 2.0 * float(l2) * h)
    if side == "items":
        return h, divisor
    if side == "users":
        return 0.5 * h, divisor
    raise ValueError(f"no half {side!r}")


def data_term(g: Group, a: torch.Tensor) -> torch.Tensor:
    """``sum_i (x_i / <a, b_i>) b_i`` of each row at ``a`` [R, k]."""
    a = a.to(torch.float64)
    w = torch.where(g.X > 0, g.X / _pred(g, a).clamp_min(LOG_FLOOR), 0.0)
    return torch.bmm(w.unsqueeze(1), g.Fg).squeeze(1)


def pg_steps(g: Group, x0: torch.Tensor, s: torch.Tensor, step: float,
             divisor: float, maxupd: int) -> torch.Tensor:
    """``maxupd`` proximal gradient steps from ``x0`` [R, k] at ``step``
    with ``divisor``; rows without nonzeros come back zero."""
    a = x0.to(torch.float64)
    for _ in range(int(maxupd)):
        a = ((a + step * (data_term(g, a) - s)) * divisor).clamp_min(0.0)
    return torch.where((g.X > 0).any(1)[:, None], a, 0.0)
