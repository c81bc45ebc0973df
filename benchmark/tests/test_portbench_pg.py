"""The plain pg reference (``reference/pg.py``) against the port at a small
size on the CPU, seeded: a pg fit through ``train.run_poismf`` on the
planar ELL in float32, whose last epoch's halves, from the state the
driver's callback hands over after the epoch before, land where the
reference's published steps from the same start land, on the schedule
that the reference works out again from the initial step and the epoch;
and ``pg_grad_ell``'s data term against the reference's at the same
point.  With one step a half, as the notebook's fit takes, and with
three, as the Python default of ten does more of."""

import pytest
import torch

from benchmark import data
from benchmark.reference import pg as ref_pg
from benchmark.reference import rows as ref

N_USERS, N_ITEMS, NNZ, K = 300, 140, 6000, 10
LAWS = {"activity_sigma": 1.2, "popularity_zipf": 0.9, "oversample": 1.25,
        "count_mean": 8.0}
# one step moves a row by 1-5% of its norm here, far above float32's rounding
L2, STEP, NITER = 1.0, 1e-3, 3
# float32 arithmetic on float32 planes against float64: a row's gap is
# 3e-6 to 8e-6 of the larger of its move and the median move here; 1e-4
# leaves room, and a step taken at the epoch before's step size reads 0.5
TOL = 1e-4


@pytest.fixture(scope="module")
def problem():
    from poismf_torch import sparse

    rows, cols, vals = data.synth_counts(11, N_USERS, N_ITEMS, NNZ, LAWS,
                                         "cpu")
    ing = sparse.ingest((rows.int().numpy(), cols.int().numpy(),
                         vals.numpy(), (N_USERS, N_ITEMS)), reindex=False)
    A0 = data.init_factors(12, "init.A", N_USERS, ing.by_user.n_rows_pad, K,
                           "cpu")
    B0 = data.init_factors(12, "init.B", N_ITEMS, ing.by_item.n_rows_pad, K,
                           "cpu")
    return rows, cols, vals, ing, A0, B0


def _row_gap(groups, start, judged, ends):
    """The widest distance between a row's two ends over the larger of its
    move in the reference and the median row's (the cell's ``pg_gap``)."""
    gaps, moves = [], []
    for g, end in zip(groups, ends):
        gaps.append((judged[g.rows].double() - end).norm(dim=1))
        moves.append((end - start[g.rows].double()).norm(dim=1))
    gap, move = torch.cat(gaps), torch.cat(moves)
    return float((gap / move.clamp_min(float(move.median()))).max())


@pytest.mark.parametrize("maxupd", [1, 3])
def test_last_epoch_halves_follow_the_reference(problem, maxupd):
    from poismf_torch import train

    rows, cols, vals, ing, A0, B0 = problem
    p = train.FitParams(k=K, method="pg", l2_reg=L2, niter=NITER,
                        maxupd=maxupd, initial_step=STEP, layout="ell",
                        plane_dtype=None)
    kept = {}

    def callback(epoch, A, B):
        if epoch == NITER - 2:
            kept["start"] = (A.clone(), B.clone())

    A, B, status = train.run_poismf(A0, B0, ing.by_user, ing.by_item, p,
                                    callback=callback)
    assert status == 0
    A_s, B_s = kept["start"]
    u_ptr, u_cols, u_vals = data.csr(rows, cols, vals, N_USERS)
    i_ptr, i_cols, i_vals = data.csr(cols, rows, vals, N_ITEMS)
    halves = {"items": (i_ptr, i_cols, i_vals, A_s[:N_USERS], u_ptr, B_s, B),
              "users": (u_ptr, u_cols, u_vals, B[:N_ITEMS], i_ptr, A_s, A)}
    for side, (ptr, idx, v, fixed, f_ptr, start, judged) in halves.items():
        F = fixed.double()
        s = F[f_ptr[1:] > f_ptr[:-1]].sum(0)
        has = torch.nonzero(ptr[1:] > ptr[:-1]).squeeze(1)
        groups = ref.make_groups(has, ptr, idx, v, F)
        step, div = ref_pg.schedule(STEP, NITER - 1, side, L2)
        ends = [ref_pg.pg_steps(g, start[g.rows].double(), s, step, div,
                                maxupd) for g in groups]
        assert _row_gap(groups, start, judged, ends) <= TOL, side
        # the step of the epoch before lands elsewhere: the gap sees it
        step, div = ref_pg.schedule(STEP, NITER - 2, side, L2)
        other = [ref_pg.pg_steps(g, start[g.rows].double(), s, step, div,
                                 maxupd) for g in groups]
        assert _row_gap(groups, start, judged, other) > 100 * TOL, side


def test_schedule_halves_the_step_and_keeps_the_item_divisor():
    h_i, d_i = ref_pg.schedule(1e-7, 3, "items", 1e9)
    h_u, d_u = ref_pg.schedule(1e-7, 3, "users", 1e9)
    assert h_i == 1e-7 / 8 and h_u == h_i / 2
    assert d_u == d_i == 1.0 / (1.0 + 2e9 * h_i)


@pytest.mark.parametrize("plane_dtype,tol", [(None, 1e-6),
                                             ("bfloat16", 1e-2)])
def test_data_term_matches_the_reference(problem, plane_dtype, tol):
    """``pg_grad_ell`` at the users' init against the items' init, as a
    share of the larger of the row's reference norm and the median row's
    (the cell's ``data_err``): float32 planes read 9e-8 here, bf16 planes
    (8 bits of mantissa) 7.7e-4."""
    from poismf_torch import train
    from poismf_torch.ops import ell as ell_ops

    rows, cols, vals, ing, A0, B0 = problem
    ell_user, ell_item = train.ell_pair_cached(ing.by_user, ing.by_item,
                                               "cpu")
    A_p = ell_ops.permute_rows(A0, ell_user.perm)
    B_p = ell_ops.permute_rows(B0, ell_item.perm)
    planes = ell_ops.gather_planes(B_p, ell_user, plane_dtype)
    d = ell_ops.pg_grad_ell(A_p, planes, ell_user)
    ptr, c, v = data.csr(rows, cols, vals, N_USERS)
    has = torch.nonzero(ptr[1:] > ptr[:-1]).squeeze(1)
    gaps, norms = [], []
    for g in ref.make_groups(has, ptr, c, v, B0[:N_ITEMS].double()):
        d_ref = ref_pg.data_term(g, A0[g.rows].double())
        d_got = d[ell_user.inv_perm[g.rows]].double()
        gaps.append((d_got - d_ref).norm(dim=1))
        norms.append(d_ref.norm(dim=1))
    gap, norm = torch.cat(gaps), torch.cat(norms)
    assert float((gap / norm.clamp_min(float(norm.median()))).max()) <= tol
