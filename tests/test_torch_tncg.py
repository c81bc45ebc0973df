"""PyTorch port, TNCG solver: one ``tncg_update_ell`` call against the
JAX package's on the same inputs, for 1-3 outer iterations, with the
tight inner-CG cap (max_cg=3: HVPs that accumulate the <B, d> plane) and
the reference cap (max_cg=None, maxCGit=8 at k=16: plain HVPs plus the
bdot sweep), on a layout with long-row extension chunks, and with a
carried feval budget and an active mask as the cascade passes them.

Tolerances.  float32: equal ``active`` flags, and iterates within rtol
1e-4 on at least 99% of the rows.  float32 sums taken in another order
can flip one line-search trial of a near-flat row between accept and
reject (its feval count then differs, so those counts are not compared
in float32); such a row still agrees to rtol 1e-2.  float64 removes most of
that noise: the iterates agree to rtol 1e-9 and ``active`` and the round
counts must be equal, as must ``nfeval`` from a cold start.  From a warm
start some rows grind all 16 line-search rounds on an objective that is
flat to its last ulp, where even float64 ties flip a trial's
sufficient-decrease test; there ``nfeval`` may differ by at most 8, on
at most 10% of the rows, with the same accepted step.

bf16 planes are compared with the JAX kernels in Pallas interpret mode:
the JAX jnp path squares a bf16 plane in bf16 for the Hessian diagonal,
the TPU kernel and the port in f32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_tpu.solvers import tncg as tncg_jax  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.solvers import tncg as tncg_pt  # noqa: E402

K = 16


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(31)
    rows, cols, vals = synth_counts(rng, n_users=150, n_items=60,
                                    density=0.12)
    extra = np.repeat(np.arange(3, dtype=np.int32), 40)
    rows = np.concatenate([rows, extra])
    cols = np.concatenate([cols, rng.integers(0, 60, extra.shape[0])])
    vals = np.concatenate([vals, np.full(extra.shape[0], 2.0)])
    B = rng.uniform(0.3, 0.31, (64, K)).astype(np.float32)
    A = rng.uniform(0.3, 0.31, (152, K)).astype(np.float32)
    return rows, cols, vals, A, B


def _setup(problem, monkeypatch, plane_dtype, dtype=np.float32):
    monkeypatch.setattr(ell_jax, "P_MAX", 16)
    monkeypatch.setattr(ell_pt, "P_MAX", 16)
    rows, cols, vals, A, B = problem
    A, B = A.astype(dtype), B.astype(dtype)
    dj = sparse_jax.ingest((rows, cols, vals, (150, 60)), dtype=dtype)
    dt = sparse_pt.ingest((rows, cols, vals, (150, 60)), dtype=dtype)
    ell_j = ell_jax.ell_from_counts(dj.by_user)
    ell_t = ell_pt.ell_from_counts(dt.by_user)
    A_pj = ell_jax.permute_rows(jnp.asarray(A), ell_j.perm)
    A_pt = ell_pt.permute_rows(torch.from_numpy(A), ell_t.perm)
    pj = ell_jax.gather_planes(jnp.asarray(B), ell_j, plane_dtype)
    pt = ell_pt.gather_planes(torch.from_numpy(B), ell_t, plane_dtype)
    Bsum = B.sum(0)
    return (A_pj, pj, ell_j, jnp.asarray(Bsum)), \
        (A_pt, pt, ell_t, torch.from_numpy(Bsum))


def _solve_both(problem, monkeypatch, plane_dtype, dtype, **kw):
    kw.update(l2_reg=1e3)
    if plane_dtype == "bfloat16":
        monkeypatch.setattr(ell_jax, "_PALLAS_MODE", "interpret")
    with jax.enable_x64(dtype == np.float64):
        jx, pt = _setup(problem, monkeypatch, plane_dtype, dtype)
        xj, sj, stj = tncg_jax.tncg_update_ell(*jx, return_stats=True, **{
            n: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for n, v in kw.items()})
        xj = np.asarray(xj)
        stj = {n: np.asarray(v) for n, v in stj.items()}
    xt, st_, stt = tncg_pt.tncg_update_ell(*pt, return_stats=True, **{
        n: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
        for n, v in kw.items()})
    return (xj, float(sj), stj), (xt.numpy(), st_, stt)


def _check_nfeval(port, ref, exact):
    if exact:
        np.testing.assert_array_equal(port, ref)
        return
    diff = np.abs(port.astype(np.int64) - ref)
    assert diff.max() <= 8 and np.mean(diff > 0) <= 0.1


@pytest.mark.parametrize("plane_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("max_outer,max_cg", [
    (1, 3), (3, 3), (2, None), (3, None),
])
def test_tncg_update_ell_matches_jax_f32(problem, monkeypatch, plane_dtype,
                                         max_outer, max_cg):
    (xj, sj, stj), (xt, st_, stt) = _solve_both(
        problem, monkeypatch, plane_dtype, np.float32, maxupd=90,
        reuse_prev=False, max_outer=max_outer, max_cg=max_cg)
    rows_ok = np.isclose(xt, xj, rtol=1e-4, atol=1e-7).all(1)
    assert rows_ok.mean() >= 0.99
    np.testing.assert_allclose(xt, xj, rtol=1e-2, atol=1e-6)
    np.testing.assert_array_equal(stt["active"].numpy(), stj["active"])
    assert stt["outer_iters"] == int(stj["outer_iters"])
    assert stt["hvp_rounds"] == int(stj["hvp_rounds"])
    assert abs(st_ - sj) < 1e-6


@pytest.mark.parametrize("reuse_prev", [False, True])
@pytest.mark.parametrize("max_cg", [3, None])
def test_tncg_update_ell_matches_jax_f64(problem, monkeypatch, reuse_prev,
                                         max_cg):
    (xj, sj, stj), (xt, st_, stt) = _solve_both(
        problem, monkeypatch, None, np.float64, maxupd=90,
        reuse_prev=reuse_prev, max_outer=3, max_cg=max_cg)
    assert xt.dtype == np.float64
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(stt["active"].numpy(), stj["active"])
    _check_nfeval(stt["nfeval"].numpy(), stj["nfeval"], exact=not reuse_prev)
    for name in ("outer_iters", "hvp_rounds", "ls_rounds", "clip_rows",
                 "fb_rows"):
        assert stt[name] == int(stj[name]), name
    assert stt["passes"] == pytest.approx(float(stj["passes"]), rel=1e-6)
    assert abs(st_ - sj) < 1e-6  # the JAX share is a float32 ratio


def test_tncg_carried_budget_and_mask_match(problem, monkeypatch):
    """A continuation round as the cascade runs it: warm iterates, an
    active mask and a carried per-row feval budget (some rows spent)."""
    R = 384
    rng = np.random.default_rng(32)
    mask = rng.random(R) < 0.6
    nfe0 = rng.integers(0, 40, R).astype(np.int32)
    (xj, _, stj), (xt, _, stt) = _solve_both(
        problem, monkeypatch, None, np.float64, maxupd=40, reuse_prev=True,
        max_outer=4, max_cg=3, active_mask=mask, nfeval0=nfe0)
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)
    np.testing.assert_array_equal(stt["active"].numpy(), stj["active"])
    _check_nfeval(stt["nfeval"].numpy(), stj["nfeval"], exact=False)
