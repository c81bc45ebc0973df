"""PyTorch port, CG solver: one ``cg_update_ell`` call against the JAX
package's on the same inputs, in the ray line-search mode (the default
under ``limit_step``) and the fused mode (``limit_step=False``), with f32
and bf16 planes, on a layout with long-row extension chunks; and the
port's ray mode against its own fused mode; and the ray's base f (alpha
= 0) against fg's f, bit for bit in the plain versions.

Tolerances.  float64: iterates within rtol 1e-9 after 8 iterations
(every accept / reject decision equal).  float32: iterates within rtol
1e-4 on at least 99% of the rows, and every row within rtol 1e-2 (sums
taken in another order).  Under ``limit_step`` float32 is compared after
one iteration: each iteration lands one coordinate of a row on its zero
crossing, and whether it lands at exactly 0 or at a residual above
EPS_LIMIT (1e-15) depends on the last bit, which changes the next
iteration's free set.  The JAX package in float32 agrees with itself in
float64 on 4% of this problem's rows after two ray iterations at l2=1e4
(the port in float32: 12% with JAX's float32); after one iteration all
three agree within rtol 1e-4.  Ray against fused: rtol 2e-4, as the JAX
package's own test of the same equivalence
(``tests/test_cg.py::test_ray_matches_fused_trajectory``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_tpu.solvers import cg as cg_jax  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.solvers import cg as cg_pt  # noqa: E402

K = 16


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(41)
    rows, cols, vals = synth_counts(rng, n_users=150, n_items=60,
                                    density=0.12)
    extra = np.repeat(np.arange(3, dtype=np.int32), 40)
    rows = np.concatenate([rows, extra])
    cols = np.concatenate([cols, rng.integers(0, 60, extra.shape[0])])
    vals = np.concatenate([vals, np.full(extra.shape[0], 2.0)])
    B = rng.uniform(0.3, 0.31, (64, K)).astype(np.float32)
    A = rng.uniform(0.3, 0.31, (152, K)).astype(np.float32)
    return rows, cols, vals, A, B


def _setup(problem, monkeypatch, plane_dtype, dtype):
    monkeypatch.setattr(ell_jax, "P_MAX", 16)
    monkeypatch.setattr(ell_pt, "P_MAX", 16)
    rows, cols, vals, A, B = problem
    A, B = A.astype(dtype), B.astype(dtype)
    dj = sparse_jax.ingest((rows, cols, vals, (150, 60)), dtype=dtype)
    dt = sparse_pt.ingest((rows, cols, vals, (150, 60)), dtype=dtype)
    ell_j = ell_jax.ell_from_counts(dj.by_user)
    ell_t = ell_pt.ell_from_counts(dt.by_user)
    assert any(b.ext is not None for b in ell_t.buckets)
    A_pj = ell_jax.permute_rows(jnp.asarray(A), ell_j.perm)
    A_pt = ell_pt.permute_rows(torch.from_numpy(A), ell_t.perm)
    pj = ell_jax.gather_planes(jnp.asarray(B), ell_j, plane_dtype)
    pt = ell_pt.gather_planes(torch.from_numpy(B), ell_t, plane_dtype)
    Bsum = B.sum(0) + dtype(0.7)  # l1 folded in, as in training
    return (A_pj, pj, ell_j, jnp.asarray(Bsum)), \
        (A_pt, pt, ell_t, torch.from_numpy(Bsum))


def _solve_both(problem, monkeypatch, plane_dtype, dtype, **kw):
    with jax.enable_x64(dtype == np.float64):
        jx, pt = _setup(problem, monkeypatch, plane_dtype, dtype)
        xj = np.asarray(cg_jax.cg_update_ell(*jx, **kw))
    xt = cg_pt.cg_update_ell(*pt, **kw).numpy()
    return xj, xt


MODES = [dict(limit_step=True, use_ray=True),
         dict(limit_step=True, use_ray=False),
         dict(limit_step=False, use_ray=False)]
MODE_IDS = ["ray", "fused-limited", "fused"]


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_cg_update_ell_matches_jax_f64(problem, monkeypatch, mode):
    xj, xt = _solve_both(problem, monkeypatch, None, np.float64,
                         l2_reg=50.0, maxupd=8, **mode)
    assert xt.dtype == np.float64
    assert (xt == 0).any() and (xt > 0).any()
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("plane_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_cg_update_ell_matches_jax_f32(problem, monkeypatch, plane_dtype,
                                       mode):
    xj, xt = _solve_both(problem, monkeypatch, plane_dtype, np.float32,
                         l2_reg=50.0, maxupd=1 if mode["limit_step"] else 5,
                         **mode)
    rows_ok = np.isclose(xt, xj, rtol=1e-4, atol=1e-7).all(1)
    assert rows_ok.mean() >= 0.99
    np.testing.assert_allclose(xt, xj, rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ray_matches_fused_trajectory(dtype):
    """With limit_step every trial stays within the first bound crossing,
    so pred(x + a*d) = px + a*<B, d> holds up to rounding and the two
    modes take the same Armijo decisions.  The problem of the JAX
    package's test of the same property (k=32, 60 x 25 counts).  In
    float32 one row of 256 flips an Armijo test at iteration 6 (the ray
    and the full objective round differently), so float32 holds 99% of
    the rows to rtol 2e-4 and all to 1e-2; float64 holds all to 1e-9."""
    rng = np.random.default_rng(1)
    n_rows, n_cols, k = 60, 25, 32
    rows, cols, vals = synth_counts(rng, n_rows, n_cols, density=0.3)
    X = sparse_pt.build_counts(rows, cols, vals, n_rows, n_cols, dtype=dtype)
    B = np.asarray(0.3 + rng.uniform(0, 0.01, size=(n_cols, k)), dtype)
    A0 = np.zeros((X.n_rows_pad, k), dtype=dtype)
    A0[:n_rows] = 0.3 + rng.uniform(0, 0.01, size=(n_rows, k))
    Bsum = torch.from_numpy(B.sum(0) + dtype(0.7))
    ell = ell_pt.ell_from_counts(X)
    planes = ell_pt.gather_planes(torch.from_numpy(B), ell)
    A0p = ell_pt.permute_rows(torch.from_numpy(A0), ell.perm)
    kw = dict(l2_reg=0.5, maxupd=8, limit_step=True)
    x_ray = cg_pt.cg_update_ell(A0p, planes, ell, Bsum, use_ray=True,
                                **kw).numpy()
    x_fused = cg_pt.cg_update_ell(A0p, planes, ell, Bsum, use_ray=False,
                                  **kw).numpy()
    assert (x_ray == 0).any()
    if dtype == np.float64:
        np.testing.assert_allclose(x_ray, x_fused, rtol=1e-9, atol=1e-12)
        return
    assert np.isclose(x_ray, x_fused, rtol=2e-4, atol=1e-6).all(1).mean() \
        >= 0.99
    np.testing.assert_allclose(x_ray, x_fused, rtol=1e-2, atol=1e-6)


@pytest.mark.parametrize("dtype,plane_dtype", [
    (np.float32, None), (np.float32, "bfloat16"), (np.float64, None)])
def test_ray_base_f_equals_the_full_objective(problem, monkeypatch, dtype,
                                              plane_dtype):
    """The ray search takes its Armijo base f from the ray at alpha = 0;
    in the plain versions that is fg's f bit for bit, so the CPU keeps the
    JAX package's decisions (on the card the two sums differ in order)."""
    from poismf_torch.ops import objective as obj_pt

    _, (A, planes, ell, Bsum) = _setup(problem, monkeypatch, plane_dtype,
                                       dtype)
    f, g, px = ell_pt.fg_ell(A, planes, ell, Bsum, 50.0)
    d = -g
    bd = ell_pt.bdot_ell(d, planes, ell)
    f_ray = ell_pt.f_ray_multi_ell(torch.zeros_like(f)[None],
                                   obj_pt.ray_coef(A, d, Bsum), px, bd, ell,
                                   50.0)
    assert torch.isfinite(f).all()
    assert torch.equal(f_ray[0], f)


def test_ray_mode_refuses_unlimited_steps(problem, monkeypatch):
    _, pt = _setup(problem, monkeypatch, None, np.float32)
    with pytest.raises(ValueError, match="limit_step"):
        cg_pt.cg_update_ell(*pt, l2_reg=1.0, limit_step=False, use_ray=True)
