"""PyTorch port, float64 models (``use_float=False``) along the JAX
package's x64 routes, on the CPU.

The JAX package picks Pallas or jnp per call site from a dtype
(``poismf_tpu/ops/ell.py``): the plane sweeps take their kernel unless
the plane is float64, the ray searches unless ``px`` is, and
``f_gtd_multi_ell`` unless the planes or the iterate are; its fallback
runs ``f_gtd_fused`` at each projected trial, through that op's own
route (:870-886).  The port picks the same routes from the same dtypes
(``poismf_torch/ops/ell.py``).

(i) Each of the twelve ops on a layout with long-row extension chunks,
    for float64 factors beside bf16, float32 and float64 planes, and
    float32 factors beside bf16 planes: the kernel entry point and the
    plain version of each kernel are spied on, and the op must reach the
    table's route (a CUDA tensor launches what the entry point reaches);
    every output is in the factors' dtype.
(ii) ``f_gtd_multi_ell`` with a float64 iterate: the fallback, i.e.
    ``f_gtd_fused_ell`` at each projected trial, at rtol 1e-12 (the
    kernel route it took before, float32 casts, is 1e-9 or more away);
    against the JAX package's ``f_gtd_multi_ell`` under x64 in Pallas
    interpret mode: rtol 1e-12 for float64 planes, and rtol 1e-5, atol
    1e-6 times the output's scale beside bf16 and float32 planes, whose
    data terms are float32 sums in another order (the port's plain
    version against the interpret kernel).
(iii) Whole fits, 60 x 40, k=4, 2 epochs, ``use_float=False`` with
    ``plane_dtype="bfloat16"``, by tncg, cg (ray and fused line searches)
    and pg, against ``poismf_tpu.PoisMF`` under its scoped x64 with
    ``ell._PALLAS_MODE="interpret"``, so that both take the TPU routes:
    float64 factors, the train LL within 1e-6 relative and the factors
    within 1e-5 of their largest value (measured: 3.6e-9 and 1.9e-7; the
    plane sweeps' float32 sums in another order are the only
    difference); the port's fit reached the plane kernels' entry points
    and the plain ray searches only.  The cg ray search is held to the
    LL within 1e-4 and the exact-zero shares within 0.02 (measured 4.7e-5
    and 0): its Armijo base f comes from rayf at alpha = 0 in the port
    (float64 beside float64 px) and from fg in the JAX package (float32
    sums), so a trial on the edge of the test is taken on one side and
    not the other, and cg follows such flips (float64 planes: 3.6e-11).
(iv) A float64 ``transform`` on the ELL serving route
    (``ELL_SERVE_NNZ_THRESHOLD`` patched to 0 in both packages) with
    bf16 planes, the port serving a JAX float64 checkpoint, against the
    JAX model's (interpret mode): each row's serving objective (-LL over
    its items + <Bsum, a> + l2 |a|^2, float64) within 1e-6 relative and
    their sum within 1e-7 (measured 1.2e-7 and 1.6e-8 for cg, less for
    tncg and pg).  The factors themselves are not compared: the serving
    solves run with ftol = 0 along a flat valley, where the float32
    sums' rounding moves them up to 1.3e-3 of their largest value.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import poismf_tpu  # noqa: E402
import poismf_torch  # noqa: E402
from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import serve as serve_jax  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_torch import kernels  # noqa: E402
from poismf_torch import serve as serve_pt  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.io.checkpoint import load_model  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.ops import objective as obj_pt  # noqa: E402

K = 6
L2 = 50.0
C = 3
F64, F32 = torch.float64, torch.float32

# the kernel entry point each op's ELL function reaches on its kernel
# route; the plain version is the same name with "_torch"
ENTRY = {"fgh": "fgh_bucket", "hvp": "hvp_bucket", "hvp_bv": "hvp_bucket",
         "raygtd": "raygtd_multi_bucket", "fg": "fg_bucket",
         "rayf": "rayf_multi_bucket", "pg": "pg_bucket", "f": "f_bucket",
         "f_gtd": "f_gtd_bucket", "f_gtd_fused": "f_gtd_fused_bucket",
         "f_gtd_multi": "f_gtd_multi_bucket", "ray": "ray_bucket"}
RAY_OPS = ("raygtd", "rayf", "ray")
# (factors' dtype, plane dtype)
CASES = {"f64-factors-bf16-planes": (F64, "bfloat16"),
         "f64-factors-f32-planes": (F64, "float32"),
         "f64-planes": (F64, None),
         "f32-factors-bf16-planes": (F32, "bfloat16")}


def expected_route(op, factors, planes):
    """(function name, route) the table gives: "kernel" (the entry point)
    or "plain" (the plain version by name)."""
    plane_f64 = planes is None and factors == F64
    if op == "f_gtd_multi":
        if factors == F64 or plane_f64:
            # JAX's fallback: f_gtd_fused at each trial, by its own route
            return "f_gtd_fused_bucket", "plain" if plane_f64 else "kernel"
        return ENTRY[op], "kernel"
    if op in RAY_OPS:
        # px comes back in the factors' dtype
        return ENTRY[op], "plain" if factors == F64 else "kernel"
    return ENTRY[op], "plain" if plane_f64 else "kernel"


@pytest.fixture
def spy(monkeypatch):
    """Records (name, route, want_bv) for every call the ops make to a
    kernel entry point or a plain version of :mod:`poismf_torch.kernels`
    (an entry point's own call of its plain version is not recorded)."""
    calls = []
    for name in set(ENTRY.values()):
        for route, attr in (("kernel", name), ("plain", name + "_torch")):
            real = getattr(kernels, attr)

            def wrapped(*a, _real=real, _name=name, _route=route, **kw):
                calls.append((_name, _route, bool(kw.get("want_bv"))))
                return _real(*a, **kw)

            monkeypatch.setattr(kernels, attr, wrapped)
    return calls


def _layout(monkeypatch):
    """Both packages' by-user ELLs of one problem, P_MAX patched to 16 so
    that three long rows split into extension chunks, and host factors."""
    monkeypatch.setattr(ell_jax, "P_MAX", 16)
    monkeypatch.setattr(ell_pt, "P_MAX", 16)
    rng = np.random.default_rng(41)
    rows, cols, vals = synth_counts(rng, n_users=150, n_items=60,
                                    density=0.12)
    extra = np.repeat(np.arange(3, dtype=np.int32), 40)
    rows = np.concatenate([rows, extra])
    cols = np.concatenate([cols, rng.integers(0, 60, extra.shape[0])])
    vals = np.concatenate([vals, np.full(extra.shape[0], 2.0)])
    with jax.enable_x64(True):
        dj = sparse_jax.ingest((rows, cols, vals, (150, 60)),
                               dtype=np.float64)
        ell_j = ell_jax.ell_from_counts(dj.by_user)
    dt = sparse_pt.ingest((rows, cols, vals, (150, 60)), dtype=np.float64)
    ell_t = ell_pt.ell_from_counts(dt.by_user)
    B = rng.uniform(0.05, 0.5, (dt.by_item.n_rows_pad, K))
    A = rng.uniform(0.05, 0.5, (ell_t.n_rows_ell, K))
    A[ell_t.host["row_nnz_perm"] == 0] = 0.0
    D = rng.standard_normal(A.shape) * 0.05
    base = rng.uniform(0.5, 1.0, A.shape[0])
    alphas = np.stack([s * base for s in (0.1, 1.0, 2.0)])
    return dict(ell_j=ell_j, ell_t=ell_t, A=A, B=B, D=D, alphas=alphas)


def _run_op(op, lay, factors, planes_dt, spy):
    """Runs ``op``'s ELL function on the case's inputs, with the calls
    that build its inputs (w2, px, bd planes) left out of ``spy``;
    returns its outputs."""
    ell = lay["ell_t"]
    A, D, alphas = (torch.from_numpy(lay[n]).to(factors)
                    for n in ("A", "D", "alphas"))
    B = torch.from_numpy(lay["B"]).to(factors)
    planes = ell_pt.gather_planes(B, ell, planes_dt)
    Bsum = B.sum(0) + 0.1
    _, _, w2s, _, pxs = ell_pt.fgh_ell(A, planes, ell, Bsum, L2)
    bds = ell_pt.bdot_ell(D, planes, ell)
    coef = obj_pt.ray_coef(A, D, Bsum)
    spy.clear()
    return {
        "fgh": lambda: ell_pt.fgh_ell(A, planes, ell, Bsum, L2),
        "hvp": lambda: [ell_pt.hvp_ell(D, planes, ell, w2s, L2)],
        "hvp_bv": lambda: ell_pt.hvp_bv_ell(D, planes, ell, w2s, L2),
        "raygtd": lambda: ell_pt.f_gtd_ray_multi_ell(alphas, coef, pxs, bds,
                                                     ell, L2),
        "fg": lambda: ell_pt.fg_ell(A, planes, ell, Bsum, L2),
        "rayf": lambda: [ell_pt.f_ray_multi_ell(alphas, coef, pxs, bds, ell,
                                                L2)],
        "pg": lambda: [ell_pt.pg_grad_ell(A, planes, ell)],
        "f": lambda: [ell_pt.f_ell(A, planes, ell, Bsum, L2)],
        "f_gtd": lambda: ell_pt.f_gtd_ell(A, D, bds, planes, ell, Bsum, L2),
        "f_gtd_fused": lambda: ell_pt.f_gtd_fused_ell(A, D, planes, ell,
                                                      Bsum, L2),
        "f_gtd_multi": lambda: ell_pt.f_gtd_multi_ell(alphas, A, D, planes,
                                                      ell, Bsum, L2),
        "ray": lambda: ell_pt.f_gtd_ray_ell(alphas[1], coef, pxs, bds, ell,
                                            L2),
    }[op]()


def _tensors(out):
    for o in out:
        if isinstance(o, (tuple, list)):
            yield from _tensors(o)
        elif o is not None:
            yield o


# ------------------------------------------------------------------- (i)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("op", list(ENTRY))
def test_each_op_takes_the_jax_route(op, case, spy, monkeypatch):
    factors, planes_dt = CASES[case]
    lay = _layout(monkeypatch)
    out = _run_op(op, lay, factors, planes_dt, spy)
    name, route = expected_route(op, factors, planes_dt)
    n_buckets = len(lay["ell_t"].buckets)
    per_bucket = C if op == "f_gtd_multi" and name != ENTRY[op] else 1
    want_bv = op == "hvp_bv"
    assert spy == [(name, route, want_bv)] * (n_buckets * per_bucket), spy
    for o in _tensors(out):
        assert o.dtype == factors, (op, o.dtype)
    assert kernels.launch_counts == dict.fromkeys(kernels.launch_counts, 0)


# ------------------------------------------------------------------ (ii)


def _close(port, ref, rtol, atol_scale):
    """Same NaN / +inf / -inf pattern; finite entries within ``rtol`` and
    ``atol_scale`` times the largest finite value (at least 1)."""
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(
        port)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(port), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    fin = np.isfinite(ref)
    scale = max(float(np.abs(ref[fin]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol,
                               atol=atol_scale * scale)


@pytest.mark.parametrize("planes_dt", ["bfloat16", "float32", None],
                         ids=["bf16-planes", "f32-planes", "f64-planes"])
def test_f_gtd_multi_ell_float64_is_the_jax_fallback(planes_dt, monkeypatch):
    lay = _layout(monkeypatch)
    ell_t, ell_j = lay["ell_t"], lay["ell_j"]
    A, D, alphas = (torch.from_numpy(lay[n]) for n in ("A", "D", "alphas"))
    B = torch.from_numpy(lay["B"])
    Bsum = B.sum(0) + 0.1
    planes = ell_pt.gather_planes(B, ell_t, planes_dt)
    args = (L2, 2.0, False)
    out = ell_pt.f_gtd_multi_ell(alphas, A, D, planes, ell_t, Bsum, *args)
    assert all(o.dtype == F64 for o in out)
    for c in range(C):
        trial = torch.clamp_min(A + alphas[c][:, None] * D, 0.0)
        fused = ell_pt.f_gtd_fused_ell(trial, D, planes, ell_t, Bsum, *args)
        for o, r in zip(out, fused):
            _close(o[c], r, 1e-12, 0.0)
    if planes_dt is not None:
        # the kernel route on float32 casts, as the port took it before:
        # apart at float64 tolerance
        old = ell_pt.f_gtd_multi_ell(alphas.float(), A.float(), D.float(),
                                     planes, ell_t, Bsum.float(), *args)
        fin = torch.isfinite(out[0])
        gap = ((old[0].double() - out[0]).abs()[fin]
               / out[0].abs()[fin].clamp_min(1.0)).max()
        assert float(gap) > 1e-9

    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", "interpret")
    with jax.enable_x64(True):
        Bj = jnp.asarray(lay["B"])
        pj = ell_jax.gather_planes(
            Bj, ell_j, None if planes_dt is None else getattr(jnp,
                                                              planes_dt))
        ref = ell_jax.f_gtd_multi_ell(
            jnp.asarray(lay["alphas"]), jnp.asarray(lay["A"]),
            jnp.asarray(lay["D"]), pj, ell_j, Bj.sum(0) + 0.1, *args)
        ref = [np.asarray(r) for r in ref]
    tol = (1e-12, 1e-12) if planes_dt is None else (1e-5, 1e-6)
    for o, r in zip(out, ref):
        assert r.dtype == np.float64
        _close(o, r, *tol)


# ----------------------------------------------------------------- (iii)


def _data():
    rng = np.random.default_rng(1)
    rows, cols, vals = synth_counts(rng, n_users=60, n_items=40,
                                    density=0.15)
    return rows, cols, vals, (60, 40)


FITS = {"tncg": dict(method="tncg"), "cg-ray": dict(method="cg"),
        "cg-fused": dict(method="cg", limit_step=False),
        "pg": dict(method="pg", l2_reg=1.0, initial_step=1e-3)}
# the kernels each method's sweeps reach, and the ray searches it takes on
# the plain route
FIT_ROUTES = {"tncg": ({"fgh_bucket", "hvp_bucket"}, {"raygtd_multi_bucket"}),
              "cg-ray": ({"fg_bucket"}, {"rayf_multi_bucket"}),
              "cg-fused": ({"fg_bucket"}, set()),
              "pg": ({"pg_bucket"}, set())}


@pytest.mark.parametrize("fit", list(FITS))
def test_float64_fit_with_bf16_planes_matches_jax(fit, spy, monkeypatch):
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", "interpret")
    X = _data()
    kw = dict(k=4, niter=2, random_state=3, use_float=False,
              plane_dtype="bfloat16", **FITS[fit])
    mj = poismf_tpu.PoisMF(**kw).fit(X)
    spy.clear()
    mt = poismf_torch.PoisMF(device="cpu", **kw).fit(X)
    assert mt.A.dtype == np.float64 and mt.A.shape == mj.A.shape
    assert np.isfinite(mt.A).all() and (mt.A >= 0).all()
    assert np.isfinite(mt.B).all() and (mt.B >= 0).all()
    lj, lt = mj.eval_llk(), mt.eval_llk()
    if fit == "cg-ray":
        assert abs(lt - lj) <= 1e-4 * abs(lj), (lt, lj)
        for got, ref in ((mt.A, mj.A), (mt.B, mj.B)):
            assert abs((got == 0).mean() - (ref == 0).mean()) <= 0.02
    else:
        assert abs(lt - lj) <= 1e-6 * abs(lj), (lt, lj)
        for got, ref in ((mt.A, mj.A), (mt.B, mj.B)):
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max())
    sweeps, rays = FIT_ROUTES[fit]
    assert {n for n, r, _ in spy if r == "kernel"} == sweeps
    assert {n for n, r, _ in spy if r == "plain"} == rays


# ------------------------------------------------------------------ (iv)


def _serving_objective(A, model, X):
    """Per row of the CSR ``X``: -sum_i x_i log(<a, B_i>) + <Bsum, a> +
    l2 |a|^2 in float64, with the model's B, Bsum and l2."""
    A = np.asarray(A, dtype=np.float64)
    coo = X.tocoo()
    pred = (A[coo.row] * model.B[coo.col]).sum(1)
    f = A @ model.Bsum.numpy() + model._params().l2_reg * (A * A).sum(1)
    np.add.at(f, coo.row, -coo.data * np.log(pred))
    return f


@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_float64_transform_on_the_ell_route_matches_jax(method, tmp_path,
                                                        spy, monkeypatch):
    X = _data()
    kw = dict(k=4, niter=2, random_state=3, use_float=False,
              plane_dtype="bfloat16", method=method)
    if method == "pg":
        kw.update(l2_reg=1.0, initial_step=1e-3)
    mj = poismf_tpu.PoisMF(**kw).fit(X)
    path = str(tmp_path / "model.npz")
    mj.save(path)
    mt = load_model(path, device="cpu")
    assert mt.use_float is False and mt.A.dtype == np.float64
    import scipy.sparse as sp

    rows, cols, vals = synth_counts(np.random.default_rng(9), 30, 40,
                                    density=0.2)
    X_new = sp.csr_matrix((vals, (rows, cols)), shape=(30, 40))
    monkeypatch.setattr(serve_jax, "ELL_SERVE_NNZ_THRESHOLD", 0)
    monkeypatch.setattr(serve_pt, "ELL_SERVE_NNZ_THRESHOLD", 0)
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", "interpret")
    ref = mj.transform(X_new)
    spy.clear()
    out = mt.transform(X_new)
    assert out.dtype == np.float64 and out.shape == ref.shape
    assert (out > 0).any(axis=1).sum() >= 25
    f_port, f_jax = (_serving_objective(a, mt, X_new) for a in (out, ref))
    np.testing.assert_allclose(f_port, f_jax, rtol=1e-6)
    assert abs(f_port.sum() - f_jax.sum()) <= 1e-7 * abs(f_jax.sum())
    assert {r for _, r, _ in spy} == ({"kernel", "plain"} if method != "pg"
                                      else {"kernel"})
