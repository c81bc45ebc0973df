"""PyTorch port, the flat-COO layout end to end against the JAX package:

(a) One call of each COO solver (``tncg_update``, ``cg_update`` with the
    ray and the fused line search, ``pg_update``) on the same inputs, in
    float64, in one pass and with ``nnz_chunk``: equal ``active`` flags
    and round counters (tncg), iterates within rtol 1e-9, the tolerances
    of ``tests/test_torch_tncg.py``.
(b) ``FitParams(layout="coo")`` resolves ``max_cg="auto"`` to None (the
    reference's maxCGit), as ``tests/test_tncg.py`` pins for the JAX
    package.
(c) ``PoisMF(layout="coo")`` for tncg, cg and pg against
    ``poismf_tpu.PoisMF(layout="coo")`` with the same ``random_state`` on
    60 x 40 at k=4 over 2 epochs: float64 factors within rtol 1e-6 (also
    with ``nnz_chunk``); float32 within the quality band of
    ``tests/test_torch_fit.py`` (train LL 1e-2 relative, exact-zero shares
    0.02).
(d) Serving from the same factors in both packages (the port's float64
    COO model's, handed to the JAX model): ``predict_factors``,
    ``topN_new`` and a small ``transform`` for each method, rtol 1e-6 and
    equal top-N ids (``tests/test_torch_serve.py``); both take the flat
    COO, and the port's batch takes the ELL only above
    ``ELL_SERVE_NNZ_THRESHOLD`` nonzeros of a ``layout="ell"`` model."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
sp = pytest.importorskip("scipy.sparse")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import poismf_tpu  # noqa: E402
import poismf_torch  # noqa: E402
from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu import train as train_jax  # noqa: E402
from poismf_tpu.solvers import cg as cg_jax  # noqa: E402
from poismf_tpu.solvers import pg as pg_jax  # noqa: E402
from poismf_tpu.solvers import tncg as tncg_jax  # noqa: E402
from poismf_torch import serve as serve_pt  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch import train as train_pt  # noqa: E402
from poismf_torch.solvers import cg as cg_pt  # noqa: E402
from poismf_torch.solvers import pg as pg_pt  # noqa: E402
from poismf_torch.solvers import tncg as tncg_pt  # noqa: E402

K = 8
N_USERS, N_ITEMS = 150, 60


# ------------------------------------------------------------------- (a)


@pytest.fixture(scope="module")
def problem():
    """150 x 60 (152 padded rows), 2,275 nonzeros padded to 3,072, with
    users 20-24 empty; factors near the reference's init."""
    rng = np.random.default_rng(51)
    rows, cols, vals = synth_counts(rng, N_USERS, N_ITEMS, density=0.3)
    keep = (rows < 20) | (rows > 24)
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    A = rng.uniform(0.3, 0.31, (152, K))
    B = rng.uniform(0.3, 0.31, (64, K))
    B[N_ITEMS:] = 0.0
    return rows, cols, vals, A, B


def _solve_both(problem, solver_jax, solver_pt, Bsum_w=None, **kw):
    """One solver call in both packages (float64) -> (JAX out, port out)."""
    rows, cols, vals, A, B = problem
    Bsum = B[:N_ITEMS].sum(0) + 0.2
    with jax.enable_x64(True):
        Xj = sparse_jax.build_counts(rows, cols, vals, N_USERS, N_ITEMS,
                                     dtype=np.float64)
        assert Xj.nnz_pad == 3072
        bj = jnp.asarray(Bsum)
        if Bsum_w is not None:
            from poismf_tpu.ops import objective as obj_jax

            bj = obj_jax.adjusted_bsum(jnp.asarray(B), bj, Xj, Bsum_w)
        ref = solver_jax(jnp.asarray(A), jnp.asarray(B), Xj, bj, **kw)
        ref = jax.tree_util.tree_map(np.asarray, ref)
    Xt = sparse_pt.to_device(sparse_pt.build_counts(
        rows, cols, vals, N_USERS, N_ITEMS, dtype=np.float64), "cpu")
    bt = torch.from_numpy(Bsum)
    if Bsum_w is not None:
        from poismf_torch.ops import objective as obj_pt

        bt = obj_pt.adjusted_bsum(torch.from_numpy(B), bt, Xt, Bsum_w)
    out = solver_pt(torch.from_numpy(A), torch.from_numpy(B), Xt, bt, **kw)
    return ref, out


@pytest.mark.parametrize("kw", [
    dict(reuse_prev=False, max_outer=3),
    dict(reuse_prev=False, max_outer=3, max_cg=3, nnz_chunk=1024),
    dict(reuse_prev=False, max_outer=2, ftol=0.0, l2_in_f=True,
         nnz_chunk=1024),
    dict(reuse_prev=False, max_outer=2, w_mult=2.0),
], ids=["cold", "cap3-chunked", "serving-chunked", "w_mult"])
def test_tncg_update_matches_jax_f64(problem, kw):
    w = kw.pop("w_mult", 1.0)
    (xj, sj, stj), (xt, st_, stt) = _solve_both(
        problem, lambda *a, **k: tncg_jax.tncg_update(
            *a, return_stats=True, **k),
        lambda *a, **k: tncg_pt.tncg_update(*a, return_stats=True, **k),
        Bsum_w=None if w == 1.0 else w, l2_reg=1e2,
        maxupd=90, w_mult=w, **kw)
    xt = xt.numpy()
    assert xt.dtype == np.float64
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)
    assert not xt[20:25].any() and not xt[N_USERS:].any()
    np.testing.assert_array_equal(stt["active"].numpy(), stj["active"])
    np.testing.assert_array_equal(stt["nfeval"].numpy(), stj["nfeval"])
    for name in ("outer_iters", "hvp_rounds", "ls_rounds", "clip_rows",
                 "fb_rows"):
        assert stt[name] == int(stj[name]), name
    assert abs(st_ - sj) < 1e-6  # the JAX share is a float32 ratio


@pytest.mark.parametrize("kw", [
    dict(limit_step=True), dict(limit_step=True, nnz_chunk=1024),
    dict(limit_step=False), dict(limit_step=False, nnz_chunk=512),
], ids=["ray", "ray-chunked", "fused", "fused-chunked"])
def test_cg_update_matches_jax_f64(problem, kw):
    xj, xt = _solve_both(problem, cg_jax.cg_update, cg_pt.cg_update,
                         l2_reg=1e2, maxupd=8, **kw)
    xt = xt.numpy()
    assert not xt[20:25].any()
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("kw", [
    dict(), dict(div_step=2e-3, nnz_chunk=1024), dict(w_mult=3.0),
], ids=["plain", "div_step-chunked", "w_mult"])
def test_pg_update_matches_jax_f64(problem, kw):
    w = kw.get("w_mult", 1.0)

    def jax_pg(A, B, X, Bsum, div_step=None, **k):
        return pg_jax.pg_update(
            A, B, X, Bsum, jnp.asarray(10.0), jnp.asarray(1e-3), maxupd=6,
            div_step=None if div_step is None else jnp.asarray(div_step),
            **k)

    def port_pg(A, B, X, Bsum, **k):
        return pg_pt.pg_update(A, B, X, Bsum, 10.0, 1e-3, maxupd=6, **k)

    xj, xt = _solve_both(problem, jax_pg, port_pg,
                         Bsum_w=None if w == 1.0 else w, **kw)
    xt = xt.numpy()
    assert not xt[20:25].any() and (xt[:20] > 0).any()
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)


# ------------------------------------------------------------------- (b)


@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_coo_resolves_the_reference_inner_cg_cap(method):
    for FP in (train_jax.FitParams, train_pt.FitParams):
        p = FP(method=method, layout="coo").resolved()
        assert p.layout == "coo" and p.max_cg is None
        assert FP(method=method, layout="coo", max_cg=5).resolved() \
            .max_cg == 5
        assert FP(method=method).resolved().layout == "ell"
    assert train_pt.FitParams(method="tncg").resolved().max_cg == 3
    with pytest.raises(ValueError):
        train_pt.FitParams(nnz_chunk=0).resolved()


# ------------------------------------------------------------------- (c)


def _data():
    rng = np.random.default_rng(1)
    rows, cols, vals = synth_counts(rng, n_users=60, n_items=40,
                                    density=0.15)
    return rows, cols, vals, (60, 40)


def _kw(method, **kw):
    kw = dict(k=4, method=method, niter=2, random_state=3, layout="coo",
              **kw)
    if method == "pg":
        kw.update(l2_reg=1.0, initial_step=1e-3)
    return kw


@pytest.mark.parametrize("chunk", [None, 512], ids=["one-pass", "chunked"])
@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_coo_fit_matches_jax_f64(method, chunk):
    X = _data()
    kw = _kw(method, use_float=False, nnz_chunk=chunk)
    mj = poismf_tpu.PoisMF(**kw).fit(X)
    mt = poismf_torch.PoisMF(device="cpu", **kw).fit(X)
    assert mt.A.dtype == np.float64 and mt.A.shape == mj.A.shape
    np.testing.assert_allclose(mt.A, mj.A, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(mt.B, mj.B, rtol=1e-6, atol=1e-12)
    assert mt._fit_status == mj._fit_status == 0


@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_coo_fit_matches_jax_f32(method):
    X = _data()
    kw = _kw(method)
    mj = poismf_tpu.PoisMF(**kw).fit(X)
    mt = poismf_torch.PoisMF(device="cpu", **kw).fit(X)
    lj, lt = mj.eval_llk(), mt.eval_llk()
    assert np.isfinite(lt) and abs(lt - lj) <= 1e-2 * abs(lj)
    for got, ref in ((mt.A, mj.A), (mt.B, mj.B)):
        assert got.dtype == np.float32 and (got >= 0).all()
        assert abs((got == 0).mean() - (ref == 0).mean()) <= 0.02


def test_coo_fit_runs_no_ell(monkeypatch):
    """A ``layout="coo"`` fit never builds or sweeps an ELL."""
    from poismf_torch.ops import ell as ell_pt

    def refuse(*a, **k):
        raise AssertionError("the COO fit reached the ELL")

    for name in ("ell_pair_from_counts", "gather_planes", "fgh_ell",
                 "fg_ell", "pg_grad_ell"):
        monkeypatch.setattr(ell_pt, name, refuse)
    for method in ("tncg", "cg", "pg"):
        m = poismf_torch.PoisMF(device="cpu", **_kw(method)).fit(_data())
        assert np.isfinite(m.eval_llk())


# ------------------------------------------------------------------- (d)


@pytest.fixture(scope="module")
def served():
    """{method: (JAX model, port model)} fitted on the COO in float64,
    both serving the port's factors."""
    out = {}
    X = _data()
    for method in ("tncg", "cg", "pg"):
        kw = _kw(method, use_float=False)
        mj = poismf_tpu.PoisMF(**kw).fit(X)
        mt = poismf_torch.PoisMF(device="cpu", **kw).fit(X)
        with jax.enable_x64(True):
            mj._A = jnp.asarray(mt._A.numpy())
            mj._B = jnp.asarray(mt._B.numpy())
            mj.Bsum = jnp.asarray(mt.Bsum.numpy())
            mj.Amean = jnp.asarray(mt.Amean.numpy())
        out[method] = (mj, mt)
    return out


@pytest.fixture
def no_ell(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a small serving solve reached the ELL")

    monkeypatch.setattr(serve_pt, "_factors_multiple_ell", refuse)
    monkeypatch.setattr(serve_pt, "tncg_update_ell", refuse)


def _new_csr(n_users=12, seed=9):
    rows, cols, vals = synth_counts(np.random.default_rng(seed), n_users, 40,
                                    density=0.2)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_users, 40))


def test_predict_factors_and_top_n_new_on_coo_match_jax(served, no_ell):
    mj, mt = served["tncg"]
    X1 = (np.array([1, 5, 5, 9, 30]), np.array([2.0, 1.0, 3.0, 1.0, 4.0]))
    np.testing.assert_allclose(mt.predict_factors(X1),
                               mj.predict_factors(X1), rtol=1e-6,
                               atol=1e-12)
    kw = dict(l2_reg=50.0, l1_reg=0.2, weight_mult=2.0, maxupd=200)
    np.testing.assert_allclose(mt.predict_factors(X1, **kw),
                               mj.predict_factors(X1, **kw), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(mt.topN_new(X1, n=5), mj.topN_new(X1, n=5))


@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_small_transform_on_coo_matches_jax(served, method, no_ell):
    mj, mt = served[method]
    Xn = _new_csr()
    out = mt.transform(Xn)
    assert out.shape == (12, 4) and out.dtype == np.float64
    np.testing.assert_allclose(out, mj.transform(Xn), rtol=1e-6, atol=1e-12)


def test_large_batches_of_an_ell_model_take_the_ell(served, monkeypatch):
    """Above the threshold an ``layout="ell"`` model's batch goes to the
    ELL solvers; a ``layout="coo"`` model's stays on the COO."""
    _, mt = served["cg"]
    calls = []
    real = serve_pt._factors_multiple_ell
    monkeypatch.setattr(serve_pt, "_factors_multiple_ell",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(serve_pt, "ELL_SERVE_NNZ_THRESHOLD", 10)
    Xn = _new_csr()
    coo = mt.transform(Xn)
    assert not calls
    mt.layout = "ell"
    try:
        ell = mt.transform(Xn)
    finally:
        mt.layout = "coo"
    assert calls
    np.testing.assert_allclose(ell, coo, rtol=1e-6, atol=1e-12)
