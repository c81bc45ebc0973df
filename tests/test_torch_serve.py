"""PyTorch port, the serving solves and the evaluation helpers against the
JAX package on the same inputs:

(a) ``serve.factors_multiple`` against the JAX ``_factors_multiple_ell``
    (the JAX package's batch ELL path, reached by setting its
    ``ELL_SERVE_NNZ_THRESHOLD`` to 0) in float64, for tncg, cg and pg and
    with ``w_mult != 1``: rtol 1e-6, atol 1e-12.  The port's float64
    solvers take every decision the JAX ones take
    (``tests/test_torch_tncg.py``); here they agree to ~1e-12.  A batch
    the JAX package solves on flat COO is solved on planes in the
    factors' dtype, whatever ``plane_dtype``: within rtol 5e-2, atol
    5e-3 of the COO solve.
(b) ``serve.factors_single`` (a one-row ELL) against the JAX
    ``factors_single``, which solves on flat COO: float32 within the JAX
    package's own ELL-versus-COO band, rtol 5e-2 and atol 5e-3
    (``tests/test_serve.py``), for duplicate items, ``l1_new > l1_old``,
    ``w_mult != 1``, an empty row and a row longer than ``P_MAX`` (patched
    to 16, so the row is split into extension chunks).
(c) The model layer against ``poismf_tpu.PoisMF`` on float64 models fitted
    from the same data.  ``fit_unsafe`` from the same A0 / B0 / CSR /
    CSC: train LL within 1e-8 relative, factors within rtol 1e-9 for tncg
    and pg (both agree to ~1e-15) and 1e-5 for cg, whose float64 fits
    take the same decisions but drift apart (LL 1e-9, factors up to
    1.7e-6 relative after 3 epochs; 1.8e-7 after one): each iteration
    re-derives the free set and the PRP correction from sums taken in
    another order.  ``predict_factors``, ``topN_new`` and both branches of
    ``transform`` (rtol 1e-6, the JAX side's transform on its ELL path,
    each package serving the same factors), equal top-N ids,
    ``topN_batched(exclude_seen=True)`` with equal ids and scores (an
    exhausted user, an empty user list, a ``ValueError`` after a
    checkpoint load), and every refusal with the JAX package's exception
    type.
(d) ``utils.metrics.ranking_metrics`` and ``utils.data.train_test_split``
    on the inputs of ``tests/test_metrics.py``: metrics within 1e-6, the
    split equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
pd = pytest.importorskip("pandas")
sp = pytest.importorskip("scipy.sparse")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import poismf_tpu  # noqa: E402
import poismf_torch  # noqa: E402
from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import serve as serve_jax  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_tpu.train import FitParams as FitParamsJax  # noqa: E402
from poismf_torch import serve as serve_pt  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.io.checkpoint import load_model  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.train import FitParams as FitParamsPt  # noqa: E402

K = 6
N_USERS, N_ITEMS = 150, 60


def _factors(rng, dtype):
    B = rng.uniform(0.05, 0.5, (64, K)).astype(dtype)
    B[N_ITEMS:] = 0.0
    A = rng.uniform(0.05, 0.5, (N_USERS, K)).astype(dtype)
    return B, B.sum(0) + 0.1, A.mean(0)


# ------------------------------------------------------------------- (a)


@pytest.mark.parametrize("method,kw", [
    ("tncg", {}), ("cg", {}), ("pg", dict(initial_step=1e-3)),
    ("tncg", dict(w_mult=2.0)),
], ids=["tncg", "cg", "pg", "tncg-w_mult"])
def test_factors_multiple_matches_jax_ell_path(method, kw, monkeypatch):
    B, Bsum, Amean = _factors(np.random.default_rng(7), np.float64)
    rows, cols, vals = synth_counts(np.random.default_rng(5), 40, N_ITEMS,
                                    density=0.2)
    p = dict(k=K, method=method, niter=3, l2_reg=1e2, maxupd=20, **kw)
    reuse = method != "tncg"
    monkeypatch.setattr(serve_jax, "ELL_SERVE_NNZ_THRESHOLD", 0)
    with jax.enable_x64(True):
        X_j = sparse_jax.build_counts(rows, cols, vals, 40, N_ITEMS,
                                      dtype=np.float64)
        ref = np.asarray(serve_jax.factors_multiple(
            jnp.asarray(B), jnp.asarray(Bsum), jnp.asarray(Amean), X_j,
            FitParamsJax(**p), reuse_mean=reuse))
    X_t = sparse_pt.build_counts(rows, cols, vals, 40, N_ITEMS,
                                 dtype=np.float64)
    out = serve_pt.factors_multiple(
        torch.from_numpy(B), torch.from_numpy(Bsum),
        torch.from_numpy(Amean), X_t, FitParamsPt(**p),
        reuse_mean=reuse).numpy()
    assert out.dtype == np.float64 and out.shape == ref.shape
    assert (out[:40] > 0).any(axis=1).sum() >= 35
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-12)


def test_small_batches_solve_on_planes_of_the_factors_dtype(monkeypatch):
    """A batch of at most ``ELL_SERVE_NNZ_THRESHOLD`` nonzeros (one the
    JAX package solves on flat COO against B itself) is solved on float32
    planes under ``plane_dtype="bfloat16"``: equal to the float32-plane
    solve, within the JAX package's ELL-versus-COO band of its COO solve
    (rtol 5e-2, atol 5e-3), and apart from the bf16-plane solve a larger
    batch gets."""
    B, Bsum, Amean = _factors(np.random.default_rng(7), np.float32)
    rows, cols, vals = synth_counts(np.random.default_rng(5), 40, N_ITEMS,
                                    density=0.2)
    p = dict(k=K, method="tncg", niter=3, l2_reg=1e2, maxupd=20)
    X_j = sparse_jax.build_counts(rows, cols, vals, 40, N_ITEMS)
    ref = np.asarray(serve_jax.factors_multiple(
        jnp.asarray(B), jnp.asarray(Bsum), jnp.asarray(Amean), X_j,
        FitParamsJax(plane_dtype="bfloat16", **p)))[:40]
    X_t = sparse_pt.build_counts(rows, cols, vals, 40, N_ITEMS)
    args = (torch.from_numpy(B), torch.from_numpy(Bsum),
            torch.from_numpy(Amean), X_t)

    def solve(plane_dtype):
        return serve_pt.factors_multiple(
            *args, FitParamsPt(plane_dtype=plane_dtype, **p)).numpy()[:40]

    out = solve("bfloat16")
    np.testing.assert_array_equal(out, solve(None))
    np.testing.assert_allclose(out, ref, rtol=5e-2, atol=5e-3)
    monkeypatch.setattr(serve_pt, "ELL_SERVE_NNZ_THRESHOLD", 0)
    assert not np.array_equal(solve("bfloat16"), out)


# ------------------------------------------------------------------- (b)


@pytest.mark.parametrize("case", [
    "duplicates", "l1_new", "w_mult", "empty", "longer-than-P_MAX"])
def test_factors_single_matches_jax(case, monkeypatch):
    rng = np.random.default_rng(8)
    B, Bsum, Amean = _factors(rng, np.float32)
    items = np.array([1, 5, 9, 20, 33])
    counts = np.array([2.0, 1.0, 1.0, 4.0, 2.0])
    kw = dict(l2_reg=10.0, maxupd=1000, reuse_mean=True, n_items=N_ITEMS)
    if case == "duplicates":
        items = np.array([1, 5, 5, 9, 20, 33, 1])
        counts = np.array([2.0, 1.0, 3.0, 1.0, 4.0, 2.0, 1.0])
    elif case == "l1_new":
        kw.update(l1_new=0.5, l1_old=0.1)
    elif case == "w_mult":
        kw.update(w_mult=3.0)
    elif case == "empty":
        items, counts = np.array([], dtype=np.int32), np.array([])
    else:
        monkeypatch.setattr(ell_jax, "P_MAX", 16)
        monkeypatch.setattr(ell_pt, "P_MAX", 16)
        items = rng.permutation(N_ITEMS)[:40]
        counts = rng.poisson(2.0, 40) + 1.0
    ref = np.asarray(serve_jax.factors_single(
        jnp.asarray(B), jnp.asarray(Bsum), jnp.asarray(Amean), items,
        counts, **kw))
    out = serve_pt.factors_single(
        torch.from_numpy(B), torch.from_numpy(Bsum),
        torch.from_numpy(Amean), items, counts, **kw).numpy()
    assert out.shape == (K,) and out.dtype == np.float32
    if case == "empty":
        np.testing.assert_array_equal(out, np.zeros(K, np.float32))
        np.testing.assert_array_equal(ref, out)
        return
    assert out.max() > 0
    np.testing.assert_allclose(out, ref, rtol=5e-2, atol=5e-3)


def test_factors_single_long_row_uses_extension_chunks(monkeypatch):
    """The P_MAX case above does split the row: a one-row ELL of 40 items
    at P_MAX=16 holds three virtual rows in one bucket."""
    monkeypatch.setattr(ell_pt, "P_MAX", 16)
    X1 = sparse_pt.build_counts(np.zeros(40, np.int32),
                                np.arange(40, dtype=np.int32),
                                np.ones(40, np.float32), 1, N_ITEMS)
    ell = ell_pt.ell_from_counts(X1)
    assert [b.P for b in ell.buckets] == [16]
    assert ell.buckets[0].ext.numel() == 2
    assert ell.n_rows_ell % 8 == 0 and ell.buckets[0].n_rows % 8 == 0


# ------------------------------------------------------------------- (c)


def _data():
    rows, cols, vals = synth_counts(np.random.default_rng(1), N_USERS,
                                    N_ITEMS, density=0.12)
    # user 3 has seen every item: exclude_seen leaves it nothing
    keep = rows != 3
    rows = np.concatenate([rows[keep], np.full(N_ITEMS, 3, rows.dtype)])
    cols = np.concatenate([cols[keep], np.arange(N_ITEMS, dtype=cols.dtype)])
    vals = np.concatenate([vals[keep], np.full(N_ITEMS, 2.0)])
    return rows, cols, vals


def _unsafe_fit(method):
    rows, cols, vals = _data()
    X = sp.coo_matrix((vals, (rows, cols)), shape=(N_USERS, N_ITEMS)).tocsr()
    rng = np.random.default_rng(2)
    A0 = 0.3 + rng.uniform(0.0, 0.01, (N_USERS, K))
    B0 = 0.3 + rng.uniform(0.0, 0.01, (N_ITEMS, K))
    kw = dict(k=K, method=method, niter=3, use_float=False)
    if method == "pg":
        kw.update(l2_reg=10.0, initial_step=1e-3)
    mj = poismf_tpu.PoisMF(**kw).fit_unsafe(A0, B0, X, X.tocsc())
    mt = poismf_torch.PoisMF(device="cpu", **kw).fit_unsafe(A0, B0, X,
                                                            X.tocsc())
    return mj, mt, X


@pytest.fixture(scope="module")
def unsafe_models():
    return _unsafe_fit("tncg")


@pytest.fixture(scope="module")
def df_models():
    rows, cols, vals = _data()
    df = pd.DataFrame({"UserId": rows * 3 + 7, "ItemId": cols + 100,
                       "Count": vals})
    kw = dict(k=K, method="tncg", niter=2, random_state=4, use_float=False)
    return (poismf_tpu.PoisMF(**kw).fit(df),
            poismf_torch.PoisMF(device="cpu", **kw).fit(df), df)


def _new_csr(n_users=12, seed=9):
    rows, cols, vals = synth_counts(np.random.default_rng(seed), n_users,
                                    N_ITEMS, density=0.15)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_users, N_ITEMS))


def _serve_port_factors(mj, mt):
    """Hand the port model's factors and serving statistics to the JAX
    model, so that both serve the same ones."""
    with jax.enable_x64(True):
        mj._A, mj._B = jnp.asarray(mt._A.numpy()), jnp.asarray(mt._B.numpy())
        mj.Bsum = jnp.asarray(mt.Bsum.numpy())
        mj.Amean = jnp.asarray(mt.Amean.numpy())


def _same_refusal(call_j, call_t):
    """Both packages refuse with the same exception type."""
    with pytest.raises(Exception) as ej:
        call_j()
    with pytest.raises(ej.type):
        call_t()


@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_fit_unsafe_and_transform_match_jax(method, unsafe_models,
                                            monkeypatch):
    mj, mt, X = unsafe_models if method == "tncg" else _unsafe_fit(method)
    assert mt.reindex is False and mt.A.dtype == np.float64
    assert (mt.nusers, mt.nitems) == (N_USERS, N_ITEMS)
    lj, lt = mj.eval_llk(), mt.eval_llk()
    assert abs(lj - lt) <= 1e-8 * abs(lj)
    rtol = 1e-5 if method == "cg" else 1e-9
    np.testing.assert_allclose(mt.A, mj.A, rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(mt.B, mj.B, rtol=rtol, atol=1e-12)
    # the CSR / COO branch of transform from the same factors, the JAX
    # side on its ELL path
    if method != "tncg":
        _serve_port_factors(mj, mt)
    monkeypatch.setattr(serve_jax, "ELL_SERVE_NNZ_THRESHOLD", 0)
    Xn = _new_csr()
    ref = mj.transform(Xn)
    for Xin in (Xn, Xn.tocoo()):
        out = mt.transform(Xin)
        assert out.shape == (12, K) and out.dtype == np.float64
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-12)
    # a narrower matrix is accepted, a wider one refused
    narrow = Xn[:, :50]
    np.testing.assert_allclose(mt.transform(narrow), mj.transform(narrow),
                               rtol=1e-6, atol=1e-12)
    wide = sp.csr_matrix((3, N_ITEMS + 1))
    _same_refusal(lambda: mj.transform(wide), lambda: mt.transform(wide))


def test_predict_factors_and_top_n_new_match_jax(unsafe_models,
                                                 monkeypatch):
    mj, mt, _ = unsafe_models
    X1 = (np.array([1, 5, 5, 9, 30]), np.array([2.0, 1.0, 3.0, 1.0, 4.0]))
    np.testing.assert_allclose(mt.predict_factors(X1),
                               mj.predict_factors(X1), rtol=1e-6,
                               atol=1e-12)
    kw = dict(l2_reg=50.0, l1_reg=0.2, weight_mult=2.0, maxupd=200)
    np.testing.assert_allclose(mt.predict_factors(X1, **kw),
                               mj.predict_factors(X1, **kw), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(mt.topN_new(X1, n=5), mj.topN_new(X1, n=5))
    some = [0, 2, 4, 6, 8, 10]
    np.testing.assert_array_equal(mt.topN_new(X1, n=3, include=some),
                                  mj.topN_new(X1, n=3, include=some))
    np.testing.assert_array_equal(mt.topN_new(X1, n=5, exclude=some),
                                  mj.topN_new(X1, n=5, exclude=some))
    ids_t, sc_t = mt.topN_new(X1, n=4, output_score=True)
    ids_j, sc_j = mj.topN_new(X1, n=4, output_score=True)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(sc_t, sc_j, rtol=1e-6)
    # refusals
    for bad in ((np.array([1, 2]), np.array([1.0])),  # lengths differ
                (np.array([1, N_ITEMS]), np.array([1.0, 1.0])),  # item id
                np.array([1, 2]),  # neither a DataFrame nor a tuple
                (np.array([], dtype=int), np.array([]))):  # all zero
        _same_refusal(lambda: mj.predict_factors(bad),
                      lambda: mt.predict_factors(bad))
    _same_refusal(lambda: mj.topN_new(X1, n=2, include=[1], exclude=[2]),
                  lambda: mt.topN_new(X1, n=2, include=[1], exclude=[2]))
    # a NaN result is refused (no input of this size makes one, so the
    # solve is replaced in both packages)
    k_nan = np.full(K, np.nan)
    monkeypatch.setattr(serve_jax, "factors_single",
                        lambda *a, **kw: jnp.asarray(k_nan))
    monkeypatch.setattr(serve_pt, "factors_single",
                        lambda *a, **kw: torch.from_numpy(k_nan))
    _same_refusal(lambda: mj.predict_factors(X1),
                  lambda: mt.predict_factors(X1))
    with pytest.raises(ValueError, match="NaNs encountered"):
        mt.predict_factors(X1)


def test_top_n_batched_exclude_seen_matches_jax(unsafe_models, tmp_path):
    mj, mt, X = unsafe_models
    users = np.array([0, 3, 7, 3, 149, 42])
    for n in (5, N_ITEMS - 5):
        ids_t, sc_t = mt.topN_batched(users, n=n, exclude_seen=True,
                                      output_score=True)
        ids_j, sc_j = mj.topN_batched(users, n=n, exclude_seen=True,
                                      output_score=True)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(sc_t, sc_j, rtol=1e-6)
        assert (ids_t[1] == -1).all() and np.isneginf(sc_t[1]).all()
        for row, u in enumerate(users):
            seen = set(X.indices[X.indptr[u]:X.indptr[u + 1]].tolist())
            assert not seen & set(ids_t[row].tolist())
    # users whose pool runs out part of the way
    ids_t = mt.topN_batched(users, n=N_ITEMS - 2, exclude_seen=True)
    assert (ids_t[0] == -1).any() and (ids_t[0] >= 0).any()
    np.testing.assert_array_equal(
        ids_t, mj.topN_batched(users, n=N_ITEMS - 2, exclude_seen=True))
    # the chunked path: a chunk smaller than the query set
    mt._EXCL_CHUNK = 4
    try:
        np.testing.assert_array_equal(
            mt.topN_batched(users, n=5, exclude_seen=True),
            mj.topN_batched(users, n=5, exclude_seen=True))
    finally:
        del mt._EXCL_CHUNK
    empty_t = mt.topN_batched([], n=5, exclude_seen=True)
    empty_j = mj.topN_batched([], n=5, exclude_seen=True)
    assert empty_t.shape == empty_j.shape == (0, 5)
    _same_refusal(lambda: mj.topN_batched([0, N_USERS], n=3,
                                          exclude_seen=True),
                  lambda: mt.topN_batched([0, N_USERS], n=3,
                                          exclude_seen=True))
    # without training data (a checkpoint) exclude_seen is refused
    mt.save(str(tmp_path / "port.npz"))
    loaded_t = load_model(str(tmp_path / "port.npz"), device="cpu")
    loaded_j = poismf_tpu.PoisMF.load(str(tmp_path / "port.npz"))
    with pytest.raises(ValueError, match="exclude_seen"):
        loaded_j.topN_batched([0], n=3, exclude_seen=True)
    with pytest.raises(ValueError, match="exclude_seen"):
        loaded_t.topN_batched([0], n=3, exclude_seen=True)


def test_refit_resets_the_exclusion_cache():
    rows, cols, vals = _data()
    m = poismf_torch.PoisMF(k=3, niter=1, device="cpu")
    m.fit((rows, cols, vals, (N_USERS, N_ITEMS)))
    first = m._user_items_csr()
    assert m._user_items_csr() is first
    keep = rows != 0
    m.fit((rows[keep], cols[keep], vals[keep], (N_USERS, N_ITEMS)))
    indptr, _ = m._user_items_csr()
    assert indptr[1] == 0 and first[0][1] > 0


def test_dataframe_serving_matches_jax(df_models, monkeypatch):
    mj, mt, df = df_models
    assert mt.reindex and len(mt.item_mapping_)
    np.testing.assert_allclose(mt.A, mj.A, rtol=1e-9, atol=1e-12)
    one = pd.DataFrame({"ItemId": [100, 105, 105, 130],
                        "Count": [2.0, 1.0, 3.0, 1.0]})
    np.testing.assert_allclose(mt.predict_factors(one),
                               mj.predict_factors(one), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_array_equal(mt.topN_new(one, n=5),
                                  mj.topN_new(one, n=5))
    # the DataFrame branch of transform, the JAX side on its ELL path
    monkeypatch.setattr(serve_jax, "ELL_SERVE_NNZ_THRESHOLD", 0)
    new = pd.DataFrame({"UserId": ["a", "a", "b", "c", "c", "c"],
                        "ItemId": [100, 101, 102, 103, 104, 100],
                        "Count": [1.0, 2.0, 3.0, 1.0, 1.0, 5.0]})
    out, mapping = mt.transform(new)
    ref, mapping_j = mj.transform(new)
    np.testing.assert_array_equal(mapping, mapping_j)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-12)
    users = df["UserId"].to_numpy()[:10]
    np.testing.assert_array_equal(
        mt.topN_batched(users, n=5, exclude_seen=True),
        mj.topN_batched(users, n=5, exclude_seen=True))
    # the user who has seen every item: the -1 sentinel among mapped ids
    all_seen = np.array([3 * 3 + 7, users[0]])
    got = mt.topN_batched(all_seen, n=5, exclude_seen=True)
    np.testing.assert_array_equal(
        got, mj.topN_batched(all_seen, n=5, exclude_seen=True))
    assert (got[0] == -1).all()
    # refusals
    csr = sp.csr_matrix((2, N_ITEMS))
    _same_refusal(lambda: mj.transform(csr), lambda: mt.transform(csr))
    no_count = new.drop(columns="Count")
    _same_refusal(lambda: mj.transform(no_count),
                  lambda: mt.transform(no_count))
    unknown = new.assign(ItemId=[100, 101, 102, 103, 104, 99])
    _same_refusal(lambda: mj.transform(unknown),
                  lambda: mt.transform(unknown))
    _same_refusal(lambda: mj.predict_factors(one.drop(columns="Count")),
                  lambda: mt.predict_factors(one.drop(columns="Count")))
    _same_refusal(lambda: mj.predict_factors(one.assign(ItemId=99)),
                  lambda: mt.predict_factors(one.assign(ItemId=99)))


# ------------------------------------------------------------------- (d)


def test_ranking_metrics_match_jax(rng):
    """The inputs of tests/test_metrics.py::test_ranking_metrics_vs_numpy."""
    from poismf_tpu.utils.metrics import ranking_metrics as metrics_jax
    from poismf_torch.utils.metrics import ranking_metrics as metrics_pt

    n_users, n_items, f = 40, 60, 5
    A = rng.uniform(0, 1, (n_users, f)).astype(np.float32)
    B = rng.uniform(0, 1, (n_items, f)).astype(np.float32)

    def sample(density):
        m = rng.random((n_users, n_items)) < density
        vals = rng.poisson(3.0, size=m.sum()) + 1.0
        out = np.zeros((n_users, n_items))
        out[m] = vals
        return out

    tr = sample(0.15)
    te = sample(0.08)
    te[tr > 0] = 0
    Xtr, Xte = sp.csr_matrix(tr), sp.csr_matrix(te)
    ref = metrics_jax(A, B, Xtr, Xte, k=5, chunk=16)
    for A_in, B_in in ((A, B), (torch.from_numpy(A), torch.from_numpy(B))):
        ours = metrics_pt(A_in, B_in, Xtr, Xte, k=5, chunk=16)
        assert ours.keys() == ref.keys()
        for name in ref:
            assert abs(ours[name] - ref[name]) <= 1e-6, (name, ours, ref)
    users = np.array([1, 5, 7, 30])
    ours = metrics_pt(A, B, Xtr, Xte, k=3, users=users)
    ref = metrics_jax(A, B, Xtr, Xte, k=3, users=users)
    for name in ref:
        assert abs(ours[name] - ref[name]) <= 1e-6, (name, ours, ref)
    with pytest.raises(ValueError):
        metrics_pt(A, B, Xtr, sp.csr_matrix((n_users, n_items)), k=5)


def test_train_test_split_matches_jax(rng):
    """The inputs of tests/test_metrics.py::test_train_test_split."""
    from poismf_tpu.utils.data import train_test_split as split_jax
    from poismf_torch.utils.data import train_test_split as split_pt

    n_users, n_items = 80, 40
    dense = (rng.random((n_users, n_items)) < 0.2) * (
        rng.poisson(3.0, (n_users, n_items)) + 1.0
    )
    X = sp.csr_matrix(dense)
    for kw in (dict(test_fraction=0.25, users_test=30, seed=3),
               dict(seed=2)):
        got, ref = split_pt(X, **kw), split_jax(X, **kw)
        for g, r in zip(got[:2], ref[:2]):
            assert (g != r).nnz == 0 and g.shape == r.shape
        np.testing.assert_array_equal(got[2], ref[2])
