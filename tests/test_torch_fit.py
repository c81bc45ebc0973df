"""PyTorch port, the whole slice: ``PoisMF(method=...).fit`` for tncg, cg
(ray and fused line searches) and pg on the CPU against
``poismf_tpu.PoisMF`` with the same ``random_state`` (both draw
bit-identical initial factors on the host), then serving from the JAX
model's factors through ``load_model`` / ``model_from_numpy``, and JAX
checkpoints of cg and pg models loaded with their method.

Tolerances: the train LL within 1e-2 relative (fits on different
reduction orders agree to that band, docs/DESIGN.md:376-380) and the
share of exact zeros in A and B within 0.02; predictions rtol 1e-6 and
equal top-N ids.  Both packages run at their defaults: the cascades'
profile-adaptive compact plans on, cg's entry-probe compaction on."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import poismf_tpu  # noqa: E402
import poismf_torch  # noqa: E402
from poismf_torch.io.checkpoint import load_model, model_from_numpy  # noqa
from tests.conftest import synth_counts  # noqa: E402


def _data():
    rng = np.random.default_rng(1)
    rows, cols, vals = synth_counts(rng, n_users=150, n_items=60,
                                    density=0.12)
    return rows, cols, vals, (150, 60)


# One problem, k and maxupd for every fit in this file, so the JAX side
# compiles its programs once per plane dtype; the sparse configurations
# reach the compact cascade rounds.
@pytest.mark.parametrize("kw", [
    dict(niter=3),
    dict(niter=3, plane_dtype="bfloat16"),
    dict(niter=2, plane_dtype="bfloat16", l2_reg=1e-3, reuse_prev=True),
    dict(niter=2, plane_dtype="bfloat16", l1_reg=0.3, l2_reg=1.0,
         reuse_prev=True),
    dict(method="cg", niter=3),
    dict(method="cg", niter=3, plane_dtype="bfloat16"),
    dict(method="cg", niter=3, limit_step=False),
    dict(method="cg", niter=3, limit_step=False, plane_dtype="bfloat16"),
    dict(method="pg", niter=4),
    dict(method="pg", niter=4, plane_dtype="bfloat16", l2_reg=10.0,
         initial_step=1e-3),
], ids=["f32", "bf16", "bf16-sparse-warm", "bf16-sparse-l1", "cg-ray-f32",
        "cg-ray-bf16", "cg-fused-f32", "cg-fused-bf16", "pg-f32",
        "pg-bf16-mild"])
def test_fit_matches_jax(kw):
    X = _data()
    kw = dict(k=6, random_state=3, **kw)
    kw.setdefault("method", "tncg")
    mj = poismf_tpu.PoisMF(**kw).fit(X)
    mt = poismf_torch.PoisMF(device="cpu", **kw).fit(X)
    assert mt.A.shape == mj.A.shape and mt.B.shape == mj.B.shape
    assert np.isfinite(mt.A).all() and (mt.A >= 0).all()
    assert np.isfinite(mt.B).all() and (mt.B >= 0).all()
    lj, lt = mj.eval_llk(), mt.eval_llk()
    assert abs(lj - lt) / abs(lj) <= 1e-2
    assert abs((mj.A == 0).mean() - (mt.A == 0).mean()) <= 0.02
    assert abs((mj.B == 0).mean() - (mt.B == 0).mean()) <= 0.02


def test_unported_surface_raises():
    """Multi-device training is ported (``tests/test_torch_mesh.py``); a
    ``mesh`` that is not a one-dimensional torch.distributed DeviceMesh
    is refused by the constructor, and by ``fit`` and ``fit_unsafe`` when
    set afterwards."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        poismf_torch.PoisMF(k=3, mesh=object(), device="cpu")
    m = poismf_torch.PoisMF(k=3, device="cpu")
    m.mesh = object()
    with pytest.raises(TypeError, match="DeviceMesh"):
        m.fit(_data())
    with pytest.raises(TypeError, match="DeviceMesh"):
        m.fit_unsafe(np.ones((4, 3)), np.ones((5, 3)), None, None)


@pytest.fixture(scope="module")
def jax_model():
    import pandas as pd

    rows, cols, vals, _ = _data()
    df = pd.DataFrame({"UserId": rows * 3 + 7, "ItemId": cols + 100,
                       "Count": vals})
    return poismf_tpu.PoisMF(k=6, method="tncg", niter=2,
                             random_state=4).fit(df), df


def _check_serving(mj, mt, users, items):
    np.testing.assert_allclose(mt.predict(users, items),
                               mj.predict(users, items), rtol=1e-6)
    assert np.isnan(mt.predict([users[0]], [-12345])[0])
    some = list(items[:12])
    for u in users[:5]:
        np.testing.assert_array_equal(mt.topN(u, n=5), mj.topN(u, n=5))
        np.testing.assert_array_equal(mt.topN(u, n=3, include=some),
                                      mj.topN(u, n=3, include=some))
        np.testing.assert_array_equal(mt.topN(u, n=5, exclude=some),
                                      mj.topN(u, n=5, exclude=some))
        ids_t, sc_t = mt.topN(u, n=4, output_score=True)
        ids_j, sc_j = mj.topN(u, n=4, output_score=True)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_allclose(sc_t, sc_j, rtol=1e-6)
    np.testing.assert_array_equal(mt.topN_batched(users[:8], n=5),
                                  mj.topN_batched(users[:8], n=5))


def test_load_jax_checkpoint_and_serve(jax_model, tmp_path):
    mj, df = jax_model
    path = str(tmp_path / "jax_model.npz")
    mj.save(path)
    mt = load_model(path, device="cpu")
    assert mt.reindex and len(mt.item_mapping_)
    np.testing.assert_array_equal(mt.A, mj.A)
    np.testing.assert_array_equal(mt.B, mj.B)
    users = df["UserId"].to_numpy()[:40]
    items = df["ItemId"].to_numpy()[:40]
    _check_serving(mj, mt, users, items)
    trip = (users, items, df["Count"].to_numpy()[:40])
    assert abs(mt.eval_llk(trip) - mj.eval_llk(trip)) <= \
        1e-5 * abs(mj.eval_llk(trip))
    # and back: a port checkpoint loads into the JAX package
    path2 = str(tmp_path / "port_model.npz")
    mt.save(path2)
    mj2 = poismf_tpu.PoisMF.load(path2)
    np.testing.assert_array_equal(mj2.A, mj.A)
    np.testing.assert_array_equal(mj2.topN(users[0], n=5),
                                  mj.topN(users[0], n=5))


def test_model_from_numpy_serves_like_jax():
    X = _data()
    mj = poismf_tpu.PoisMF(k=6, method="tncg", niter=2,
                           random_state=6).fit(X)
    mt = model_from_numpy(mj.A, mj.B, device="cpu", k=6)
    users = X[0][:30]
    items = X[1][:30]
    _check_serving(mj, mt, users, items)
    np.testing.assert_allclose(mt.Amean.numpy(), np.asarray(mj.Amean),
                               rtol=1e-6)
    np.testing.assert_allclose(mt.Bsum.numpy(), np.asarray(mj.Bsum),
                               rtol=1e-6)


@pytest.mark.parametrize("method", ["cg", "pg"])
def test_jax_checkpoint_of_cg_and_pg_loads_with_its_method(method, tmp_path):
    X = _data()
    mj = poismf_tpu.PoisMF(k=6, method=method, niter=2, random_state=5,
                           limit_step=False, initial_step=1e-6).fit(X)
    path = str(tmp_path / "jax_model.npz")
    mj.save(path)
    mt = load_model(path, device="cpu")
    assert (mt.method, mt.limit_step, mt.initial_step) == \
        (method, False, 1e-6)
    np.testing.assert_array_equal(mt.A, mj.A)
    users, items = X[0][:30], X[1][:30]
    _check_serving(mj, mt, users, items)
    path2 = str(tmp_path / "port_model.npz")
    mt.save(path2)
    mj2 = poismf_tpu.PoisMF.load(path2)
    assert (mj2.method, mj2.limit_step, mj2.initial_step) == \
        (method, False, 1e-6)
    np.testing.assert_array_equal(mj2.B, mj.B)
