"""PyTorch port, row-sharded training (``poismf_torch.parallel``) on a
2-rank gloo mesh of CPU processes, against the JAX package's sharded path
on a 2-device mesh (``make_mesh(jax.devices()[:2])``), on the same data
and initial factors; and the small twins ``poismf_torch.model`` and
``poismf_torch.utils.profiling``.

The ranks run ``tests/_torch_mesh_worker.py`` (spawned once for the
module, beside the JAX side's fits); the JAX side runs with P_MAX = 16, as
the ranks do (long-row extension chunks on both orientations), with its
profile-adaptive compact plans on, as the port's are, and from initial
factors whose rows without nonzeros are zero: the port's sharded driver
zeroes them first, as its
single-device driver leaves them out of every Bsum, where the JAX
package's sharded driver sums their initial values into the first
half's.  The ``layout="coo"`` fits (pg and cg on the 2-rank mesh, tncg
in one process) start from the factors as drawn: both packages' COO
drivers sum those rows into the first Bsum.

Tolerances: the layouts exactly equal.  The fits in float64 (pg and cg
2 epochs, tncg 1), where the two packages take the same cascade rounds:
the factors within rtol 1e-7 (measured: pg equal, cg 6e-13 in LL),
except that tncg may leave up to 1% of a side's rows elsewhere, within
5e-2 of the side's largest value, with the train LL within 1e-4
(measured: one user of 300 off by 2.3e-3, the LL by 5.5e-6, every other
row within 2.7e-10).  Such a row sits on an edge of its stopping tests:
starts 1e-14 apart (Bsum summed in another order) end its solve after
different numbers of evaluations, while the two solvers fed the same
inputs agree to 1e-16 (ROADMAP.md, Queue 3).  A 1-rank mesh against no
mesh: the same limits (measured: two users off by 1.4e-4, the LL by
3.3e-7).  The ranks' factors bitwise equal."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import poismf_torch  # noqa: E402
from tests import _torch_mesh_worker as worker  # noqa: E402

FIT_RTOL = 1e-7
# tncg: the share of a side's rows allowed beyond FIT_RTOL, their limit
# (relative to the side's largest value) and the limit of the train LL
TNCG_EDGE_SHARE, TNCG_EDGE_TOL, TNCG_LL_RTOL = 0.01, 5e-2, 1e-4


def _llk(A, B):
    """The train LL over the nonzeros (the objective's data term)."""
    rows, cols, vals = worker.triplets()
    pred = (A[rows] * B[cols]).sum(1)
    return float((vals * np.log(pred) - pred).sum())


def _same_fit(method, A, B, A_ref, B_ref):
    """The fit (A, B) against (A_ref, B_ref), true rows only, at the
    module's limits."""
    for got, ref in ((A[:worker.N_USERS], A_ref[:worker.N_USERS]),
                     (B[:worker.N_ITEMS], B_ref[:worker.N_ITEMS])):
        if method != "tncg":
            np.testing.assert_allclose(got, ref, rtol=FIT_RTOL, atol=1e-12)
            continue
        off = ~np.isclose(got, ref, rtol=FIT_RTOL, atol=1e-12).all(1)
        assert off.mean() <= TNCG_EDGE_SHARE, np.flatnonzero(off)
        np.testing.assert_allclose(got, ref, rtol=0.0,
                                   atol=TNCG_EDGE_TOL * np.abs(ref).max())
    ll, ll_ref = _llk(A, B), _llk(A_ref, B_ref)
    assert abs(ll - ll_ref) <= TNCG_LL_RTOL * abs(ll_ref), (ll, ll_ref)


def _jax_side():
    """The JAX package's shard_ell arrays and 2-device sharded fits."""
    from poismf_tpu import sparse, train
    from poismf_tpu.ops import ell as ell_jax
    from poismf_tpu.parallel import ell_mesh
    from poismf_tpu.parallel.mesh import make_mesh, run_poismf_sharded

    out = {}
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(ell_jax, "P_MAX", worker.P_MAX)
        with jax.enable_x64(True):
            for dtype in (np.float32, np.float64):
                by_user, by_item = worker.counts(sparse, dtype)
                for side, X in (("user", by_user), ("item", by_item)):
                    out[f"layout/{side}/{dtype.__name__}"] = \
                        ell_mesh.shard_ell(X, 2)
            mesh = make_mesh(jax.devices()[:2])
            by_user, by_item = worker.counts(sparse, np.float64)
            for method, kw in worker.FITS.items():
                # the port's sharded driver zeroes the rows without
                # nonzeros first (as its single-device driver leaves them
                # out); the JAX package's sums their initial values into
                # the first half's Bsum: start it where the port starts
                A0, B0 = (np.asarray(M) * (np.asarray(X.row_nnz) > 0)[:, None]
                          for M, X in zip(worker.initial(
                              train, by_user, by_item, np.float64),
                              (by_user, by_item)))
                ell_mesh.CASCADE_TRACE = []
                try:
                    A, B, status = run_poismf_sharded(
                        A0, B0, by_user, by_item,
                        train.FitParams(k=worker.K, method=method, **kw),
                        mesh)
                finally:
                    trace = ell_mesh.CASCADE_TRACE
                    ell_mesh.CASCADE_TRACE = None
                out[f"{method}/A"] = np.asarray(A)
                out[f"{method}/B"] = np.asarray(B)
                out[f"{method}/status"] = status
                out[f"{method}/trace"] = np.array(
                    [(r, s.startswith("compact/"), a, b)
                     for r, s, a, b in trace], dtype=np.int64).reshape(-1, 4)
            # tncg without the cascade, from the same start
            A0, B0 = (np.asarray(M) * (np.asarray(X.row_nnz) > 0)[:, None]
                      for M, X in zip(worker.initial(
                          train, by_user, by_item, np.float64),
                          (by_user, by_item)))
            epochs = []
            A, B, status = run_poismf_sharded(
                A0, B0, by_user, by_item,
                train.FitParams(k=worker.K, method="tncg",
                                **worker.FLAT_TNCG), mesh,
                callback=lambda epoch, A, B: epochs.append(epoch))
            out["flat/A"], out["flat/B"] = np.asarray(A), np.asarray(B)
            out["flat/status"] = np.array([status, len(epochs)])
            # the flat-COO sharded driver, from the initial factors as
            # drawn (both packages' COO drivers sum the rows without
            # nonzeros into the first half's Bsum)
            for method in worker.COO_FITS:
                A0, B0 = worker.initial(train, by_user, by_item, np.float64)
                A, B, status = run_poismf_sharded(
                    A0, B0, by_user, by_item,
                    train.FitParams(k=worker.K, method=method, layout="coo",
                                    **worker.FITS[method]), mesh)
                out[f"coo/{method}/A"] = np.asarray(A)
                out[f"coo/{method}/B"] = np.asarray(B)
                out[f"coo/{method}/status"] = status
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank 0's results, rank 1's, the JAX side's)."""
    tmp = tmp_path_factory.mktemp("mesh")
    ctx = mp.spawn(worker.run, args=(2, str(tmp / "store"), str(tmp)),
                   nprocs=2, join=False)
    try:
        jax_side = _jax_side()
    finally:
        while not ctx.join():
            pass
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return ranks[0], ranks[1], jax_side


@pytest.mark.parametrize("side", ["user", "item"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_shard_ell_equals_jax(runs, side, dtype):
    """Every field of each rank's shard equals the JAX package's
    ``shard_ell(X, 2)`` slice of that shard, exactly."""
    se = runs[2][f"layout/{side}/{dtype}"]
    for d in range(2):
        got = runs[d]
        tag = f"layout/{side}/{dtype}"
        np.testing.assert_array_equal(
            got[f"{tag}/meta"],
            [se.n_slots, se.rps, se.n_shards, se.n_rows, se.n_cols]
            + list(se.Ps) + list(se.Rbs) + list(se.offsets))
        for li, (c, v, s) in enumerate(zip(se.cols, se.vals, se.srcs)):
            np.testing.assert_array_equal(got[f"{tag}/cols{li}"],
                                          np.asarray(c)[d])
            assert got[f"{tag}/vals{li}"].dtype == np.dtype(dtype)
            np.testing.assert_array_equal(got[f"{tag}/vals{li}"],
                                          np.asarray(v)[d])
            assert (f"{tag}/src{li}" in got) == (s is not None)
            if s is not None:
                np.testing.assert_array_equal(got[f"{tag}/src{li}"],
                                              np.asarray(s)[d])
        for name in ("perm", "inv_perm", "row_nnz"):
            np.testing.assert_array_equal(got[f"{tag}/{name}"],
                                          np.asarray(getattr(se, name))[d])


def test_layout_holds_padding_shards_and_extension_chunks(runs):
    """The test layout has what the unification must handle: the item
    side's rank 1 holds only padding, the user side's rows split over
    both ranks, and a user level carries src for rank 0's extension
    chunks and an identity src on rank 1."""
    r0, r1, _ = runs
    item, user = "layout/item/float32/", "layout/user/float32/"
    assert r0[item + "row_nnz"].any() and not r1[item + "row_nnz"].any()
    assert r0[user + "row_nnz"].any() and r1[user + "row_nnz"].any()
    meta = r0[user + "meta"]
    n_slots, levels = int(meta[0]), (meta.shape[0] - 5) // 3
    offsets = meta[5 + 2 * levels:]
    with_src = [li for li in range(levels) if f"{user}src{li}" in r0]
    assert with_src
    for li in with_src:
        own = offsets[li] + np.arange(r0[f"{user}src{li}"].shape[0])
        s0, s1 = r0[f"{user}src{li}"], r1[f"{user}src{li}"]
        assert ((s0 != own) & (s0 != n_slots - 1)).any()  # a chunk
        assert ((s1 == own) | (s1 == n_slots - 1)).all()  # identity


@pytest.mark.parametrize("method", list(worker.FITS))
def test_two_rank_fit_matches_jax(runs, method):
    """A 2-rank fit of the port equals the JAX package's 2-device sharded
    fit in float64, on every rank."""
    ref = runs[2]
    for d in range(2):
        got = [runs[d][f"mesh2/{method}/{side}"] for side in ("A", "B")]
        assert got[0].dtype == got[1].dtype == np.float64
        assert not got[0][worker.N_USERS:].any()
        assert not got[1][worker.N_ITEMS:].any()
        _same_fit(method, *got, ref[f"{method}/A"], ref[f"{method}/B"])
        assert int(runs[d][f"mesh2/{method}/status"]) == \
            ref[f"{method}/status"] == 0


def test_cascade_rounds_match_jax_and_shrink(runs):
    """The port's sharded tncg cascade takes the JAX package's rounds
    (the same structures and active counts over both ranks), its active
    rows shrink, and it reaches a compact round."""
    trace = runs[0]["mesh2/tncg/trace"]
    np.testing.assert_array_equal(trace, runs[2]["tncg/trace"])
    np.testing.assert_array_equal(trace, runs[1]["mesh2/tncg/trace"])
    assert (trace[:, 3] < trace[:, 2]).all()
    assert trace[:, 1].any()


@pytest.mark.parametrize("method", list(worker.FITS))
def test_ranks_end_bitwise_equal(runs, method):
    for side in ("A", "B"):
        np.testing.assert_array_equal(runs[0][f"mesh2/{method}/{side}"],
                                      runs[1][f"mesh2/{method}/{side}"])


@pytest.mark.parametrize("method", list(worker.FITS))
def test_one_rank_mesh_matches_no_mesh(runs, method):
    """A 1-rank mesh fit against the port's single-device fit: the same
    solvers, Bsum summed in the original row order instead of the
    permuted one."""
    r0 = runs[0]
    _same_fit(method, r0[f"mesh1/{method}/A"], r0[f"mesh1/{method}/B"],
              r0[f"single/{method}/A"], r0[f"single/{method}/B"])


def test_tncg_early_stop(runs):
    """The sharded tncg fit stops early (95% of both sides' rows, counted
    over both ranks, moved by <= 1e-4) with status 0."""
    for d in range(2):
        status, epochs = runs[d]["early_stop"]
        assert status == 0
        assert 1 <= epochs < worker.EARLY_STOP_NITER


def test_tncg_without_the_cascade_matches_jax(runs):
    """``compact_tail=False`` on the 2-rank mesh: one solver call a half
    and the early stop from the share of unchanged rows over both ranks,
    as the JAX package's sharded driver takes them: the same epochs and
    the fit within the module's tncg limits, on every rank."""
    ref = runs[2]
    for d in range(2):
        _same_fit("tncg", runs[d]["flat/A"], runs[d]["flat/B"],
                  ref["flat/A"], ref["flat/B"])
        np.testing.assert_array_equal(runs[d]["flat/status"],
                                      ref["flat/status"])
    status, epochs = ref["flat/status"]
    assert status == 0 and 1 <= epochs < worker.EARLY_STOP_NITER


def test_coo_layout_runs_on_ell(runs):
    """``layout="coo"`` on a 2-rank mesh runs the flat-COO row-sharded
    driver: its pg and cg fits equal the JAX package's 2-device
    ``layout="coo"`` sharded fits in float64 (the module's limits), on
    every rank."""
    ref = runs[2]
    for d in range(2):
        for method in worker.COO_FITS:
            got = [runs[d][f"coo/{method}/{side}"] for side in ("A", "B")]
            assert got[0].dtype == np.float64
            assert not got[0][worker.N_USERS:].any()
            _same_fit(method, *got, ref[f"coo/{method}/A"],
                      ref[f"coo/{method}/B"])
            assert int(runs[d][f"coo/{method}/status"]) == \
                ref[f"coo/{method}/status"] == 0
            # another fit than the ELL's (whose driver zeroes the rows
            # without nonzeros before the first half)
            assert not np.array_equal(got[0],
                                      runs[d][f"mesh2/{method}/A"])


def test_model_on_every_rank(runs):
    """``PoisMF(mesh=...)``: the model's device is the mesh's, every rank
    ends with the same whole A and B, bitwise, and serves top-N."""
    r0, r1, _ = runs
    for r in (r0, r1):
        assert str(r["model/device"]) == "cpu"
        assert int(r["model/status"]) == 0
        assert r["model/A"].shape == (worker.N_USERS, worker.K)
        assert r["model/B"].shape == (worker.N_ITEMS, worker.K)
        assert np.isfinite(r["model/A"]).all() and (r["model/A"] >= 0).all()
        assert np.isfinite(float(r["model/llk"]))
        assert r["model/topN"].shape == (4, 5)
        scores = r["model/A"][[0, 1, 150, 299]] @ r["model/B"].T
        np.testing.assert_array_equal(
            np.take_along_axis(scores, r["model/topN"], 1),
            -np.sort(-scores, 1)[:, :5])
    for key in ("model/A", "model/B", "model/topN", "model/llk"):
        np.testing.assert_array_equal(r0[key], r1[key])


def test_device_contradicting_the_mesh_raises(runs):
    for d in range(2):
        assert "contradicts the mesh" in str(runs[d]["refused"])


def test_coo_layout_fits_as_ell():
    """Without a mesh, ``layout="coo"`` fits on the flat COO as the JAX
    package's ``layout="coo"`` does: a float64 tncg fit (no cascade, the
    reference's inner-CG cap) within the module's limits of it, and apart
    from the port's own ELL fit."""
    import poismf_tpu

    rows, cols, vals = worker.triplets()
    X = (rows, cols, vals, (worker.N_USERS, worker.N_ITEMS))
    kw = dict(k=worker.K, method="tncg", niter=2, maxupd=100,
              use_float=False, random_state=5)
    coo = poismf_torch.PoisMF(layout="coo", device="cpu", **kw).fit(X)
    ref = poismf_tpu.PoisMF(layout="coo", **kw).fit(X)
    assert np.isfinite(coo.eval_llk())
    _same_fit("tncg", coo.A, coo.B, ref.A, ref.B)
    ell = poismf_torch.PoisMF(layout="ell", device="cpu", **kw).fit(X)
    assert not np.array_equal(coo.A, ell.A)


def test_model_alias_and_profiling(tmp_path):
    """``poismf_torch.model.PoisMF`` is the model class; ``epoch_logger``
    reports each epoch (with the train LL) as a ``run_poismf`` callback;
    ``trace`` writes a Chrome trace of the block."""
    from poismf_torch import model, sparse, train
    from poismf_torch.utils import profiling

    assert model.PoisMF is poismf_torch.PoisMF
    by_user, by_item = worker.counts(sparse, np.float32)
    A0, B0 = worker.initial(train, by_user, by_item, np.float32)
    lines = []
    path = str(tmp_path / "trace.json")
    with profiling.trace(path):
        train.run_poismf(A0, B0, by_user, by_item,
                         train.FitParams(k=worker.K, method="pg", niter=3),
                         callback=profiling.epoch_logger(by_user,
                                                         printer=lines.append))
    assert [ln.split(":")[0] for ln in lines] == \
        [f"[poismf] epoch {e}" for e in range(3)]
    assert all("train_llk=" in ln for ln in lines)
    assert os.path.getsize(path) > 0
