"""PyTorch port, the solvers' other routes and the training driver's
accounting, against the JAX package on the same inputs:

(a) ``tncg_update_ell`` at ``ls_cand`` 1, 2, 4, 8 and 12, from a cold and
    a warm start, and the COO ``tncg_update`` at 1 and 4, with
    ``return_stats``: the stats of ``poismf_tpu/solvers/tncg.py``
    ``_stats_dict`` (``passes``, ``dbg_search`` and ``dbg_brack``
    included), and every line-search round evaluating ``ls_cand`` trials.
(b) ``bd_accum`` on and off at ``max_cg`` 3 and 10, hvp_bv spied: it
    runs only where ``bd_accum and max_cg <= 6``, and the gated-off
    solve is the hoisted-bdot solve bit for bit.
(c) ``cg_update`` and ``cg_update_ell`` with ``return_passes`` in the ray
    and the fused mode, and with a small ``maxnfeval``.
(d) ``POISMF_TNCG_LS_CAND=1``, ``POISMF_TNCG_BD_ACCUM=0`` and
    ``POISMF_CG_RAY=0`` set after import: ``run_poismf`` fits.
(e) ``train.PASS_STATS`` and ``train.CG_STATS`` over tncg, cg and pg fits
    on the data of ``tests/test_adaptive_cascade.py::
    test_pass_stats_accounting``; the port's factors with and without the
    lists set.
(f) ``POISMF_CASCADE_LOG`` 1 and 2: the lines of one fit, seconds masked.
(g) ``train.initialize_factors_device`` on the CPU.

Everything runs in float64 on a layout with long-row extension chunks
(P_MAX = 16), where every solver decision is the JAX package's.
Tolerances: factors rtol 1e-9; round counters, per-row flags and the
debug arrays equal; sweep counts rel 1e-6 (both sum them in float32);
PASS_STATS bytes and CG_STATS equal; the log lines equal once the
seconds are masked."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu import train as train_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_tpu.solvers import cg as cg_jax  # noqa: E402
from poismf_tpu.solvers import tncg as tncg_jax  # noqa: E402
from poismf_torch import kernels  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch import train as train_pt  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.solvers import cg as cg_pt  # noqa: E402
from poismf_torch.solvers import tncg as tncg_pt  # noqa: E402

K = 8
N_USERS, N_ITEMS = 150, 60
ROUTE_VARS = ("POISMF_TNCG_LS_CAND", "POISMF_TNCG_BD_ACCUM", "POISMF_CG_RAY",
              "POISMF_CASCADE_LOG")
TNCG_STATS = ("outer_iters", "ls_rounds", "hvp_rounds", "clip_rows",
              "fb_rows", "still_active")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for name in ROUTE_VARS:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module")
def problem():
    """150 x 60 counts plus three users of 40 items each (extension chunks
    at P_MAX = 16), factors near the reference's init, in both packages'
    ELL and COO (float64): {"jax": (A_p, planes, ell, Bsum, A, B, X),
    "pt": the same}."""
    rng = np.random.default_rng(61)
    rows, cols, vals = synth_counts(rng, N_USERS, N_ITEMS, density=0.12)
    extra = np.repeat(np.arange(3, dtype=np.int32), 40)
    rows = np.concatenate([rows, extra])
    cols = np.concatenate([cols, rng.integers(0, N_ITEMS, extra.shape[0])])
    vals = np.concatenate([vals, np.full(extra.shape[0], 2.0)])
    A = rng.uniform(0.3, 0.31, (152, K))
    B = rng.uniform(0.3, 0.31, (64, K))
    B[N_ITEMS:] = 0.0
    Bsum = B.sum(0) + 0.2
    shape = (rows, cols, vals, (N_USERS, N_ITEMS))
    saved = ell_jax.P_MAX, ell_pt.P_MAX
    ell_jax.P_MAX = ell_pt.P_MAX = 16
    try:
        with jax.enable_x64(True):
            Xj = sparse_jax.ingest(shape, reindex=False,
                                   dtype=np.float64).by_user
            ell_j = ell_jax.ell_from_counts(Xj)
            jx = (ell_jax.permute_rows(jnp.asarray(A), ell_j.perm),
                  ell_jax.gather_planes(jnp.asarray(B), ell_j), ell_j,
                  jnp.asarray(Bsum), jnp.asarray(A), jnp.asarray(B), Xj)
        Xt = sparse_pt.ingest(shape, reindex=False, dtype=np.float64).by_user
        ell_t = ell_pt.ell_from_counts(Xt)
        At, Bt = torch.from_numpy(A), torch.from_numpy(B)
        pt = (ell_pt.permute_rows(At, ell_t.perm),
              ell_pt.gather_planes(Bt, ell_t), ell_t, torch.from_numpy(Bsum),
              At, Bt, sparse_pt.to_device(Xt, "cpu"))
    finally:
        ell_jax.P_MAX, ell_pt.P_MAX = saved
    assert any(b.ext is not None for b in ell_t.buckets)
    return {"jax": jx, "pt": pt}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _tncg_both(problem, layout, **kw):
    """One tncg solve with ``return_stats`` in both packages -> (JAX x,
    share, stats as NumPy), (port x, share, stats as NumPy)."""
    kw.setdefault("maxupd", 90)
    kw.update(l2_reg=1e3, return_stats=True)

    def args(side):
        A_p, planes, ell, Bsum, A, B, X = problem[side]
        return (A_p, planes, ell, Bsum) if layout == "ell" else (A, B, X,
                                                                 Bsum)

    solve_j = (tncg_jax.tncg_update_ell if layout == "ell"
               else tncg_jax.tncg_update)
    solve_t = (tncg_pt.tncg_update_ell if layout == "ell"
               else tncg_pt.tncg_update)
    with jax.enable_x64(True):
        xj, sj, stj = solve_j(*args("jax"), **kw)
        out_j = (np.asarray(xj), float(sj),
                 {n: np.asarray(v) for n, v in stj.items()})
    xt, st_, stt = solve_t(*args("pt"), **kw)
    return out_j, (xt.numpy(), st_, {n: _np(v) for n, v in stt.items()})


def _same_solve(out_j, out_t, exact=True, C=4):
    """Equal solves.  ``nfeval`` counts every evaluated trial, and a trial
    one ulp from a bracket's end or from a test's edge counts in one
    package and not in the other: XLA's CPU backend contracts the trial
    prediction ``px + alpha * pd`` and a bracket subdivision ``lo + span
    * (j + 1) / C`` into fused multiply-adds (0.5% of such values one ulp
    apart from the port's, which rounds the product first as its kernels
    do), and from a warm start rows grind their line search on an
    objective flat to its last ulp.  Where ``exact`` is off (from a warm
    start, or at C > 4, where each round holds C - 1 subdivisions), a
    row's ``nfeval`` may differ by two rounds' trials (2 max(C, 4);
    ``tests/test_torch_tncg.py``'s 8 at C = 4) and the total by 1%, and
    the rows searching or bracketed at a line-search round by one, with
    the same steps taken."""
    (xj, sj, stj), (xt, st_, stt) = out_j, out_t
    np.testing.assert_allclose(xt, xj, rtol=1e-9, atol=1e-12)
    for name in TNCG_STATS:
        assert int(stt[name]) == int(stj[name]), name
    np.testing.assert_array_equal(stt["active"], stj["active"])
    for name in ("dbg_search", "dbg_brack"):
        assert stt[name].dtype == np.int32
        gap = np.abs(stt[name].astype(np.int64) - stj[name])
        assert gap.max() <= (0 if exact else 1), (name, stt[name], stj[name])
    nfe_t, nfe_j = (st["nfeval"].astype(np.int64) for st in (stt, stj))
    if exact:
        np.testing.assert_array_equal(nfe_t, nfe_j)
    else:
        assert np.abs(nfe_t - nfe_j).max() <= 2 * max(C, 4)
        assert abs(nfe_t.sum() - nfe_j.sum()) <= 0.01 * nfe_j.sum()
    assert stt["passes"] == pytest.approx(float(stj["passes"]), rel=1e-6)
    assert abs(st_ - sj) < 1e-6  # the JAX share is a float32 ratio


# ------------------------------------------------------------------- (a)


@pytest.mark.parametrize("reuse_prev", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("ls_cand", [1, 2, 4, 8, 12])
def test_tncg_ls_cand_matches_jax(problem, monkeypatch, ls_cand, reuse_prev):
    seen = []
    plain = kernels.raygtd_multi_bucket_torch

    def spy(px, pd, vals, alphas):
        seen.append(alphas.shape[0])
        return plain(px, pd, vals, alphas)

    monkeypatch.setattr(kernels, "raygtd_multi_bucket_torch", spy)
    # a budget that does not bind within 3 outer iterations: a row whose
    # trial count differs (see _same_solve) searches as long in both
    out_j, out_t = _tncg_both(problem, "ell", max_outer=3, max_cg=3,
                              maxupd=300, reuse_prev=reuse_prev,
                              ls_cand=ls_cand)
    _same_solve(out_j, out_t, exact=not reuse_prev and ls_cand <= 4,
                C=ls_cand)
    stt = out_t[2]
    assert stt["ls_rounds"] > 0 and stt["dbg_search"][0] > 0
    # every round of every bucket evaluated ls_cand trials
    assert seen and set(seen) == {ls_cand}
    assert len(seen) == stt["ls_rounds"] * len(problem["pt"][2].buckets)


@pytest.mark.parametrize("ls_cand", [1, 4])
def test_tncg_update_coo_ls_cand_matches_jax(problem, ls_cand):
    out_j, out_t = _tncg_both(problem, "coo", max_outer=3,
                              ls_cand=ls_cand)
    _same_solve(out_j, out_t)


def test_ls_cand_default_is_read_per_call(problem, monkeypatch):
    """POISMF_TNCG_LS_CAND set after import gives the solve with that
    ``ls_cand``; the default returns the JAX package's 2-tuple."""
    A_p, planes, ell, Bsum = problem["pt"][:4]
    kw = dict(l2_reg=1e3, maxupd=90, max_outer=2, max_cg=3)
    ref, share_ref = tncg_pt.tncg_update_ell(A_p, planes, ell, Bsum,
                                             ls_cand=1, **kw)
    monkeypatch.setenv("POISMF_TNCG_LS_CAND", "1")
    out = tncg_pt.tncg_update_ell(A_p, planes, ell, Bsum,
                                  track_unchanged=True, **kw)
    assert len(out) == 2 and out[1] == share_ref
    assert torch.equal(out[0], ref)


# ------------------------------------------------------------------- (b)


@pytest.mark.parametrize("bd_accum", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("max_cg", [3, 10])
def test_bd_accum_matches_jax(problem, monkeypatch, max_cg, bd_accum):
    calls = []
    hvp_bv = ell_pt.hvp_bv_ell

    def spy(*a, **k):
        calls.append(1)
        return hvp_bv(*a, **k)

    monkeypatch.setattr(ell_pt, "hvp_bv_ell", spy)
    out_j, out_t = _tncg_both(problem, "ell", max_outer=3, max_cg=max_cg,
                              maxupd=300, reuse_prev=True, bd_accum=bd_accum)
    _same_solve(out_j, out_t, exact=False)
    engaged = bd_accum and max_cg <= tncg_pt.BD_ACCUM_MAX_CG
    assert bool(calls) == engaged
    if not engaged:
        # gated off: the hoisted-bdot solve, bit for bit
        del calls[:]
        x_off, _ = tncg_pt.tncg_update_ell(
            *problem["pt"][:4], l2_reg=1e3, maxupd=300, max_outer=3,
            max_cg=max_cg, reuse_prev=True, bd_accum=False)
        assert torch.equal(torch.from_numpy(out_t[0]), x_off) and not calls


# ------------------------------------------------------------------- (c)


@pytest.mark.parametrize("maxnfeval", [150, 3])
@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_cg_passes_match_jax(problem, layout, maxnfeval):
    kw = dict(l2_reg=50.0, maxupd=8, limit_step=True, return_passes=True,
              maxnfeval=maxnfeval)

    def args(side):
        A_p, planes, ell, Bsum, A, B, X = problem[side]
        return (A_p, planes, ell, Bsum) if layout == "ell" else (A, B, X,
                                                                 Bsum)

    solve_j = cg_jax.cg_update_ell if layout == "ell" else cg_jax.cg_update
    solve_t = cg_pt.cg_update_ell if layout == "ell" else cg_pt.cg_update
    passes = {}
    for use_ray in (True, False):
        with jax.enable_x64(True):
            xj, pj = solve_j(*args("jax"), use_ray=use_ray, **kw)
            xj, pj = np.asarray(xj), float(pj)
        xt, pt = solve_t(*args("pt"), use_ray=use_ray, **kw)
        np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-9, atol=1e-12)
        assert isinstance(pt, float)
        assert pt == pytest.approx(pj, rel=1e-6)
        passes[use_ray] = pt
    if maxnfeval == 150:
        # trials on the cached planes cost a fraction of a sweep each
        assert passes[True] < passes[False]
    else:  # the budget binds: fewer sweeps than at 150
        full = solve_t(*args("pt"), **{**kw, "maxnfeval": 150})[1]
        assert passes[True] < full


# --------------------------------------------------------- fits, (d)-(f)


def _fit_data(dtype=np.float64):
    """The data and factors of test_pass_stats_accounting (200 x 60, k=5)
    in both packages."""
    rows, cols, vals = synth_counts(np.random.default_rng(1), n_users=200,
                                    n_items=60, density=0.1)
    bj = sparse_jax.build_both_orientations(rows, cols, vals, 200, 60,
                                            dtype=dtype)
    bt = sparse_pt.build_both_orientations(rows, cols, vals, 200, 60,
                                           dtype=dtype)
    r = np.random.default_rng(2)
    A0 = train_pt.initialize_factors(200, bt[0].n_rows_pad, 5, r,
                                     dtype).numpy()
    B0 = train_pt.initialize_factors(60, bt[1].n_rows_pad, 5, r,
                                     dtype).numpy()
    return bj, bt, A0, B0


# test_pass_stats_accounting's fits, cg at its own maxupd (5): where an
# Armijo test sits on a tie the two packages' float64 iterates part in
# the last digits (by 1.2e-7 relative after 30 iterations, 5e-10 after 5)
FITS = {"tncg": dict(k=5, method="tncg", niter=2, l2_reg=10.0, maxupd=30),
        "cg": dict(k=5, method="cg", niter=2, l2_reg=10.0, maxupd=5),
        "pg": dict(k=5, method="pg", niter=2, l2_reg=10.0, maxupd=30)}


def _fresh():
    train_jax._ELL_CACHE.clear()
    train_jax._ELL_AUX.clear()
    train_pt._ELL_CACHE.clear()


def _fit_jax(params, stats=False):
    """A JAX float64 run_poismf from fresh caches -> (A, B, PASS_STATS as
    (float, bytes), CG_STATS)."""
    bj, _, A0, B0 = _fit_data()
    _fresh()
    train_jax.PASS_STATS = [] if stats else None
    train_jax.CG_STATS = [] if stats else None
    try:
        with jax.enable_x64(True):
            A, B, st = train_jax.run_poismf(jnp.asarray(A0), jnp.asarray(B0),
                                            *bj, train_jax.FitParams(**params))
            assert st == 0
            entries = [(float(np.asarray(s)), b)
                       for s, b in (train_jax.PASS_STATS or [])]
            return np.asarray(A), np.asarray(B), entries, train_jax.CG_STATS
    finally:
        train_jax.PASS_STATS = train_jax.CG_STATS = None
        _fresh()


def _fit_pt(params, stats=False):
    _, bt, A0, B0 = _fit_data()
    _fresh()
    train_pt.PASS_STATS = [] if stats else None
    train_pt.CG_STATS = [] if stats else None
    try:
        A, B, st = train_pt.run_poismf(torch.from_numpy(A0),
                                       torch.from_numpy(B0), *bt,
                                       train_pt.FitParams(**params))
        assert st == 0
        entries = train_pt.PASS_STATS
        for sweeps, _ in entries or []:
            assert isinstance(sweeps, float)  # a host number: no sync
        return A.numpy(), B.numpy(), entries, train_pt.CG_STATS
    finally:
        train_pt.PASS_STATS = train_pt.CG_STATS = None
        _fresh()


@pytest.mark.parametrize("method,env", [
    ("tncg", {"POISMF_TNCG_LS_CAND": "1", "POISMF_TNCG_BD_ACCUM": "0"}),
    ("cg", {"POISMF_CG_RAY": "0"}),
])
def test_route_variables_set_after_import(monkeypatch, method, env):
    """The variables are read per call: the routes the defaults take, then
    under the variables fits equal to the JAX package's under the same
    variables, along the other routes."""
    spied = {"hvp_bv": 0, "rayf": 0, "raygtd": set()}
    hvp_bv, rayf = ell_pt.hvp_bv_ell, kernels.rayf_multi_bucket_torch
    raygtd = kernels.raygtd_multi_bucket_torch

    def spy_hvp_bv(*a, **k):
        spied["hvp_bv"] += 1
        return hvp_bv(*a, **k)

    def spy_rayf(*a, **k):
        spied["rayf"] += 1
        return rayf(*a, **k)

    def spy_raygtd(px, pd, vals, alphas):
        spied["raygtd"].add(alphas.shape[0])
        return raygtd(px, pd, vals, alphas)

    monkeypatch.setattr(ell_pt, "hvp_bv_ell", spy_hvp_bv)
    monkeypatch.setattr(kernels, "rayf_multi_bucket_torch", spy_rayf)
    monkeypatch.setattr(kernels, "raygtd_multi_bucket_torch", spy_raygtd)
    params = FITS[method]
    _fit_pt(params)
    if method == "tncg":  # the defaults' routes
        assert spied["hvp_bv"] > 0 and spied["raygtd"] == {4}
    else:
        assert spied["rayf"] > 0
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    spied.update(hvp_bv=0, rayf=0, raygtd=set())
    Aj, Bj = _fit_jax(params)[:2]
    At, Bt = _fit_pt(params)[:2]
    np.testing.assert_allclose(At, Aj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(Bt, Bj, rtol=1e-9, atol=1e-12)
    if method == "tncg":
        # full rounds at one candidate, compact rounds at the JAX
        # package's 4 (its compact rounds never read the variable)
        assert spied["hvp_bv"] == 0 and 1 in spied["raygtd"]
        assert spied["raygtd"] <= {1, 4}
    else:
        assert spied["rayf"] == 0


@pytest.mark.parametrize("method", ["tncg", "cg", "pg"])
def test_pass_stats_match_jax(method):
    params = FITS[method]
    Aj, Bj, ej, cj = _fit_jax(params, stats=True)
    A0, B0, _, _ = _fit_pt(params)
    At, Bt, et, ct = _fit_pt(params, stats=True)
    # the lists change nothing
    assert np.array_equal(At, A0) and np.array_equal(Bt, B0)
    np.testing.assert_allclose(At, Aj, rtol=1e-9, atol=1e-12)
    assert len(et) == len(ej) and len(et) > 0
    assert [b for _, b in et] == [b for _, b in ej]
    for (st, _), (sj, _) in zip(et, ej):
        assert st == pytest.approx(sj, rel=1e-6)
        assert st > 0
    total = sum(s * b for s, b in et)
    assert total > 200 * 60 * 0.1 * 5 * 4  # more than one sweep's bytes
    assert ct == cj
    if method == "cg":
        assert len(ct) == 2 * params["niter"] and ct[0]["probed"]
    else:
        assert ct == []


def _masked(text):
    lines = [ln for ln in text.splitlines() if "cascade[" in ln]
    return [re.sub(r"\(\d+\.\d+s\)", "(s)", ln) for ln in lines]


@pytest.mark.parametrize("mode", ["1", "2"])
@pytest.mark.parametrize("method", ["tncg", "cg"])
def test_cascade_log_matches_jax(monkeypatch, capfd, method, mode):
    monkeypatch.setenv("POISMF_CASCADE_LOG", mode)
    trace = train_pt.CASCADE_TRACE = []
    try:
        _fit_jax(FITS[method])
        lines_j = _masked(capfd.readouterr().err)
        _fit_pt(FITS[method])
        lines_t = _masked(capfd.readouterr().err)
    finally:
        train_pt.CASCADE_TRACE = None
    assert lines_t == lines_j
    assert len(lines_t) == len(trace) > 0  # a line a traced round
    if method == "tncg":
        key = "per-bucket" if mode == "2" else "passes="
        assert any(key in ln for ln in lines_t)
    monkeypatch.delenv("POISMF_CASCADE_LOG")
    _fit_pt(FITS[method])
    assert not _masked(capfd.readouterr().err)


# ------------------------------------------------------------------- (g)


def test_initialize_factors_device_on_the_cpu():
    M = train_pt.initialize_factors_device(200, 256, 7, seed=3, device="cpu")
    assert M.shape == (256, 7) and M.dtype == torch.float32
    assert M.device.type == "cpu"
    real = M[:200]
    assert bool((real >= 0.3).all()) and bool((real <= 0.31).all())
    assert float(real.std()) > 1e-3
    assert not M[200:].any()
    again = train_pt.initialize_factors_device(200, 256, 7, 3, "cpu")
    assert torch.equal(M, again)
    other = train_pt.initialize_factors_device(200, 256, 7, 4, "cpu")
    assert not torch.equal(M[:200], other[:200])
    host = train_pt.initialize_factors(200, 256, 7, 3)
    assert not torch.equal(M, host)  # another stream than the host draw
