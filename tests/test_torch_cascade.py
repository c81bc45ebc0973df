"""PyTorch port, the cascade's state machine: the profile-adaptive compact
plans kept across halves (``train.cascade_aux``, ``_update_profile``,
``_maybe_build_adaptive_plan``, ``ops.ell.plan_compact_from_profile``),
``FitParams.compact_tail`` and cg's entry-probe compaction, against the
JAX package on the same inputs; and on a 2-rank gloo mesh
(``tests/_torch_cascade_worker.py``) the sharded profiles against the
JAX package's ``_update_se_profile``.

Rejection is forced through a seam both packages pass through: an empty
``train.COMPACT_DENOMS`` leaves a cascade no uniform plan, so every tail
is rejected and recorded, and the profile plans built from them carry
the later halves.  The JAX rounds are read through its
``train._cascade_logger``.

Tolerances: plans, profiles, rounds and active counts exactly equal; the
tncg float64 fits within rtol 1e-9 (``tests/test_torch_tncg.py``'s
float64 band; measured ~1e-15); cg's float64 fits against JAX in
``tests/test_torch_float64.py``'s band (train LL rel 1e-4, exact-zero
shares 0.02: the port's ray search takes its Armijo base from rayf at
step 0, the JAX package's from fg, so their iterates part in the last
digits); float32 fits in the fit band (train LL rel 1e-2, exact-zero
shares 0.02); cg's compaction bit for bit equal to the uncompacted solve
in the port."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from tests import _torch_cascade_worker as worker  # noqa: E402
from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu import train as train_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_tpu.parallel import ell_mesh as mesh_jax  # noqa: E402
from poismf_tpu.solvers import cg as cg_jax  # noqa: E402
from poismf_torch import PoisMF  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch import train as train_pt  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.solvers import cg as cg_pt  # noqa: E402

# The forced-rejection fits: the JAX package's adaptive-cascade problem
# (tests/test_adaptive_cascade.py), at the published l2 and maxupd 90;
# its item side leaves tails that the profile plans then carry.
N_USERS, N_ITEMS, K = 2500, 150, 6
FIT = dict(k=K, method="tncg", niter=4, l2_reg=1e3, maxupd=90, max_cg=3)


def _plans(plans):
    return [(pl.denom, pl.caps, pl.offsets, pl.n_slots) for pl in plans]


def _fresh():
    train_jax._ELL_CACHE.clear()
    train_jax._ELL_AUX.clear()
    train_pt._ELL_CACHE.clear()


@pytest.fixture(autouse=True)
def _clear_caches():
    _fresh()
    yield
    _fresh()
    train_pt.CASCADE_TRACE = None


def _orientations(dtype, n_users=N_USERS, n_items=N_ITEMS, density=0.06,
                  seed=1):
    rows, cols, vals = synth_counts(np.random.default_rng(seed), n_users,
                                    n_items, density)
    return (sparse_jax.build_both_orientations(rows, cols, vals, n_users,
                                               n_items, dtype=dtype),
            sparse_pt.build_both_orientations(rows, cols, vals, n_users,
                                              n_items, dtype=dtype))


def _initial(train, by_user, by_item, dtype, k=K):
    """The initial factors as NumPy arrays (the same draws in both
    packages)."""
    r = np.random.default_rng(1)
    return tuple(np.array(train.initialize_factors(
        X.n_rows, X.n_rows_pad, k, r, dtype)) for X in (by_user, by_item))


def _llk(X, A, B):
    """The train LL over the nonzeros of the port's CountsMatrix ``X``."""
    rows, cols, vals = X.triplets()
    pred = (A[rows].astype(np.float64) * B[cols]).sum(1)
    return float((vals * np.log(pred) - pred).sum())


def _in_band(X, got, ref, ll_rtol):
    """Fits ``got`` and ``ref`` ((A, B) each): train LL within ``ll_rtol``
    relative, exact-zero shares of A and B within 0.02."""
    lg, lr = _llk(X, *got), _llk(X, *ref)
    assert abs(lg - lr) <= ll_rtol * abs(lr), (lg, lr)
    for g, r in zip(got, ref):
        assert abs((g == 0).mean() - (r == 0).mean()) <= 0.02


def _jax_rounds(monkeypatch):
    """The JAX package's cascade rounds, (round, structure, active in,
    active out), through its logger."""
    log = []

    def logger(ell):
        def rec(rnd, structure, last, active, act_next, stats=None):
            log.append((rnd, structure,
                        ell.n_rows_ell if active is None
                        else int(np.count_nonzero(active)),
                        0 if act_next is None
                        else int(np.count_nonzero(act_next))))
        return rec

    monkeypatch.setattr(train_jax, "_cascade_logger", logger)
    return log


def _fit_both(monkeypatch, dtype, params, runs=1):
    """``runs`` run_poismf calls on the same CountsMatrix in each package
    (the later ones inherit the cached pair's plans): per run (JAX A, B,
    rounds), (port A, B, rounds); and both packages' plans after the last
    run, by side."""
    log = _jax_rounds(monkeypatch)
    (ju, ji), (tu, ti) = _orientations(dtype)
    out_j, out_t = [], []
    with jax.enable_x64(dtype == np.float64):
        A0, B0 = _initial(train_jax, ju, ji, dtype, params["k"])
        for _ in range(runs):
            del log[:]
            A, B, st = train_jax.run_poismf(A0, B0, ju, ji,
                                            train_jax.FitParams(**params))
            assert st == 0
            out_j.append((np.asarray(A), np.asarray(B), list(log)))
        ell_u, ell_i = next(iter(train_jax._ELL_CACHE.values()))[0]
        plans_j = [_plans(train_jax._ELL_AUX[id(e)]["plans"])
                   for e in (ell_u, ell_i)]
    A0, B0 = _initial(train_pt, tu, ti, dtype, params["k"])
    for _ in range(runs):
        train_pt.CASCADE_TRACE = []
        A, B, st = train_pt.run_poismf(torch.from_numpy(A0),
                                       torch.from_numpy(B0), tu, ti,
                                       train_pt.FitParams(**params))
        assert st == 0
        out_t.append((A.numpy(), B.numpy(), train_pt.CASCADE_TRACE))
    pair = train_pt._ELL_CACHE[next(iter(train_pt._ELL_CACHE))][0]
    plans_t = [_plans(train_pt.cascade_aux(e)["plans"]) for e in pair]
    return out_j, out_t, plans_j, plans_t


# ------------------------------------------------------ plans, profiles


@pytest.mark.parametrize("want", [0, 1, 128, 129, 256, 257, 383, 384, 385,
                                  512, 513, 700, 768, 1000, 1025, 5000])
def test_ladder_ceil_equals_jax(want):
    assert ell_pt._ladder_ceil(want) == ell_jax._ladder_ceil(want)


def test_plan_from_profile_equals_jax():
    """Equal caps, offsets and slots on the same ELL and profiles, the
    0.7 cost gate (None) included."""
    (ju, _), (tu, _) = _orientations(np.float32)
    ej, et = ell_jax.ell_from_counts(ju), ell_pt.ell_from_counts(tu)
    assert [(b.n_rows, b.P) for b in ej.buckets] == \
        [(b.n_rows, b.P) for b in et.buckets]
    nb = len(et.buckets)
    rng = np.random.default_rng(3)
    profiles = [np.full(nb, 65), np.zeros(nb, dtype=np.int64),
                np.array([b.n_rows for b in et.buckets]),
                np.array([b.n_rows // 3 for b in et.buckets])]
    profiles += [rng.integers(0, 400, nb) for _ in range(8)]
    gated = 0
    for prof in profiles:
        pj = ell_jax.plan_compact_from_profile(ej, prof)
        pt = ell_pt.plan_compact_from_profile(et, prof)
        assert (pj is None) == (pt is None), prof
        if pt is None:
            gated += 1
            continue
        assert pt.denom == 0
        assert _plans([pt]) == _plans([pj])
    assert 0 < gated < len(profiles)


# Rejected tails as active rows per bucket of the test ELL's user side
# (128, 1280 and 1280 rows): "small" tails (at most 1/6 of the rows) that
# outgrow their plan four times (the fourth past MAX_ADAPTIVE_REBUILDS),
# "mid" ones (at most 1/2), the second past the 0.7 cost gate, one
# larger tail (not recorded), and a small one that the plans hold.
TAILS = ((0, 16, 25), (3, 66, 102), (4, 99, 153), (5, 260, 150),
         (2, 20, 400), (12, 250, 384), (17, 374, 500), (128, 700, 700),
         (1, 2, 3))


def test_profiles_and_plans_follow_jax():
    """The same sequence of rejected masks gives equal profiles, rebuild
    counts and cost-sorted plan lists (uniform and profile plans), past
    the rebuild bound, the cost gate and the size classes."""
    (ju, _), (tu, _) = _orientations(np.float32)
    ej, et = ell_jax.ell_from_counts(ju), ell_pt.ell_from_counts(tu)
    assert [b.n_rows for b in et.buckets] == [128, 1280, 1280]
    aux_j, aux_t = train_jax._make_aux(ej), train_pt.cascade_aux(et)
    assert _plans(aux_j["plans"]) == _plans(aux_t["plans"])
    rng = np.random.default_rng(4)
    for tail in TAILS:
        active = np.zeros(et.n_rows_ell, dtype=bool)
        for b, n in zip(et.buckets, tail):
            active[b.offset + rng.choice(b.n_rows, n, replace=False)] = True
        train_jax._update_profile(ej, aux_j, active)
        train_pt._update_profile(et, aux_t, active,
                                 int(np.count_nonzero(active)))
        train_jax._maybe_build_adaptive_plan(ej, aux_j)
        train_pt._maybe_build_adaptive_plan(et, aux_t)
        assert aux_t["profiles"].keys() == aux_j["profiles"].keys()
        for cls, prof in aux_j["profiles"].items():
            np.testing.assert_array_equal(aux_t["profiles"][cls], prof)
        assert aux_t["adaptive_rebuilds"] == \
            aux_j.get("adaptive_rebuilds", {})
        assert _plans(aux_t["plans"]) == _plans(aux_j["plans"])
    assert aux_t["adaptive_rebuilds"] == \
        {"small": train_pt.MAX_ADAPTIVE_REBUILDS, "mid": 1}
    assert (aux_t["profiles"]["small"] >
            aux_t["adaptive_caps"]["small"]).any()
    costs = [sum(c * b.P for c, b in zip(pl.caps, et.buckets))
             for pl in aux_t["plans"]]
    assert costs == sorted(costs)
    assert [pl.denom for pl in aux_t["plans"]].count(0) == 2


def test_adaptive_plan_switch_is_read_per_call(monkeypatch):
    (_, _), (tu, _) = _orientations(np.float32)
    et = ell_pt.ell_from_counts(tu)
    aux = train_pt.cascade_aux(et)
    aux["profiles"]["small"] = np.ones(len(et.buckets), dtype=np.int64)
    monkeypatch.setenv("POISMF_ADAPTIVE_PLAN", "0")
    train_pt._maybe_build_adaptive_plan(et, aux)
    assert not aux["adaptive_plans"]
    monkeypatch.delenv("POISMF_ADAPTIVE_PLAN")
    train_pt._maybe_build_adaptive_plan(et, aux)
    assert any(pl is aux["adaptive_plans"]["small"] for pl in aux["plans"])


# ------------------------------------------------ forced-rejection fits


def test_forced_rejection_fit_float64_takes_jax_rounds(monkeypatch):
    """Every tail rejected: the same rounds (structure, denom, active in
    and out) and profile plans as JAX, the plans reaching compact rounds
    in later halves; factors within rtol 1e-9.  A second run_poismf on
    the same CountsMatrix starts from the first fit's plans in both
    packages: its first item half already runs a profile plan."""
    monkeypatch.setattr(train_jax, "COMPACT_DENOMS", ())
    monkeypatch.setattr(train_pt, "COMPACT_DENOMS", ())
    out_j, out_t, plans_j, plans_t = _fit_both(monkeypatch, np.float64,
                                               FIT, runs=2)
    assert plans_t == plans_j
    assert any(d == 0 for side in plans_t for d, *_ in side)
    for (Aj, Bj, log), (At, Bt, trace) in zip(out_j, out_t):
        assert [tuple(e[:4]) for e in trace] == log
        assert all(e.denom == (0 if e.structure == "compact/0" else None)
                   for e in trace)
        np.testing.assert_allclose(At, Aj, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(Bt, Bj, rtol=1e-9, atol=1e-12)
    first, second = (out[2] for out in out_t)
    assert any(e.structure == "compact/0" for e in first)
    assert first[0].plans == {}
    # the second fit's first half: the plans the first fit left
    assert second[0].plans and second[1].structure == "compact/0"
    assert first[1].structure == "full"


def test_forced_rejection_fit_float32_in_the_fit_band(monkeypatch):
    monkeypatch.setattr(train_jax, "COMPACT_DENOMS", ())
    monkeypatch.setattr(train_pt, "COMPACT_DENOMS", ())
    out_j, out_t, _, plans_t = _fit_both(monkeypatch, np.float32, FIT)
    (Aj, Bj, _), (At, Bt, trace) = out_j[0], out_t[0]
    assert any(e.structure == "compact/0" for e in trace)
    assert any(d == 0 for side in plans_t for d, *_ in side)
    _, (tu, _) = _orientations(np.float32)
    _in_band(tu, (At, Bt), (Aj, Bj), 1e-2)


def test_each_public_fit_starts_from_the_static_plans(monkeypatch):
    """PoisMF.fit ingests its data anew, so its cascade starts from the
    uniform plans (here none) each time, and two fits repeat bit for
    bit; a run_poismf on the same CountsMatrix keeps the plans."""
    monkeypatch.setattr(train_pt, "COMPACT_DENOMS", ())
    rows, cols, vals = synth_counts(np.random.default_rng(1), N_USERS,
                                    N_ITEMS, 0.06)
    X = (rows, cols, vals, (N_USERS, N_ITEMS))
    kw = {k: v for k, v in FIT.items() if k != "max_cg"}
    fits = []
    for _ in range(2):
        train_pt.CASCADE_TRACE = []
        m = PoisMF(device="cpu", random_state=2, **kw).fit(X)
        fits.append((m.A, m.B, train_pt.CASCADE_TRACE))
    (A1, B1, t1), (A2, B2, t2) = fits
    np.testing.assert_array_equal(A1, A2)
    np.testing.assert_array_equal(B1, B2)
    assert t1 == t2 and t1[0].plans == {}
    assert any(e.structure == "compact/0" for e in t1)


# ------------------------------------------------------- compact_tail


def test_compact_tail_false_resolves_the_reference_cap():
    p = train_pt.FitParams(method="tncg", compact_tail=False).resolved()
    assert p.max_cg is None
    assert train_pt.FitParams(method="tncg").resolved().max_cg == 3
    assert train_jax.FitParams(method="tncg", compact_tail=False) \
        .resolved().max_cg is None


@pytest.mark.parametrize("method", ["tncg", "cg"])
def test_compact_tail_false_matches_jax(method, monkeypatch):
    """One solver call a half (tncg with its unchanged-share early stop,
    cg without its probe), float64, against the JAX package's."""
    params = dict(k=K, method=method, niter=3, compact_tail=False,
                  l2_reg=1e3 if method == "tncg" else 1e4,
                  maxupd=90 if method == "tncg" else 5)
    out_j, out_t, _, _ = _fit_both(monkeypatch, np.float64, params)
    (Aj, Bj, log), (At, Bt, trace) = out_j[0], out_t[0]
    assert log == [] and trace == []
    if method == "cg":
        _, (tu, _) = _orientations(np.float64)
        _in_band(tu, (At, Bt), (Aj, Bj), 1e-4)
        return
    np.testing.assert_allclose(At, Aj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(Bt, Bj, rtol=1e-9, atol=1e-12)


def test_compact_tail_false_tncg_stops_early():
    (_, _), (tu, ti) = _orientations(np.float64)
    A0, B0 = _initial(train_pt, tu, ti, np.float64)
    epochs = []
    p = train_pt.FitParams(k=K, method="tncg", niter=30, compact_tail=False,
                           l2_reg=1e3, maxupd=90)
    _, _, st = train_pt.run_poismf(torch.from_numpy(A0),
                                   torch.from_numpy(B0), tu, ti, p,
                                   callback=lambda e, A, B: epochs.append(e))
    assert st == 0 and 1 <= len(epochs) < 30


# ----------------------------------------------------- cg compaction


def _cg_problem(dtype, empty_user=False):
    """tests/test_cg.py's compaction problem (400 x 150, 6,000 draws)."""
    rng = np.random.default_rng(9 if empty_user else 3)
    n_u, n_i, nnz = (300, 120, 5000) if empty_user else (400, 150, 6000)
    rows = rng.integers(1 if empty_user else 0, n_u, nnz).astype(np.int32)
    cols = rng.integers(0, n_i, nnz).astype(np.int32)
    vals = (rng.poisson(2.0, nnz) + 1).astype(np.float64)
    return ((n_u, n_i),
            sparse_jax.build_both_orientations(rows, cols, vals, n_u, n_i,
                                               dtype=dtype),
            sparse_pt.build_both_orientations(rows, cols, vals, n_u, n_i,
                                              dtype=dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cg_compaction_is_bitwise_the_full_solve(dtype):
    """The probe compaction engages (uniform plans and the full
    fallback, both sides) and gives the uncompacted fit bit for bit."""
    (n_u, n_i), _, (bu, bi) = _cg_problem(dtype)
    k = 16
    A0 = train_pt.initialize_factors(n_u, bu.n_rows_pad, k,
                                     np.random.default_rng(1), dtype=dtype)
    B0 = train_pt.initialize_factors(n_i, bi.n_rows_pad, k,
                                     np.random.default_rng(2), dtype=dtype)
    p_on = train_pt.FitParams(k=k, method="cg", niter=8)
    train_pt.CASCADE_TRACE = []
    A1, B1, _ = train_pt.run_poismf(A0, B0, bu, bi, p_on)
    trace, train_pt.CASCADE_TRACE = train_pt.CASCADE_TRACE, None
    A2, B2, _ = train_pt.run_poismf(
        A0, B0, bu, bi, dataclasses.replace(p_on, compact_tail=False))
    assert torch.equal(A1, A2) and torch.equal(B1, B2)
    structures = {e.structure for e in trace}
    assert "full/init" in structures
    assert any(s.startswith("compact/") for s in structures)
    assert len(trace) == 16 and all(e.rnd == 0 for e in trace)


def test_cg_compaction_matches_jax():
    """float64, both packages compacting: the same probe decisions and
    factors within rtol 1e-7."""
    (n_u, n_i), (ju, ji), (tu, ti) = _cg_problem(np.float64)
    k = 16
    p = dict(k=k, method="cg", niter=8)
    with jax.enable_x64(True):
        A0 = np.array(train_jax.initialize_factors(
            n_u, ju.n_rows_pad, k, np.random.default_rng(1), np.float64))
        B0 = np.array(train_jax.initialize_factors(
            n_i, ji.n_rows_pad, k, np.random.default_rng(2), np.float64))
        train_jax.CG_STATS = []
        try:
            Aj, Bj, _ = train_jax.run_poismf(A0, B0, ju, ji,
                                             train_jax.FitParams(**p))
            stats = train_jax.CG_STATS
        finally:
            train_jax.CG_STATS = None
        Aj, Bj = np.asarray(Aj), np.asarray(Bj)
    train_pt.CASCADE_TRACE = []
    At, Bt, _ = train_pt.run_poismf(torch.from_numpy(A0),
                                    torch.from_numpy(B0), tu, ti,
                                    train_pt.FitParams(**p))
    trace = train_pt.CASCADE_TRACE
    # the first epochs' probes decide alike; later the two searches'
    # Armijo bases (rayf at step 0 here, fg there) part the iterates
    assert [(e.n_out, e.denom) for e in trace[:6]] == \
        [(s["active"], s["denom"]) for s in stats[:6]]
    assert {e.denom for e in trace} == {s["denom"] for s in stats}
    _in_band(tu, (At.numpy(), Bt.numpy()), (Aj, Bj), 1e-4)


def test_cg_compaction_zeroes_empty_rows():
    """tests/test_cg.py::test_cg_compact_zeroes_empty_rows's twin: a
    poisoned row without nonzeros comes back exactly zero from a warm
    refit whose last A half runs compact."""
    (n_u, n_i), _, (bu, bi) = _cg_problem(np.float32, empty_user=True)
    A0 = train_pt.initialize_factors(n_u, bu.n_rows_pad, 12,
                                     np.random.default_rng(1))
    B0 = train_pt.initialize_factors(n_i, bi.n_rows_pad, 12,
                                     np.random.default_rng(2))
    p = train_pt.FitParams(k=12, method="cg", niter=6)
    A1, B1, st = train_pt.run_poismf(A0, B0, bu, bi, p)
    assert st == 0
    A1 = A1.clone()
    A1[0] = 0.5
    train_pt.CASCADE_TRACE = []
    A2, _, st2 = train_pt.run_poismf(A1, B1, bu, bi, p)
    assert st2 == 0
    assert train_pt.CASCADE_TRACE[-1].structure.startswith("compact/")
    assert torch.equal(A2[0], torch.zeros_like(A2[0]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cg_probe_init_equals_the_plain_call(dtype):
    """tests/test_cg.py::test_cg_probe_init_matches_plain_call's twin,
    and the probe against JAX's (float64)."""
    rows, cols, vals = synth_counts(np.random.default_rng(11), 200, 60, 0.2)
    X = sparse_pt.build_counts(rows, cols, vals.astype(dtype), 200, 60)
    B = 0.3 + np.random.default_rng(5).uniform(0, 0.2, (60, 12))
    A0 = train_pt.initialize_factors(200, X.n_rows_pad, 12,
                                     np.random.default_rng(7), dtype=dtype)
    ell = ell_pt.ell_from_counts(X)
    Bt = torch.from_numpy(B.astype(dtype))
    planes = ell_pt.gather_planes(Bt, ell)
    Bsum = Bt.sum(0)
    A0p = ell_pt.permute_rows(A0, ell.perm)
    kw = dict(l2_reg=0.5, maxupd=6)
    f0, g0, px0, active = cg_pt.cg_probe_ell(A0p, planes, ell, Bsum, 0.5)
    assert bool(active.any()) and not bool(active.all())
    out_plain = cg_pt.cg_update_ell(A0p, planes, ell, Bsum, **kw)
    out_init = cg_pt.cg_update_ell(A0p, planes, ell, Bsum,
                                   init=(f0, g0, px0), **kw)
    assert torch.equal(out_plain, out_init)
    with pytest.raises(ValueError, match="ray mode only"):
        cg_pt.cg_update_ell(A0p, planes, ell, Bsum, limit_step=False,
                            init=(f0, g0, px0), **kw)
    if dtype != np.float64:
        return
    with jax.enable_x64(True):
        Xj = sparse_jax.build_counts(rows, cols, vals, 200, 60)
        ej = ell_jax.ell_from_counts(Xj)
        pj = ell_jax.gather_planes(B, ej)
        Aj = ell_jax.permute_rows(A0.numpy(), ej.perm)
        fj, gj, pxj, aj = cg_jax.cg_probe_ell(Aj, pj, ej, B.sum(0), 0.5)
        np.testing.assert_array_equal(active.numpy(), np.asarray(aj))
        np.testing.assert_allclose(f0.numpy(), np.asarray(fj), rtol=1e-12)
        np.testing.assert_allclose(g0.numpy(), np.asarray(gj), rtol=1e-12,
                                   atol=1e-12)
        for a, b in zip(px0, pxj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)


# ------------------------------------------------------ the sharded rule


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cascade_mesh")
    mp.spawn(worker.run, args=(2, str(tmp / "store"), str(tmp)), nprocs=2)
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]


def _jax_sharded():
    se = mesh_jax.shard_ell(worker.counts(sparse_jax), worker.N_SHARDS)
    return se, mesh_jax._make_se_aux(se)


def test_sharded_profiles_are_the_max_over_ranks_as_jax(ranks):
    """Tails of at most 1/6 of one shard's slots: each rank's profile is
    the JAX package's, the maximum over the devices of each bucket's
    count; the plans built from them are the JAX package's too; and each
    recorded tail took one all_reduce."""
    se, aux = _jax_sharded()
    masks = worker.masks(se.n_slots)
    for i, m in enumerate(masks[:-1]):
        mesh_jax._update_se_profile(se, aux, m)
        for r in ranks:
            got = {k.split("/")[1] for k in r
                   if k.startswith(f"profile{i}/")}
            assert got == set(aux["profiles"])
            for cls, prof in aux["profiles"].items():
                np.testing.assert_array_equal(r[f"profile{i}/{cls}"], prof)
    mesh_jax._maybe_build_se_adaptive_plans(se, aux)
    want = np.array([(pl.denom,) + pl.caps for pl in aux["plans"]])
    assert any(row[0] == 0 for row in want)
    for r in ranks:
        np.testing.assert_array_equal(r["plans"], want)
        assert int(r["all_reduce"]) == len(masks)


def test_sharded_size_rule_differs_from_jax_on_purpose(ranks):
    """Pinned: a tail of 3/4 of one shard's slots (3/8 of all) is recorded
    by the port ("mid": the single-device rule on all ranks' rows and
    slots) and not by the JAX package, which compares all devices' rows
    with one device's slots (1/(2D) of the rows at most).  Fails if
    either side changes."""
    se, aux = _jax_sharded()
    last = worker.masks(se.n_slots)[-1]
    assert se.n_slots // 2 < int(last.sum()) <= worker.N_SHARDS * \
        se.n_slots // 2
    mesh_jax._update_se_profile(se, aux, last)
    assert not aux.get("profiles")
    n = len(worker.masks(se.n_slots)) - 1
    for r in ranks:
        assert f"profile{n}/mid" in r
        before = r.get(f"profile{n - 1}/mid")
        assert before is None or (r[f"profile{n}/mid"] >= before).all()
        assert (r[f"profile{n}/mid"] > 0).any()
