"""PyTorch port, tncg's line-search round (``kernels.ls_round``) as far
as the CPU can check it: the route (the kernel only for float32 state on
the card; ``kernels.ls_round_torch``, the plain ``_ls_fold`` /
``_ls_candidates`` of ``kernels/ls_round.py`` on the round's buffers, on
the CPU and for float64 state), the round's copy of the search state,
the plain round on the buffers against the plain pair, the kernel
launch's refusal of CPU tensors, and the launch counter's keys.  The kernel runs on the card
only: ``tests/test_torch_cuda.py`` holds it to the plain round bit for
bit."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from poismf_torch import kernels  # noqa: E402
from poismf_torch import sparse  # noqa: E402
from poismf_torch.kernels.ls_round import STATE_FLOATS  # noqa: E402
from poismf_torch.ops import ell as ell_ops  # noqa: E402
from poismf_torch.solvers import tncg  # noqa: E402

# the module (the package's ``ls_round`` is its function)
ls_round_mod = importlib.import_module("poismf_torch.kernels.ls_round")

SWEEP_KERNELS = ("fgh", "hvp", "hvp_bv", "raygtd", "fg", "rayf", "pg", "f",
                 "f_gtd", "f_gtd_fused", "f_gtd_multi", "ray")


def _state(R=37, dtype=torch.float32):
    rng = np.random.default_rng(0)
    f = torch.from_numpy(rng.standard_normal(R)).to(dtype)
    ls = {k: torch.from_numpy(rng.standard_normal(R)).to(dtype)
          for k in STATE_FLOATS}
    ls.update(f_lo=f, f_new=f, f_best=f, t=0,
              found=torch.from_numpy(rng.random(R) < 0.5),
              searching=torch.from_numpy(rng.random(R) < 0.5),
              nfeval=torch.from_numpy(rng.integers(0, 9, R).astype(np.int32)))
    return ls, f


def _round_args(R, dtype):
    """(f, dginit, spe, tnytol) of a search: spe inf on a third of the
    rows, getptc's tolerance too tiny to go on on a tenth."""
    rng = np.random.default_rng(1)
    f = torch.from_numpy(rng.standard_normal(R) * 10.0).to(dtype)
    dginit = torch.from_numpy(-np.abs(rng.standard_normal(R)) - 0.1).to(
        dtype)
    spe = np.abs(rng.standard_normal(R)) * 3.0
    spe[rng.random(R) < 0.3] = np.inf
    tnytol = np.abs(rng.standard_normal(R)) * 1e-6
    tnytol[rng.random(R) < 0.1] = 1.0
    return (f, dginit, torch.from_numpy(spe).to(dtype),
            torch.from_numpy(tnytol).to(dtype))


def test_route_takes_the_kernel_only_for_float32_state_on_the_card(
        monkeypatch):
    """The solver's rounds: CPU state, float32 or float64, takes
    ``ls_round_torch``; on the card (the wrappers' device half,
    ``_lib.uses_plain``, made to answer "kernel") float32 state reaches
    the kernel's launch and float64 state ``ls_round_torch``, never the
    launch, whichever layer makes the choice."""
    launched, plain = [], []
    monkeypatch.setattr(ls_round_mod, "_launch",
                        lambda *a: launched.append(a[0][0].dtype))
    real_plain = ls_round_mod.ls_round_torch

    def spy(*a, **kw):
        plain.append(a[0][0].dtype)
        return real_plain(*a, **kw)

    monkeypatch.setattr(ls_round_mod, "ls_round_torch", spy)
    monkeypatch.setattr(kernels, "ls_round_torch", spy)
    rounds = {}
    for device in ("cpu", "card"):
        if device == "card":
            monkeypatch.setattr(ls_round_mod._lib, "uses_plain",
                                lambda *tensors: False)
        for dtype in (torch.float32, torch.float64):
            del launched[:], plain[:]
            ls, _ = _state(dtype=dtype)
            f, dginit, spe, tnytol = _round_args(37, dtype)
            trials = (lambda c: (f[None] + c, dginit[None] * 0.1 + c))
            out = tncg._ls_rounds(ls, trials, f, dginit, spe, tnytol, 750,
                                  1e-4, 4, None)
            rounds[device, dtype] = (len(launched), len(plain), out["t"])
            assert set(launched + plain) == {dtype}
    f32, f64 = torch.float32, torch.float64
    for device, dtype in (("cpu", f32), ("cpu", f64), ("card", f64)):
        n_launched, n_plain, t = rounds[device, dtype]
        # a call for round 1's candidates, then one a round
        assert n_launched == 0 and n_plain == t + 1 and t >= 1, (device,
                                                                 dtype)
    # the stub launch leaves the flag at zero: one call, no round
    assert rounds["card", f32] == (1, 0, 0)


@pytest.mark.parametrize("layout", ["ell", "coo"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cpu_solves_take_the_plain_rounds(monkeypatch, layout, dtype):
    """A tncg solve on the CPU, float32 or float64, folds its rounds with
    ``_ls_fold`` and never reaches the kernel route or its counter."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel route on the CPU")

    folds = []
    fold = ls_round_mod._ls_fold
    monkeypatch.setattr(ls_round_mod, "_launch", refuse)
    monkeypatch.setattr(ls_round_mod, "_ls_fold",
                        lambda *a: folds.append(1) or fold(*a))
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, 40, 600), rng.integers(0, 30, 600)
    X = sparse.ingest((rows, cols, rng.poisson(2.0, 600) + 1.0, (40, 30)),
                      reindex=False, dtype=dtype)
    A = torch.from_numpy(rng.uniform(0.1, 0.3, (X.by_user.n_rows_pad, 4))
                         .astype(dtype))
    B = torch.from_numpy(rng.uniform(0.1, 0.3, (X.by_item.n_rows_pad, 4))
                         .astype(dtype))
    kernels.reset_launch_counts()
    if layout == "ell":
        ell = ell_ops.ell_from_counts(X.by_user)
        tncg.tncg_update_ell(ell_ops.permute_rows(A, ell.perm),
                             ell_ops.gather_planes(B, ell), ell, B.sum(0),
                             l2_reg=1e3, maxupd=40, max_outer=3)
    else:
        tncg.tncg_update(A, B, sparse.to_device(X.by_user, "cpu"), B.sum(0),
                         l2_reg=1e3, maxupd=40, max_outer=3)
    assert folds
    assert kernels.launch_counts["ls_round"] == 0


def test_ls_round_state_copies_the_state_into_the_kernels_layout():
    """The state's floats stacked in STATE_FLOATS's order, its flags and
    nfeval copied; the views read the copies, so a write through them
    leaves the solver's tensors (``f``, which ``f_lo``, ``f_new`` and
    ``f_best`` start as) as they were."""
    ls, f = _state()
    f_before = f.clone()
    (floats, flags, nfeval), view = kernels.ls_round_state(ls)
    R = f.shape[0]
    assert floats.shape == (len(STATE_FLOATS), R) and floats.is_contiguous()
    assert flags.shape == (2, R) and flags.dtype == torch.bool
    assert nfeval.dtype == torch.int32
    for i, key in enumerate(STATE_FLOATS):
        assert torch.equal(view[key], ls[key])
        assert view[key].data_ptr() == floats.data_ptr() + 4 * R * i
    assert view["found"].data_ptr() == flags.data_ptr()
    assert view["searching"].data_ptr() == flags.data_ptr() + R
    assert torch.equal(view["nfeval"], ls["nfeval"]) and view["nfeval"] is \
        nfeval
    floats.fill_(7.0)
    flags.fill_(True)
    nfeval.fill_(99)
    assert torch.equal(f, f_before) and not ls["found"].all()
    assert int(ls["nfeval"].max()) < 99


def test_ls_round_refuses_cpu_tensors():
    """The kernel's launch takes CUDA tensors only (``ls_round`` sends CPU
    state to the plain round before it)."""
    ls, f = _state()
    state, _ = kernels.ls_round_state(ls)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        ls_round_mod._launch(state, torch.zeros((4, f.shape[0])), None, f,
                             f, f, f, torch.zeros((1,), dtype=torch.int32),
                             750, 1e-4)
    assert kernels.launch_counts["ls_round"] == 0


def _bits(x):
    return x.numpy().tobytes()


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_round_on_the_buffers_is_the_plain_pair(dtype, C):
    """``kernels.ls_round`` on CPU state, from round 1's candidates through
    four rounds, against ``_ls_fold`` / ``_ls_candidates`` on the solver's
    dict: every state vector and candidate equal bit for bit, each
    round's flag set exactly when a row still searches, the solver's
    ``f`` left as it was, no kernel counted."""
    R, maxupd, ftol = 301, 12, 1e-4
    rng = np.random.default_rng(7 + C)
    ls, _ = _state(R, dtype)
    f, dginit, spe, tnytol = _round_args(R, dtype)
    lo = torch.from_numpy(np.abs(rng.standard_normal(R)) * 0.1).to(dtype)
    hi = lo + torch.from_numpy(np.abs(rng.standard_normal(R))).to(dtype)
    hi[torch.from_numpy(rng.random(R) < 0.4)] = torch.inf
    ls.update(lo=lo, hi=hi, f_lo=f, f_new=f, f_best=f,
              reltol=ls["reltol"].abs() * 1e-3,
              abstol=ls["abstol"].abs() * 1e-6)
    f_before = f.clone()
    state, view = kernels.ls_round_state(ls)
    more = torch.zeros((5,), dtype=torch.int32)
    cands = torch.empty((C, R), dtype=dtype)
    kernels.reset_launch_counts()
    kernels.ls_round(state, cands, None, f, dginit, spe, tnytol, more[0],
                     maxupd=maxupd, ftol=ftol)
    ref = ls_round_mod._ls_candidates(ls, spe, C)
    assert _bits(cands) == _bits(ref)
    assert int(more[0]) == int(ls["searching"].any())
    plain = ls
    for t in range(4):
        f_c = f[None] + torch.from_numpy(rng.standard_normal((C, R))).to(
            dtype)
        f_c[torch.from_numpy(rng.random((C, R)) < 0.05)] = torch.nan
        gu_c = torch.from_numpy(rng.standard_normal((C, R))).to(dtype)
        plain = ls_round_mod._ls_fold(plain, ref, f_c, gu_c, f, dginit,
                                      spe, tnytol, maxupd, ftol, C)
        kernels.ls_round(state, cands, (f_c, gu_c), f, dginit, spe, tnytol,
                         more[t + 1], maxupd=maxupd, ftol=ftol)
        ref = ls_round_mod._ls_candidates(plain, spe, C)
        for key in STATE_FLOATS + ("found", "searching", "nfeval"):
            assert _bits(view[key]) == _bits(plain[key]), key
        assert _bits(cands) == _bits(ref)
        assert int(more[t + 1]) == int(plain["searching"].any())
    assert torch.equal(f, f_before)
    assert kernels.launch_counts["ls_round"] == 0


def test_ls_round_on_no_rows_leaves_the_flag():
    """R = 0 (a compact round with no rows): nothing to do, the flag stays
    zero."""
    ls, _ = _state(0)
    state, _ = kernels.ls_round_state(ls)
    more = torch.zeros((1,), dtype=torch.int32)
    f = torch.zeros((0,))
    kernels.ls_round(state, torch.empty((4, 0)), None, f, f, f, f, more[0],
                     maxupd=750, ftol=1e-4)
    assert int(more[0]) == 0


def test_launch_counts_keep_their_keys_after_reset():
    keys = set(SWEEP_KERNELS) | {"ls_round", "assemble", "assemble_long"}
    assert set(kernels.launch_counts) == keys
    for name in keys:
        kernels.launch_counts[name] += 3
    kernels.reset_launch_counts()
    assert kernels.launch_counts == dict.fromkeys(keys, 0)
