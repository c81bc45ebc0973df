"""PyTorch port, the last twins: ``poismf_torch.entry`` (``entry`` and
``dryrun_multichip``, the twins of ``__graft_entry__.py``), ``predict``
streamed in chunks, and ``examples/lastfm_style_workflow_torch.py``.

Tolerances:

- ``entry(device="cpu")``'s half-update against the JAX ``entry()``'s on
  the same NumPy inputs, as ``tests/test_torch_tncg.py`` holds float32
  solves: rtol 1e-4 on all rows but one (its 99% of 152 rows leaves one
  row free: float32 sums in another order can flip one line-search
  trial of a near-flat row), rtol 1e-2 on all (measured: one row of 64
  at 7.4e-4, the others within 2.7e-6).
- ``dryrun_multichip(4, device="cpu")`` (gloo ranks) asserts its own
  bands: train LL within 1e-5 (pg), 1e-1 (cg) and 5e-2 (tncg) of a
  single-process fit, and the factors bitwise equal on every rank.
  cg's band is the JAX package's 3e-2 widened to cover the fit's own
  spread: single-process float32 cg fits of the problem from initial
  factors one ulp apart in one entry spread over more than 3e-2 of the
  LL, and within half the band (measured: 16 starts, 4.7%).
- ``predict`` with ``PREDICT_CHUNK`` = 7: bitwise the unchunked call, and
  within rtol 1e-6 of the JAX model's ``predict`` on the same factors
  (its ``PREDICT_CHUNK`` patched the same way); NaN for invalid ids.
"""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import poismf_tpu  # noqa: E402
from poismf_torch import PoisMF, entry  # noqa: E402
from poismf_torch.models import poismf as model_pt  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as graft

    fn_j, args_j = graft.entry()
    want = np.asarray(fn_j(*args_j))
    fn, args = entry.entry(device="cpu")
    # the same problem and initial factors as the JAX entry
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(args_j[0]))
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(args_j[1]))
    got = fn(*args).numpy()
    assert got.shape == want.shape == (64, 8)
    assert np.isfinite(got).all() and not np.array_equal(got, args[0].numpy())
    rows_ok = np.isclose(got, want, rtol=1e-4, atol=1e-7).all(1)
    assert (~rows_ok).sum() <= 1
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-6)


def test_dryrun_multichip_on_four_gloo_ranks():
    lls = entry.dryrun_multichip(4, device="cpu")
    assert set(lls) == {"pg", "cg", "tncg"}


def test_cg_band_covers_the_fits_own_spread():
    from poismf_torch.train import FitParams, run_poismf

    by_user, by_item, A0, B0 = entry._inputs("cpu")
    (method, kw, band), = [c for c in entry.CASES if c[0] == "cg"]
    p = FitParams(k=entry.K, method=method, l2_reg=1.0, early_stop=False,
                  **kw)
    lls = []
    for s in range(16):
        A = A0.clone()
        if s:
            g = np.random.default_rng(s)
            i, j = g.integers(0, 64), g.integers(0, entry.K)
            A[i, j] = torch.nextafter(A[i, j], torch.tensor(1.0))
        lls.append(entry._train_ll(*run_poismf(A, B0, by_user, by_item,
                                               p)[:2], by_user))
    spread = (max(lls) - min(lls)) / abs(lls[0])
    assert 3e-2 < spread <= band / 2, spread


def test_cuda_without_enough_cards_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="GPUs, found 0"):
        entry.dryrun_multichip(2, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        entry.entry(device="cuda")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A port model and the JAX package's model on the same factors
    (the port's checkpoint loaded by the JAX package)."""
    rng = np.random.default_rng(4)
    rows, cols = rng.integers(0, 40, 600), rng.integers(0, 25, 600)
    vals = rng.poisson(2.0, 600) + 1.0
    mt = PoisMF(k=4, niter=2, random_state=1, device="cpu").fit(
        (rows, cols, vals, (40, 25)))
    path = str(tmp_path_factory.mktemp("predict") / "model.npz")
    mt.save(path)
    return mt, poismf_tpu.PoisMF.load(path)


def test_predict_in_chunks(served, monkeypatch):
    from poismf_tpu.models import poismf as model_jax

    mt, mj = served
    rng = np.random.default_rng(5)
    users = rng.integers(0, 40, 53)  # 7 chunks of 7 and a ragged 4
    items = rng.integers(0, 25, 53)
    users[[3, 20, 41]] = (-1, 40, 7)  # an invalid user and item
    items[[41, 50]] = (25, -3)
    whole = mt.predict(users, items)
    monkeypatch.setattr(model_pt, "PREDICT_CHUNK", 7)
    monkeypatch.setattr(model_jax, "PREDICT_CHUNK", 7)
    chunked = mt.predict(users, items)
    assert np.isnan(chunked).sum() == 4
    np.testing.assert_array_equal(chunked.view(np.uint32),
                                  whole.view(np.uint32))
    np.testing.assert_allclose(chunked, mj.predict(users, items), rtol=1e-6)


def test_lastfm_workflow_example_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "lastfm_style_workflow_torch",
        os.path.join(ROOT, "examples", "lastfm_style_workflow_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    model = example.main(["--scale", "0.001", "--k", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert model.method == "tncg" and model.device.type == "cpu"
    for line in ("pg    fit", "cg    fit", "tncg  fit", "topN_new:",
                 "checkpoint round-trip OK"):
        assert line in out, line
