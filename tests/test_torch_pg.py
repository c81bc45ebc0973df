"""PyTorch port, PG solver: ``pg_update_ell`` and one alternating
``pg_epoch_ell`` (the between-halves step halving with the stale
proximal divisor included) against the JAX package's on the same inputs,
with f32 and bf16 planes, on layouts with long-row extension chunks, at
the published pg configuration's l2 and step and at a milder one that
moves the factors further; and that the published fit's train LL moves
with its data term by more than the band ``chip_smoke.py`` holds it to.

Tolerance: rtol 1e-5, atol 1e-6 times the output's scale (float32 sums
taken in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_tpu.solvers import pg as pg_jax  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.solvers import pg as pg_pt  # noqa: E402

K = 10
CONFIGS = [dict(l2_reg=1e9, step_size=1e-7, maxupd=1),  # bench.py:65-66
           dict(l2_reg=5.0, step_size=2e-3, maxupd=3)]


def _close(port, ref, rtol=1e-5):
    port, ref = port.numpy(), np.asarray(ref)
    assert np.isfinite(ref).all()
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=1e-6 * scale)


@pytest.fixture(params=[None, "bfloat16"], ids=["f32", "bf16"])
def case(request, monkeypatch):
    monkeypatch.setattr(ell_jax, "P_MAX", 16)
    monkeypatch.setattr(ell_pt, "P_MAX", 16)
    rng = np.random.default_rng(51)
    rows, cols, vals = synth_counts(rng, n_users=150, n_items=60,
                                    density=0.12)
    extra = np.repeat(np.arange(3, dtype=np.int32), 40)
    rows = np.concatenate([rows, extra])
    cols = np.concatenate([cols, rng.integers(0, 60, extra.shape[0])])
    vals = np.concatenate([vals, np.full(extra.shape[0], 2.0)])
    X = (rows, cols, vals, (150, 60))
    dj, dt = sparse_jax.ingest(X), sparse_pt.ingest(X)
    ell_j = ell_jax.ell_pair_from_counts(dj.by_user, dj.by_item)
    ell_t = ell_pt.ell_pair_from_counts(dt.by_user, dt.by_item)
    assert any(b.ext is not None for b in ell_t[0].buckets)
    A = rng.uniform(0.05, 0.5, (ell_t[0].n_rows_ell, K)).astype(np.float32)
    B = rng.uniform(0.05, 0.5, (ell_t[1].n_rows_ell, K)).astype(np.float32)
    A[ell_t[0].host["row_nnz_perm"] == 0] = 0.0
    B[ell_t[1].host["row_nnz_perm"] == 0] = 0.0
    return dict(ell_j=ell_j, ell_t=ell_t, A=A, B=B, pdt=request.param)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["published", "mild"])
@pytest.mark.parametrize("div_step,w_mult", [(None, 1.0), (3e-2, 1.5)])
def test_pg_update_ell_matches_jax(case, cfg, div_step, w_mult):
    (ell_uj, _), (ell_ut, _) = case["ell_j"], case["ell_t"]
    A, B, pdt = case["A"], case["B"], case["pdt"]
    Bsum = B.sum(0) + np.float32(0.1)
    pj = ell_jax.gather_planes(jnp.asarray(B), ell_uj,
                               None if pdt is None else jnp.bfloat16)
    pt = ell_pt.gather_planes(torch.from_numpy(B), ell_ut, pdt)
    xj = pg_jax.pg_update_ell(
        jnp.asarray(A), pj, ell_uj, jnp.asarray(Bsum),
        jnp.asarray(cfg["l2_reg"], jnp.float32),
        jnp.asarray(cfg["step_size"], jnp.float32), w_mult=w_mult,
        maxupd=cfg["maxupd"],
        div_step=None if div_step is None else jnp.asarray(div_step,
                                                           jnp.float32))
    xt = pg_pt.pg_update_ell(
        torch.from_numpy(A), pt, ell_ut, torch.from_numpy(Bsum),
        cfg["l2_reg"], cfg["step_size"], w_mult=w_mult, maxupd=cfg["maxupd"],
        div_step=div_step)
    assert (xt.numpy() != A).any()
    _close(xt, xj)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["published", "mild"])
def test_pg_epoch_matches_jax(case, cfg):
    """Both halves of one epoch: B at the step s, then A at s/2 with the
    proximal divisor of s (poismf.c:511, :532)."""
    (ell_uj, ell_ij), (ell_ut, ell_it) = case["ell_j"], case["ell_t"]
    pdt = case["pdt"]
    Aj, Bj = pg_jax.pg_epoch_ell(
        jnp.asarray(case["A"]), jnp.asarray(case["B"]), ell_uj, ell_ij,
        jnp.asarray(cfg["l2_reg"], jnp.float32),
        jnp.asarray(cfg["step_size"], jnp.float32),
        jnp.asarray(0.2, jnp.float32), maxupd=cfg["maxupd"],
        dtype_name=pdt)
    At, Bt = pg_pt.pg_epoch_ell(
        torch.from_numpy(case["A"]), torch.from_numpy(case["B"]), ell_ut,
        ell_it, cfg["l2_reg"], cfg["step_size"], 0.2, maxupd=cfg["maxupd"],
        plane_dtype=ell_pt.torch_dtype(pdt))
    _close(Bt, Bj)
    _close(At, Aj)
    # the A half used the halved step with the stale divisor: a plain
    # update at s/2 with its own divisor lands elsewhere
    planes = ell_pt.gather_planes(Bt, ell_ut, ell_pt.torch_dtype(pdt))
    fresh = pg_pt.pg_update_ell(
        torch.from_numpy(case["A"]), planes, ell_ut, Bt.sum(0) + 0.2,
        cfg["l2_reg"], cfg["step_size"] * 0.5, maxupd=cfg["maxupd"])
    assert not torch.allclose(fresh, At, rtol=1e-4)


@pytest.mark.parametrize("factor", [1.01, 0.99])
def test_published_pg_fit_ll_reads_its_data_term(monkeypatch, factor):
    """``chip_smoke.py`` holds the card's full-scale pg fit to the same
    fit on the CPU within 1e-4 of the train LL.  At the published l2=1e9
    the objective is almost all penalty; the band must still catch a
    kernel whose data term is off by 1%."""
    from poismf_torch import PoisMF
    from poismf_torch.kernels import pg as pg_kernel
    from poismf_torch.utils.data import synth_lastfm_like

    rows, cols, vals = synth_lastfm_like(np.random.default_rng(0), 3000,
                                         1500, 60_000)
    X = (rows, cols, vals, (3000, 1500))
    kw = dict(k=K, method="pg", l2_reg=1e9, maxupd=1, niter=10,
              plane_dtype="bfloat16", random_state=0, device="cpu")
    ll = PoisMF(**kw).fit(X).eval_llk(include_missing=True)
    plain = pg_kernel.pg_bucket_torch
    monkeypatch.setattr(pg_kernel, "pg_bucket_torch",
                        lambda bg, vals, a_t: plain(bg, vals, a_t) * factor)
    ll_off = PoisMF(**kw).fit(X).eval_llk(include_missing=True)
    assert np.isfinite(ll) and abs(ll_off - ll) / abs(ll) > 1e-4
