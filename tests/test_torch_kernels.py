"""PyTorch port, per-bucket kernels: the plain PyTorch version of each
hand-written CUDA kernel against the JAX package's bucket function, on its
jnp path and on its Pallas kernel in interpret mode, with f32 and bf16
planes, including the buckets of long-row extension chunks.

Tolerance: rtol 1e-5 and atol 1e-6 times the output's scale (float32
sums taken in another order).  The inf/NaN pattern of a poisoned ray
trial must match exactly.  A CUDA kernel cannot run here; on a card,
``tests/test_torch_cuda.py`` compares each kernel with its plain
version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_tpu.sparse import build_both_orientations  # noqa: E402
from poismf_torch import kernels  # noqa: E402

K = 5


def _t(x):
    """JAX array -> torch tensor (bf16 by bit pattern)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _close(port, ref, rtol=1e-5):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref, dtype=np.float32)
    scale = max(float(np.abs(ref[np.isfinite(ref)]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(port, ref, rtol=rtol, atol=1e-6 * scale)


@pytest.fixture(params=["float32", "bfloat16"])
def buckets(request, monkeypatch):
    """(JAX bucket, JAX plane, A_T) triples of a problem whose long rows
    are split into extension chunks (P_MAX patched to 16)."""
    monkeypatch.setattr(ell_jax, "P_MAX", 16)
    rng = np.random.default_rng(11)
    rows, cols, vals = synth_counts(rng, n_users=150, n_items=60,
                                    density=0.12)
    extra = np.repeat(np.arange(3, dtype=np.int32), 40)
    rows = np.concatenate([rows, extra])
    cols = np.concatenate([cols, rng.integers(0, 60, extra.shape[0])])
    vals = np.concatenate([vals, np.full(extra.shape[0], 2.0)])
    by_user, by_item = build_both_orientations(rows, cols, vals, 150, 60)
    ell = ell_jax.ell_from_counts(by_user)
    assert any(b.ext is not None for b in ell.buckets)
    B = jnp.asarray(rng.uniform(0.05, 0.5, (by_item.n_rows_pad, K)),
                    dtype=jnp.float32)
    A = jnp.asarray(rng.uniform(0.05, 0.5, (ell.n_rows_ell, K)),
                    dtype=jnp.float32)
    dt = None if request.param == "float32" else jnp.bfloat16
    planes = ell_jax.gather_planes(B, ell, dt)
    return [(b, bg, ell_jax._bucket_x(A, b).T)
            for b, bg in zip(ell.buckets, planes)], request.param


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_fgh_plain_matches_jax(buckets, mode, monkeypatch):
    triples, pdt = buckets
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    for b, bg, A_T in triples:
        nll, grad, diag, w2, px = ell_jax._bucket_data_fgh(b, bg, A_T, 1.5)
        out = kernels.fgh_bucket(_t(bg), _t(b.vals), _t(A_T), w_mult=1.5)
        _close(out[0], nll)
        _close(out[1].t(), grad)
        # the jnp path squares a bf16 plane in bf16 (each term rounded to
        # 8 bits); the port and the TPU kernel square in f32
        diag_rtol = 4e-3 if (mode == "off" and pdt == "bfloat16") else 1e-5
        _close(out[2].t(), diag, rtol=diag_rtol)
        _close(out[3], w2)
        _close(out[4], px)
        assert kernels.fgh_bucket(_t(bg), _t(b.vals), _t(A_T),
                                  want_pred=False)[4] is None


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_hvp_plain_matches_jax(buckets, mode, monkeypatch):
    triples, _ = buckets
    rng = np.random.default_rng(12)
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    for b, bg, A_T in triples:
        _, _, _, w2, _ = ell_jax._bucket_data_fgh(b, bg, A_T, 1.0)
        V_T = jnp.asarray(rng.standard_normal(A_T.shape), dtype=jnp.float32)
        out = ell_jax._bucket_data_hvp(bg, w2, V_T)
        hv, bv = kernels.hvp_bucket(_t(bg), _t(w2), _t(V_T))
        assert bv is None
        _close(hv.t(), out)
        # the accumulating variant (hvp_bv_bucket on the TPU)
        hv2, bv2 = kernels.hvp_bucket(_t(bg), _t(w2), _t(V_T), want_bv=True)
        _close(hv2, hv.numpy())
        if mode == "interpret":
            from poismf_tpu.ops import pallas_kernels as pk

            o_ref, bv_ref = pk.hvp_bv_bucket(bg, w2, V_T, interpret=True)
            _close(hv2, o_ref)
        else:
            bv_ref = jnp.sum(bg * V_T[:, None, :], axis=0)
        _close(bv2, bv_ref)


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_raygtd_plain_matches_jax_with_poisoned_trials(buckets, mode,
                                                       monkeypatch):
    triples, _ = buckets
    rng = np.random.default_rng(13)
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    n_poisoned = 0
    for b, bg, A_T in triples:
        _, _, _, _, px = ell_jax._bucket_data_fgh(b, bg, A_T, 1.0)
        D_T = jnp.asarray(rng.standard_normal(A_T.shape), dtype=jnp.float32)
        pd = jnp.sum(bg * D_T[:, None, :], axis=0)
        # steps from harmless to far past the first non-positive prediction
        alphas = jnp.asarray(
            np.stack([s * rng.uniform(0.5, 1.0, A_T.shape[1])
                      for s in (1e-3, 1e-1, 1.0, 30.0)]), dtype=jnp.float32)
        nll, gud = ell_jax._bucket_data_raygtd_multi(b, px, pd, alphas)
        nll_t, gud_t = kernels.raygtd_multi_bucket(_t(px), _t(pd),
                                                   _t(b.vals), _t(alphas))
        nll, gud = np.asarray(nll), np.asarray(gud)
        for port, ref in ((nll_t.numpy(), nll), (gud_t.numpy(), gud)):
            np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
            np.testing.assert_array_equal(np.isposinf(port), np.isposinf(ref))
            np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
            fin = np.isfinite(ref)
            _close(port[fin], ref[fin])
        n_poisoned += int((~np.isfinite(nll)).sum())
    assert n_poisoned > 0


def test_plain_versions_keep_float64():
    rng = np.random.default_rng(14)
    bg = torch.from_numpy(rng.uniform(0.1, 1.0, (3, 4, 8)))
    vals = torch.from_numpy(rng.poisson(1.0, (4, 8)).astype(np.float64))
    a_t = torch.from_numpy(rng.uniform(0.1, 1.0, (3, 8)))
    out = kernels.fgh_bucket(bg, vals, a_t)
    assert all(o.dtype == torch.float64 for o in out)
    hv, bv = kernels.hvp_bucket(bg, out[3], a_t, want_bv=True)
    assert hv.dtype == bv.dtype == torch.float64
    nll, gud = kernels.raygtd_multi_bucket(out[4], bv, vals, a_t[:2])
    assert nll.dtype == gud.dtype == torch.float64
    # the plain path never counts as a kernel launch
    assert kernels.launch_counts == dict.fromkeys(kernels.launch_counts, 0)
