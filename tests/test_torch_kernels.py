"""PyTorch port, per-bucket kernels: the plain PyTorch version of each
hand-written CUDA kernel (fgh, hvp, raygtd, fg, rayf, pg, f, f_gtd,
f_gtd_fused, f_gtd_multi, ray) against the JAX package's bucket
function, on its jnp path and on its Pallas kernel in interpret mode,
with f32 and bf16 planes, including the buckets of long-row extension
chunks.

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


def _same_pattern(port, ref):
    """Equal inf/NaN patterns, finite entries within tolerance."""
    port, ref = port.numpy(), np.asarray(ref)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(port), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    fin = np.isfinite(ref)
    _close(port[fin], ref[fin])


def _poison(A_T):
    """Rows whose factor vector is zero (prediction 0: nll +inf) or
    negative (prediction < 0: nll NaN); the gradient stays finite."""
    A_T = np.array(A_T)
    A_T[:, 0] = 0.0
    A_T[:, 1] = -A_T[:, 1]
    return jnp.asarray(A_T)


def test_fg_plain_matches_jax_with_poisoned_rows(buckets):
    """Against the TPU kernel in interpret mode; the jnp branch (inside
    ``fg_ell``) is compared after assembly in test_torch_ell_ops."""
    from poismf_tpu.ops import pallas_kernels as pk

    triples, _ = buckets
    n_poisoned = 0
    for b, bg, A_T in triples:
        A_T = _poison(A_T)
        nll, grad, px = pk.fg_bucket(bg, b.vals, A_T, interpret=True)
        out = kernels.fg_bucket(_t(bg), _t(b.vals), _t(A_T))
        _same_pattern(out[0], nll)
        # the zero row's weights are x / eps ~ 1e30: compared apart, so
        # they do not set the others' scale
        grad = np.asarray(grad)
        _close(out[1][:, :1], grad[:, :1])
        _close(out[1][:, 1:], grad[:, 1:])
        _close(out[2], px)
        assert kernels.fg_bucket(_t(bg), _t(b.vals), _t(A_T),
                                 want_pred=False)[2] is None
        n_poisoned += int((~np.isfinite(np.asarray(nll))).sum())
    assert n_poisoned > 0


def test_pg_plain_matches_jax(buckets):
    """Against the TPU kernel in interpret mode; the jnp branch (inside
    ``pg_grad_ell``) is compared after assembly in test_torch_ell_ops."""
    from poismf_tpu.ops import pallas_kernels as pk

    triples, _ = buckets
    for b, bg, A_T in triples:
        ref = pk.pg_bucket(bg, b.vals, A_T, interpret=True)
        _close(kernels.pg_bucket(_t(bg), _t(b.vals), _t(A_T)), ref)


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_rayf_plain_matches_jax_with_poisoned_trials(buckets, mode,
                                                     monkeypatch):
    triples, _ = buckets
    rng = np.random.default_rng(15)
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
        nll = ell_jax._bucket_data_ray_multi(b, px, pd, alphas)
        out = kernels.rayf_multi_bucket(_t(px), _t(pd), _t(b.vals),
                                        _t(alphas))
        _same_pattern(out, nll)
        n_poisoned += int((~np.isfinite(np.asarray(nll))).sum())
    assert n_poisoned > 0


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_f_plain_matches_jax_with_poisoned_rows(buckets, mode, monkeypatch):
    triples, _ = buckets
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    n_poisoned = 0
    for b, bg, A_T in triples:
        A_T = _poison(A_T)
        nll = ell_jax._bucket_data_f(b, bg, A_T)
        _same_pattern(kernels.f_bucket(_t(bg), _t(b.vals), _t(A_T)), nll)
        n_poisoned += int((~np.isfinite(np.asarray(nll))).sum())
    assert n_poisoned > 0


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_f_gtd_plain_matches_jax_with_poisoned_rows(buckets, mode,
                                                    monkeypatch):
    """Both variants: the hoisted bd plane and <B, d> from the same plane
    read.  The poisoned rows' ratios are x / eps ~ 1e30: compared apart."""
    triples, _ = buckets
    rng = np.random.default_rng(16)
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    n_poisoned = 0
    for b, bg, A_T in triples:
        A_T = _poison(A_T)
        D_T = jnp.asarray(rng.standard_normal(A_T.shape), dtype=jnp.float32)
        bd = jnp.sum(bg * D_T[:, None, :], axis=0)
        for ref, out in (
                (ell_jax._bucket_data_f_gtd(b, bg, A_T, bd),
                 kernels.f_gtd_bucket(_t(bg), _t(b.vals), _t(A_T), _t(bd))),
                (ell_jax._bucket_data_f_gtd_fused(b, bg, A_T, D_T),
                 kernels.f_gtd_fused_bucket(_t(bg), _t(b.vals), _t(A_T),
                                            _t(D_T)))):
            _same_pattern(out[0], ref[0])
            gud = np.asarray(ref[1])
            _close(out[1][:2], gud[:2])
            _close(out[1][2:], gud[2:])
        n_poisoned += int((~np.isfinite(np.asarray(ref[0]))).sum())
    assert n_poisoned > 0


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "data_only"])
def test_f_gtd_multi_plain_matches_the_tpu_kernel(buckets, fold):
    """Against ``f_gtd_multi_bucket`` in interpret mode at C = 3 with a
    per-row Bsum, both ``l2_in_f``: ``fold_linear`` there is a per-row
    mask of all rows (True) or none (False) here.  The last candidate
    projects the first rows' trials to zero (f = +inf)."""
    from poismf_tpu.ops import pallas_kernels as pk

    triples, _ = buckets
    rng = np.random.default_rng(17)
    for b, bg, X_T in triples:
        X = np.array(X_T)
        D = rng.standard_normal(X.shape).astype(np.float32) * 0.1
        D[:, :3] = -2.0 * X[:, :3]
        R = X.shape[1]
        al = np.stack([s * rng.uniform(0.5, 1.0, R)
                       for s in (0.1, 0.4, 2.0)]).astype(np.float32)
        bsum = rng.uniform(1.0, 3.0, X.shape).astype(np.float32)
        mask = None if fold else torch.zeros(R, dtype=torch.bool)
        for l2_in_f in (True, False):
            ref = pk.f_gtd_multi_bucket(
                bg, b.vals, jnp.asarray(X), jnp.asarray(D), jnp.asarray(al),
                jnp.asarray(bsum), 7.0, w_mult=1.5, l2_in_f=l2_in_f,
                fold_linear=fold, interpret=True)
            out = kernels.f_gtd_multi_bucket(
                _t(bg), _t(b.vals), torch.from_numpy(X), torch.from_numpy(D),
                torch.from_numpy(al), torch.from_numpy(bsum), 7.0, 1.5,
                l2_in_f, mask)
            for o, r in zip(out, ref):
                r = np.asarray(r)
                _same_pattern(o[:, 3:], r[:, 3:])
                _same_pattern(o[:, :3], r[:, :3])
            assert np.isposinf(out[0][2, :3].numpy()).all()
        # a [k] Bsum broadcasts like the [k, R] one with equal columns
        col = bsum[:, :1]
        ref = kernels.f_gtd_multi_bucket(
            _t(bg), _t(b.vals), torch.from_numpy(X), torch.from_numpy(D),
            torch.from_numpy(al), torch.from_numpy(np.repeat(col, R, 1)),
            7.0, 1.5, True, mask)
        out = kernels.f_gtd_multi_bucket(
            _t(bg), _t(b.vals), torch.from_numpy(X), torch.from_numpy(D),
            torch.from_numpy(al), torch.from_numpy(col[:, 0].copy()), 7.0,
            1.5, True, mask)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), r.numpy())


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_ray_plain_matches_jax_with_poisoned_trials(buckets, mode,
                                                    monkeypatch):
    triples, _ = buckets
    rng = np.random.default_rng(18)
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    n_poisoned = 0
    for b, bg, A_T in triples:
        _, _, _, _, px = ell_jax._bucket_data_fgh(b, bg, A_T, 1.0)
        D_T = jnp.asarray(rng.standard_normal(A_T.shape), dtype=jnp.float32)
        pd = jnp.sum(bg * D_T[:, None, :], axis=0)
        # one step a row, every third far past its first non-positive
        # prediction
        a = rng.uniform(0.5, 1.0, (1, A_T.shape[1])).astype(np.float32)
        a[:, ::3] *= 30.0
        nll, gud = ell_jax._bucket_data_ray(b, px, pd, jnp.asarray(a))
        out = kernels.ray_bucket(_t(px), _t(pd), _t(b.vals),
                                 torch.from_numpy(a))
        _same_pattern(out[0], nll)
        _same_pattern(out[1], gud)
        n_poisoned += int((~np.isfinite(np.asarray(nll))).sum())
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
    assert all(o.dtype == torch.float64
               for o in kernels.fg_bucket(bg, vals, a_t))
    assert kernels.pg_bucket(bg, vals, a_t).dtype == torch.float64
    assert kernels.rayf_multi_bucket(out[4], bv, vals, a_t[:2]).dtype \
        == torch.float64
    # the plain path never counts as a kernel launch
    assert kernels.launch_counts == dict.fromkeys(kernels.launch_counts, 0)
