"""PyTorch port, ELL ops after assembly: fgh_ell, hvp_ell, hvp_bv_ell,
bdot_ell, f_gtd_ray_multi_ell and the <B, d> accumulator algebra against
the JAX package (jnp path and Pallas interpret mode), on a layout with
long-row extension chunks and on a compact sub-ELL of the cascade.

Tolerance: rtol 1e-5, atol 1e-6 times the output's scale (float32 sums
in another order; extension chunks are scatter-added)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_tpu.ops import objective as obj_jax  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.ops import objective as obj_pt  # noqa: E402

K = 6
L2 = 50.0


def _close(port, ref, rtol=1e-5):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(port), np.isfinite(ref))
    fin = np.isfinite(ref)
    scale = max(float(np.abs(ref[fin]).max(initial=0.0)), 1.0)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=rtol,
                               atol=1e-6 * scale)


@pytest.fixture(params=["float32", "bfloat16"])
def case(request, monkeypatch):
    """Both packages' ELLs of one problem (P_MAX patched to 16, so three
    long rows split into extension chunks), planes and iterates."""
    monkeypatch.setattr(ell_jax, "P_MAX", 16)
    monkeypatch.setattr(ell_pt, "P_MAX", 16)
    rng = np.random.default_rng(21)
    rows, cols, vals = synth_counts(rng, n_users=150, n_items=60,
                                    density=0.12)
    extra = np.repeat(np.arange(3, dtype=np.int32), 40)
    rows = np.concatenate([rows, extra])
    cols = np.concatenate([cols, rng.integers(0, 60, extra.shape[0])])
    vals = np.concatenate([vals, np.full(extra.shape[0], 2.0)])
    dj = sparse_jax.ingest((rows, cols, vals, (150, 60)))
    dt = sparse_pt.ingest((rows, cols, vals, (150, 60)))
    ell_j = ell_jax.ell_from_counts(dj.by_user)
    ell_t = ell_pt.ell_from_counts(dt.by_user)
    B = rng.uniform(0.05, 0.5, (dj.by_item.n_rows_pad, K)).astype(np.float32)
    A = rng.uniform(0.05, 0.5, (ell_j.n_rows_ell, K)).astype(np.float32)
    A[np.asarray(ell_j.row_nnz_perm) == 0] = 0.0
    D = rng.standard_normal(A.shape).astype(np.float32) * 0.05
    pdt = request.param
    planes_j = ell_jax.gather_planes(
        jnp.asarray(B), ell_j, None if pdt == "float32" else jnp.bfloat16)
    planes_t = ell_pt.gather_planes(torch.from_numpy(B), ell_t,
                                    None if pdt == "float32" else pdt)
    return dict(ell_j=ell_j, ell_t=ell_t, planes_j=planes_j,
                planes_t=planes_t, A=A, D=D, B=B, pdt=pdt, rng=rng)


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_fgh_hvp_bdot_ell_match(case, mode, monkeypatch):
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    ell_j, ell_t = case["ell_j"], case["ell_t"]
    pj, pt = case["planes_j"], case["planes_t"]
    A, D = case["A"], case["D"]
    Bsum = case["B"].sum(0) + 0.1
    fj = ell_jax.fgh_ell(jnp.asarray(A), pj, ell_j, jnp.asarray(Bsum), L2,
                         l2_in_f=False)
    ft = ell_pt.fgh_ell(torch.from_numpy(A), pt, ell_t,
                        torch.from_numpy(Bsum), L2, l2_in_f=False)
    _close(ft[0], fj[0])
    _close(ft[1], fj[1])
    # jnp squares bf16 planes in bf16 (see test_torch_kernels)
    bf16_jnp = mode == "off" and case["pdt"] == "bfloat16"
    _close(ft[3], fj[3], rtol=4e-3 if bf16_jnp else 1e-5)
    for a, b in zip(ft[2] + ft[4], fj[2] + fj[4]):
        _close(a, b)

    V = case["rng"].standard_normal(A.shape).astype(np.float32)
    hj = ell_jax.hvp_ell(jnp.asarray(V), pj, ell_j, fj[2], L2)
    ht = ell_pt.hvp_ell(torch.from_numpy(V), pt, ell_t, ft[2], L2)
    _close(ht, hj)
    hbj, bvj = ell_jax.hvp_bv_ell(jnp.asarray(V), pj, ell_j, fj[2], L2)
    hbt, bvt = ell_pt.hvp_bv_ell(torch.from_numpy(V), pt, ell_t, ft[2], L2)
    _close(hbt, hbj)
    for a, b in zip(bvt, bvj):
        _close(a, b)
    for a, b in zip(ell_pt.bdot_ell(torch.from_numpy(D), pt, ell_t),
                    ell_jax.bdot_ell(jnp.asarray(D), pj, ell_j)):
        _close(a, b)


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_f_gtd_ray_multi_ell_matches(case, mode, monkeypatch):
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    ell_j, ell_t = case["ell_j"], case["ell_t"]
    A, D = case["A"], case["D"]
    Bsum = case["B"].sum(0)
    _, _, _, _, pxj = ell_jax.fgh_ell(jnp.asarray(A), case["planes_j"],
                                      ell_j, jnp.asarray(Bsum), L2)
    _, _, _, _, pxt = ell_pt.fgh_ell(torch.from_numpy(A), case["planes_t"],
                                     ell_t, torch.from_numpy(Bsum), L2)
    bdj = ell_jax.bdot_ell(jnp.asarray(D), case["planes_j"], ell_j)
    bdt = ell_pt.bdot_ell(torch.from_numpy(D), case["planes_t"], ell_t)
    cj = obj_jax.ray_coef(jnp.asarray(A), jnp.asarray(D), jnp.asarray(Bsum))
    ct = obj_pt.ray_coef(torch.from_numpy(A), torch.from_numpy(D),
                         torch.from_numpy(Bsum))
    for a, b in zip(ct, cj):
        _close(a, b)
    R = A.shape[0]
    base = case["rng"].uniform(0.5, 1.0, R).astype(np.float32)
    # the last candidates overshoot: non-positive predictions poison rows
    alphas = np.stack([s * base for s in (0.1, 1.0, 10.0, 300.0)])
    for l2_in_f in (False, True):
        fj, gj = ell_jax.f_gtd_ray_multi_ell(jnp.asarray(alphas), cj, pxj,
                                             bdj, ell_j, L2,
                                             l2_in_f=l2_in_f)
        ft, gt = ell_pt.f_gtd_ray_multi_ell(torch.from_numpy(alphas), ct,
                                            pxt, bdt, ell_t, L2,
                                            l2_in_f=l2_in_f)
        _close(ft, fj)
        _close(gt, gj)
    assert not np.isfinite(np.asarray(fj)).all()


def test_bd_algebra_bsum_and_permute_match(case):
    ell_j, ell_t = case["ell_j"], case["ell_t"]
    pj, pt = case["planes_j"], case["planes_t"]
    rng = case["rng"]
    R = case["A"].shape[0]
    V = rng.standard_normal(case["A"].shape).astype(np.float32)
    m = rng.uniform(-1, 1, R).astype(np.float32)
    flags = rng.integers(0, 2, R).astype(bool)
    bvj = ell_jax.bdot_ell(jnp.asarray(V), pj, ell_j)
    bvt = ell_pt.bdot_ell(torch.from_numpy(V), pt, ell_t)
    zj = ell_jax.bd_zeros_ell(ell_j, jnp.float32)
    zt = ell_pt.bd_zeros_ell(ell_t)
    axj = ell_jax.bd_axpy_ell(zj, jnp.asarray(m), bvj, ell_j)
    axt = ell_pt.bd_axpy_ell(zt, torch.from_numpy(m), bvt, ell_t)
    sj = ell_jax.bd_select_ell(jnp.asarray(flags), axj, bvj, ell_j)
    st = ell_pt.bd_select_ell(torch.from_numpy(flags), axt, bvt, ell_t)
    for a, b in zip(axt + st, axj + sj):
        _close(a, b)
    Bsum = case["B"].sum(0)
    _close(ell_pt.adjusted_bsum_ell(pt, ell_t, torch.from_numpy(Bsum), 2.5),
           ell_jax.adjusted_bsum_ell(pj, ell_j, jnp.asarray(Bsum), 2.5))
    M = rng.standard_normal((ell_j.n_rows_pad, K)).astype(np.float32)
    np.testing.assert_array_equal(
        ell_pt.permute_rows(torch.from_numpy(M), ell_t.perm).numpy(),
        np.asarray(ell_jax.permute_rows(jnp.asarray(M), ell_j.perm)))


def test_compact_sub_ell_matches(case):
    """A cascade round's compact layout (plan, selection, build, scatter
    back) and an fgh sweep over it, which takes the full-``src`` path."""
    ell_j, ell_t = case["ell_j"], case["ell_t"]
    rng = case["rng"]
    active = rng.random(ell_j.n_rows_ell) < 0.1
    plan_j = ell_jax.plan_compact(ell_j, 2)
    plan_t = ell_pt.plan_compact(ell_t, 2)
    assert (plan_j.caps, plan_j.offsets, plan_j.n_slots) == \
        (plan_t.caps, plan_t.offsets, plan_t.n_slots)
    row_nnz = ell_t.host["row_nnz_perm"]
    src_j = [None if b.src is None else np.asarray(b.src)
             for b in ell_j.buckets]
    sel_j = ell_jax.select_active(ell_j, plan_j, active, row_nnz, src_j)
    sel_t = ell_pt.select_active(ell_t, plan_t, active, row_nnz,
                                 ell_t.host["src"])
    assert sel_j is not None and sel_t is not None
    for a, b in zip(sel_j[0] + sel_j[1] + [sel_j[2], sel_j[3]],
                    sel_t[0] + sel_t[1] + [sel_t[2], sel_t[3]]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    cj, smj = ell_jax.build_compact(ell_j, plan_j, *sel_j[:4])
    ct = ell_pt.build_compact(ell_t, plan_t, *sel_t[:4])
    for bj, bt in zip(cj.buckets, ct.buckets):
        np.testing.assert_array_equal(np.asarray(bj.cols), bt.cols.numpy())
        np.testing.assert_array_equal(np.asarray(bj.vals), bt.vals.numpy())
    B = jnp.asarray(case["B"])
    dt = None if case["pdt"] == "float32" else jnp.bfloat16
    pj = ell_jax.gather_planes(B, cj, dt)
    pt = ell_pt.gather_planes(torch.from_numpy(case["B"]), ct,
                              None if dt is None else "bfloat16")
    x = case["A"][sel_t[2]]
    Bsum = case["B"].sum(0)
    fj = ell_jax.fgh_ell(jnp.asarray(x), pj, cj, jnp.asarray(Bsum), L2)
    ft = ell_pt.fgh_ell(torch.from_numpy(x), pt, ct, torch.from_numpy(Bsum),
                        L2)
    _close(ft[0], fj[0])
    _close(ft[1], fj[1])
    x_new = x + 1.0
    back_j = ell_jax.scatter_back(jnp.asarray(case["A"]), jnp.asarray(x_new),
                                  smj, cj.row_nnz_perm)
    back_t = ell_pt.scatter_back(torch.from_numpy(case["A"]),
                                 torch.from_numpy(x_new), ct.perm,
                                 ct.row_nnz_perm)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))
