"""PyTorch port, the line-search evaluators of ``ops/ell``: ``f_ell``,
``f_gtd_ell``, ``f_gtd_fused_ell``, ``f_gtd_ray_ell`` and
``f_gtd_multi_ell``, with ``objective.combine_f_gtd``, against the JAX
package on the same inputs: its jnp path and its Pallas kernels in
interpret mode, f32 and bf16 planes, a layout with long-row extension
chunks (P_MAX patched to 16, every bucket mixed) and the default layout,
``l2_in_f`` True and False, ``w_mult`` 1 and 2.

``f_gtd_multi_ell`` follows the JAX jnp fallback, which folds the linear
terms into every true row.  The JAX kernel path drops them on the primary
rows of buckets that also hold extension chunks; the port does not share
that fault, and ``test_reference_kernel_path_drops_mixed_bucket_linear_terms``
pins it.

Tolerance: rtol 1e-5, atol 1e-6 times the output's scale (float32 sums
in another order), the same inf/NaN pattern.  Rows poisoned on purpose
(a zero or negative factor vector, a trial projected to zero) carry
ratios of order x / 1e-30 and are compared apart, so they do not set the
others' scale."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tests.conftest import synth_counts  # noqa: E402
from tests.test_torch_ell_ops import K, L2, case  # noqa: E402,F401
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_tpu.ops import objective as obj_jax  # noqa: E402
from poismf_torch import kernels  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.ops import objective as obj_pt  # noqa: E402

# (w_mult, l2_in_f) pairs every evaluator runs with
COMBOS = ((1.0, True), (2.0, False))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(port, ref, rows=None):
    """Same NaN / +inf / -inf pattern; finite entries within rtol 1e-5,
    atol 1e-6 x scale.  ``rows`` (bool over the last axis) splits the
    comparison into those rows and the rest, each with its own scale."""
    port, ref = _np(port), _np(ref)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(port), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(port), np.isneginf(ref))
    parts = [np.ones(ref.shape[-1], bool)] if rows is None else [rows, ~rows]
    for sel in parts:
        p, r = port[..., sel], ref[..., sel]
        fin = np.isfinite(r)
        scale = max(float(np.abs(r[fin]).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(p[fin], r[fin], rtol=1e-5,
                                   atol=1e-6 * scale)


def _bsums(case):
    """The shared [k] Bsum, and a per-row [n_rows_ell, k] one."""
    Bsum = case["B"].sum(0) + 0.1
    per_row = Bsum[None] * np.random.default_rng(5).uniform(
        0.5, 1.5, case["A"].shape).astype(np.float32)
    return Bsum, per_row


def _poisoned(case):
    """A copy of A with four true rows zeroed (prediction 0: f = +inf) and
    two negated (prediction < 0: f = NaN), and the mask of those rows."""
    A = case["A"].copy()
    true_rows = np.nonzero(np.asarray(case["ell_j"].row_nnz_perm) > 0)[0]
    A[true_rows[:4]] = 0.0
    A[true_rows[4:6]] *= -1.0
    mask = np.zeros(A.shape[0], bool)
    mask[true_rows[:6]] = True
    return A, mask


@pytest.mark.parametrize("per_row", [False, True], ids=["bsum_k", "bsum_rows"])
def test_combine_f_gtd_matches(case, per_row):
    rng = case["rng"]
    A, D = case["A"], case["D"]
    Bsum = _bsums(case)[per_row]
    R = A.shape[0]
    nll = rng.standard_normal(R).astype(np.float32)
    gud = rng.standard_normal(R).astype(np.float32)
    for w_mult, l2_in_f in COMBOS:
        ref = obj_jax.combine_f_gtd(jnp.asarray(nll), jnp.asarray(gud),
                                    jnp.asarray(A), jnp.asarray(D),
                                    jnp.asarray(Bsum), L2, w_mult, l2_in_f)
        out = obj_pt.combine_f_gtd(torch.from_numpy(nll),
                                   torch.from_numpy(gud), torch.from_numpy(A),
                                   torch.from_numpy(D), torch.from_numpy(Bsum),
                                   L2, w_mult, l2_in_f)
        _close(out[0], ref[0])
        _close(out[1], ref[1])


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_f_ell_matches(case, mode, monkeypatch):
    """Objective only, unfloored log: zeroed rows give +inf, negated rows
    NaN; w_mult applied after assembly; both Bsum shapes."""
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    A, poisoned = _poisoned(case)
    for Bsum in _bsums(case):
        for w_mult, l2_in_f in COMBOS:
            ref = ell_jax.f_ell(jnp.asarray(A), case["planes_j"],
                                case["ell_j"], jnp.asarray(Bsum), L2, w_mult,
                                l2_in_f)
            out = ell_pt.f_ell(torch.from_numpy(A), case["planes_t"],
                               case["ell_t"], torch.from_numpy(Bsum), L2,
                               w_mult, l2_in_f)
            _close(out, ref)
    assert np.isposinf(np.asarray(ref)).any() and np.isnan(
        np.asarray(ref)).any()


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_f_gtd_and_fused_ell_match(case, mode, monkeypatch):
    """(f, g.d) at a trial with the hoisted bdot planes and with <B, d>
    from the same plane read; the two ports also agree with each other."""
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    A, poisoned = _poisoned(case)
    D = case["D"]
    trial = np.where(poisoned[:, None], A, np.maximum(A + 0.5 * D, 0.0))
    tj, dj, tt, dt = (jnp.asarray(trial), jnp.asarray(D),
                      torch.from_numpy(trial), torch.from_numpy(D))
    bdj = ell_jax.bdot_ell(dj, case["planes_j"], case["ell_j"])
    bdt = ell_pt.bdot_ell(dt, case["planes_t"], case["ell_t"])
    Bsum = _bsums(case)[0]
    for w_mult, l2_in_f in COMBOS:
        args = (L2, w_mult, l2_in_f)
        ref = ell_jax.f_gtd_ell(tj, dj, bdj, case["planes_j"], case["ell_j"],
                                jnp.asarray(Bsum), *args)
        out = ell_pt.f_gtd_ell(tt, dt, bdt, case["planes_t"], case["ell_t"],
                               torch.from_numpy(Bsum), *args)
        ref_f = ell_jax.f_gtd_fused_ell(tj, dj, case["planes_j"],
                                        case["ell_j"], jnp.asarray(Bsum),
                                        *args)
        out_f = ell_pt.f_gtd_fused_ell(tt, dt, case["planes_t"],
                                       case["ell_t"], torch.from_numpy(Bsum),
                                       *args)
        for o, r in zip(out + out_f, ref + ref_f):
            _close(o, r, rows=poisoned)
        for o, r in zip(out_f, out):
            _close(o, r, rows=poisoned)
    assert not np.isfinite(np.asarray(ref[0])).all()


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_f_gtd_ray_ell_matches(case, mode, monkeypatch):
    """The single-candidate ray from cached px / pd planes: equal to the
    JAX package, and to the port's multi-candidate ray at C = 1; steps
    far past the first non-positive prediction poison their rows."""
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    A, D = case["A"], case["D"]
    Bsum = _bsums(case)[0]
    pj, pt = case["planes_j"], case["planes_t"]
    pxj = ell_jax.fgh_ell(jnp.asarray(A), pj, case["ell_j"],
                          jnp.asarray(Bsum), L2)[4]
    pxt = ell_pt.fgh_ell(torch.from_numpy(A), pt, case["ell_t"],
                         torch.from_numpy(Bsum), L2)[4]
    bdj = ell_jax.bdot_ell(jnp.asarray(D), pj, case["ell_j"])
    bdt = ell_pt.bdot_ell(torch.from_numpy(D), pt, case["ell_t"])
    cj = obj_jax.ray_coef(jnp.asarray(A), jnp.asarray(D), jnp.asarray(Bsum))
    ct = obj_pt.ray_coef(torch.from_numpy(A), torch.from_numpy(D),
                         torch.from_numpy(Bsum))
    R = A.shape[0]
    alpha = case["rng"].uniform(0.5, 1.0, R).astype(np.float32)
    alpha[::3] *= 300.0
    for w_mult, l2_in_f in COMBOS:
        ref = ell_jax.f_gtd_ray_ell(jnp.asarray(alpha), cj, pxj, bdj,
                                    case["ell_j"], L2, w_mult, l2_in_f)
        out = ell_pt.f_gtd_ray_ell(torch.from_numpy(alpha), ct, pxt, bdt,
                                   case["ell_t"], L2, w_mult, l2_in_f)
        multi = ell_pt.f_gtd_ray_multi_ell(torch.from_numpy(alpha[None]), ct,
                                           pxt, bdt, case["ell_t"], L2,
                                           w_mult, l2_in_f)
        far = ~np.isfinite(np.asarray(ref[0]))
        for o, r, m in zip(out, ref, multi):
            _close(o, r, rows=far)
            np.testing.assert_array_equal(o.numpy(), m[0].numpy())
    assert far.any()


def _multi_inputs(case):
    """Steps (C = 4, the last far out) and a direction that projects four
    true rows' trials to zero from the second candidate on (f = +inf)."""
    A, D = case["A"], case["D"].copy()
    true_rows = np.nonzero(np.asarray(case["ell_j"].row_nnz_perm) > 0)[0]
    D[true_rows[:4]] = -2.0 * A[true_rows[:4]]
    poisoned = np.zeros(A.shape[0], bool)
    poisoned[true_rows[:4]] = True
    base = case["rng"].uniform(0.5, 1.0, A.shape[0]).astype(np.float32)
    alphas = np.stack([s * base for s in (0.1, 1.0, 2.0, 30.0)])
    return A, D, alphas, poisoned


def test_f_gtd_multi_ell_matches_jnp_on_every_true_row(case, monkeypatch):
    """Every bucket of this layout holds extension chunks: each true row
    is a primary row of a mixed bucket or a long row's sum, and each must
    equal the JAX jnp path, and the port's fused evaluation at the
    projected trial."""
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", "off")
    assert all(b.src is not None for b in case["ell_t"].buckets)
    A, D, alphas, poisoned = _multi_inputs(case)
    true_rows = np.asarray(case["ell_j"].row_nnz_perm) > 0
    for Bsum in _bsums(case):
        for w_mult, l2_in_f in COMBOS:
            args = (L2, w_mult, l2_in_f)
            ref = ell_jax.f_gtd_multi_ell(
                jnp.asarray(alphas), jnp.asarray(A), jnp.asarray(D),
                case["planes_j"], case["ell_j"], jnp.asarray(Bsum), *args)
            out = ell_pt.f_gtd_multi_ell(
                torch.from_numpy(alphas), torch.from_numpy(A),
                torch.from_numpy(D), case["planes_t"], case["ell_t"],
                torch.from_numpy(Bsum), *args)
            for o, r in zip(out, ref):
                _close(o[:, true_rows], np.asarray(r)[:, true_rows],
                       rows=poisoned[true_rows])
            for c in range(alphas.shape[0]):
                trial = np.maximum(A + alphas[c][:, None] * D, 0.0)
                fused = ell_pt.f_gtd_fused_ell(
                    torch.from_numpy(trial), torch.from_numpy(D),
                    case["planes_t"], case["ell_t"], torch.from_numpy(Bsum),
                    *args)
                for o, r in zip(out, fused):
                    _close(o[c, true_rows], r[true_rows],
                           rows=poisoned[true_rows])
    assert np.isposinf(out[0][1:, poisoned].numpy()).all()


@pytest.fixture(params=["float32", "bfloat16"])
def plain_case(request):
    """Both packages' ELLs at the default P_MAX: no extension chunks, so
    every bucket is pure-primary and the JAX kernel path folds every
    row."""
    rng = np.random.default_rng(31)
    rows, cols, vals = synth_counts(rng, n_users=160, n_items=60,
                                    density=0.12)
    dj = sparse_jax.ingest((rows, cols, vals, (160, 60)))
    dt = sparse_pt.ingest((rows, cols, vals, (160, 60)))
    ell_j = ell_jax.ell_from_counts(dj.by_user)
    ell_t = ell_pt.ell_from_counts(dt.by_user)
    assert all(b.src is None for b in ell_t.buckets)
    B = rng.uniform(0.05, 0.5, (dj.by_item.n_rows_pad, K)).astype(np.float32)
    A = rng.uniform(0.05, 0.5, (ell_j.n_rows_ell, K)).astype(np.float32)
    A[np.asarray(ell_j.row_nnz_perm) == 0] = 0.0
    D = rng.standard_normal(A.shape).astype(np.float32) * 0.05
    pdt = None if request.param == "float32" else "bfloat16"
    return dict(ell_j=ell_j, ell_t=ell_t, A=A, D=D, B=B, rng=rng,
                planes_j=ell_jax.gather_planes(
                    jnp.asarray(B), ell_j, pdt and jnp.bfloat16),
                planes_t=ell_pt.gather_planes(torch.from_numpy(B), ell_t,
                                              pdt))


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_f_gtd_multi_ell_matches_both_jax_paths_without_extension_chunks(
        plain_case, mode, monkeypatch):
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", mode)
    A, D, alphas, poisoned = _multi_inputs(plain_case)
    true_rows = np.asarray(plain_case["ell_j"].row_nnz_perm) > 0
    for Bsum in _bsums(plain_case):
        for w_mult, l2_in_f in COMBOS:
            args = (L2, w_mult, l2_in_f)
            ref = ell_jax.f_gtd_multi_ell(
                jnp.asarray(alphas), jnp.asarray(A), jnp.asarray(D),
                plain_case["planes_j"], plain_case["ell_j"],
                jnp.asarray(Bsum), *args)
            out = ell_pt.f_gtd_multi_ell(
                torch.from_numpy(alphas), torch.from_numpy(A),
                torch.from_numpy(D), plain_case["planes_t"],
                plain_case["ell_t"], torch.from_numpy(Bsum), *args)
            for o, r in zip(out, ref):
                _close(o[:, true_rows], np.asarray(r)[:, true_rows],
                       rows=poisoned[true_rows])


def test_reference_kernel_path_drops_mixed_bucket_linear_terms(case,
                                                               monkeypatch):
    """The JAX kernel path of ``f_gtd_multi_ell`` folds the linear terms
    only in buckets without extension chunks (``fold_linear=b.src is
    None``), so the primary rows of a mixed bucket lack them.  On those
    rows, JAX's interpret result plus the per-row linear terms equals the
    port, and without them it does not: this fails if either side
    changes."""
    monkeypatch.setattr(ell_jax, "_PALLAS_MODE", "interpret")
    A, D = case["A"], case["D"]
    base = case["rng"].uniform(0.5, 1.0, A.shape[0]).astype(np.float32)
    alphas = np.stack([s * base for s in (0.1, 0.5, 1.0)])
    Bsum = _bsums(case)[0]
    true_rows = np.asarray(case["ell_j"].row_nnz_perm) > 0
    mixed_primary = np.zeros(A.shape[0], bool)
    for b in case["ell_j"].buckets:
        if b.src is not None:
            own = np.asarray(b.src) == b.offset + np.arange(b.n_rows)
            mixed_primary[b.offset:b.offset + b.n_rows] |= own
    rows = mixed_primary & true_rows
    assert rows.sum() > 50
    for w_mult, l2_in_f in COMBOS:
        args = (L2, w_mult, l2_in_f)
        fj, gj = (np.asarray(x) for x in ell_jax.f_gtd_multi_ell(
            jnp.asarray(alphas), jnp.asarray(A), jnp.asarray(D),
            case["planes_j"], case["ell_j"], jnp.asarray(Bsum), *args))
        ft, gt = ell_pt.f_gtd_multi_ell(
            torch.from_numpy(alphas), torch.from_numpy(A),
            torch.from_numpy(D), case["planes_t"], case["ell_t"],
            torch.from_numpy(Bsum), *args)
        trial = np.maximum(A[None] + alphas[:, :, None] * D[None], 0.0)
        lin = (trial * Bsum).sum(-1)
        if l2_in_f:
            lin = lin + L2 * (trial * trial).sum(-1)
        g0 = (D @ Bsum)[None] + 2.0 * L2 * (trial * D[None]).sum(-1)
        _close(ft[:, rows], (fj + lin)[:, rows])
        _close(gt[:, rows], (gj + g0)[:, rows])
        assert (np.abs(ft[:, rows].numpy() - fj[:, rows])
                > 1e-3 * np.abs(lin[:, rows])).all()


def test_line_search_ops_keep_float64(case):
    """float64 on the CPU runs the plain versions in float64 and launches
    nothing."""
    A, D = case["A"].astype(np.float64), case["D"].astype(np.float64)
    ell = case["ell_t"]
    planes = ell_pt.gather_planes(torch.from_numpy(case["B"]).double(), ell)
    Bsum = torch.from_numpy(case["B"].sum(0)).double()
    a, d = torch.from_numpy(A), torch.from_numpy(D)
    kernels.reset_launch_counts()
    outs = [ell_pt.f_ell(a, planes, ell, Bsum, L2)]
    bds = ell_pt.bdot_ell(d, planes, ell)
    outs += ell_pt.f_gtd_ell(a, d, bds, planes, ell, Bsum, L2)
    outs += ell_pt.f_gtd_fused_ell(a, d, planes, ell, Bsum, L2)
    alphas = torch.full((2, A.shape[0]), 0.5, dtype=torch.float64)
    outs += ell_pt.f_gtd_multi_ell(alphas, a, d, planes, ell, Bsum, L2)
    pxs = ell_pt.fg_ell(a, planes, ell, Bsum, L2)[2]
    coef = obj_pt.ray_coef(a, d, Bsum)
    outs += ell_pt.f_gtd_ray_ell(alphas[0], coef, pxs, bds, ell, L2)
    assert all(o.dtype == torch.float64 for o in outs)
    assert kernels.launch_counts == dict.fromkeys(kernels.launch_counts, 0)
