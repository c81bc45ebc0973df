"""PyTorch port, the flat-COO ops (``poismf_torch.ops.objective``) against
the JAX package's (``poismf_tpu.ops.objective``) on the same inputs: one
orientation of a 90 x 50 problem (96 padded rows, 6 of them padding;
users 10-14 without nonzeros; user 0 with every item), 2,556 nonzeros
padded to 3,072, k=5, factors and per-entry planes from a seed.  Row 3 of
the factors is zero and some ray trials cross zero, so the +inf / NaN
poisoning of the objective is held too.

Each op runs in one pass and in chunks of 1,024 (``nnz_chunk``, three
chunks through ``lax.scan`` on the JAX side), and with rows cut into
pieces of 8 entries (``sparse.SEGMENT_PIECE`` = 8: the two-level row
sums).  Tolerances: float64 (under ``jax.enable_x64``) rtol 1e-12,
float32 rtol 1e-5, each with an absolute part of rtol times the largest
finite value of the output (a row sum can cancel); identical inf / NaN
patterns.  A chunk that does not divide the padded nnz raises in both
packages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import objective as obj_jax  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.ops import objective as obj_pt  # noqa: E402

N_ROWS, N_COLS, K, C = 90, 50, 5, 3
L2 = 0.7
RTOL = {"float64": 1e-12, "float32": 1e-5}


def _triplets():
    rng = np.random.default_rng(21)
    rows, cols, vals = synth_counts(rng, N_ROWS, N_COLS, density=0.9)
    keep = ((rows < 10) | (rows > 14)) & (rows != 0)
    rows = np.concatenate([rows[keep], np.zeros(N_COLS, np.int32)])
    cols = np.concatenate([cols[keep], np.arange(N_COLS, dtype=np.int32)])
    vals = np.concatenate([vals[keep], rng.poisson(2.0, N_COLS) + 1.0])
    return rows, cols, vals


@pytest.fixture(scope="module")
def host():
    """Host arrays of both sides' inputs (float64)."""
    rows, cols, vals = _triplets()
    X = sparse_pt.build_counts(rows, cols, vals, N_ROWS, N_COLS,
                               dtype=np.float64)
    assert X.nnz_pad == 3072 and X.n_rows_pad == 96
    assert not X.row_nnz[10:15].any() and X.row_nnz[0] == N_COLS
    rng = np.random.default_rng(22)
    R, E = X.n_rows_pad, X.nnz_pad
    A = rng.uniform(0.05, 0.5, (R, K))
    A[3] = 0.0
    B = rng.uniform(0.05, 0.5, (56, K))
    D = rng.normal(0.0, 0.1, (R, K))
    valid = X.vals > 0
    return dict(
        rows=rows, cols=cols, vals=vals, A=A, B=B, D=D,
        V=rng.normal(0.0, 1.0, (R, K)),
        Bsum=B[:N_COLS].sum(0) + 0.3,
        Bsum2=B[:N_COLS].sum(0)[None, :] + rng.uniform(0.0, 0.2, (R, K)),
        bd=rng.normal(0.0, 0.2, E),
        px=rng.uniform(0.05, 1.5, E),
        w2=np.where(valid, rng.uniform(0.1, 3.0, E), 0.0),
        weights=rng.normal(0.0, 1.0, E),
        alphas=rng.uniform(0.0, 4.0, (C, R)),
        alpha=rng.uniform(0.0, 4.0, R),
    )


def _ops(m, X, a, chunk):
    """{name: thunk} calling module ``m`` (either package's objective
    module) on its COO ``X`` and arrays ``a``."""
    def coef():
        return m.ray_coef(a["A"], a["D"], a["Bsum"])

    jax_side = m is obj_jax
    seg = ((lambda v: m.segment_rowsum(v, X.row_ids, X.n_rows_pad))
           if jax_side else (lambda v: m.segment_rowsum(v, X)))
    spmm = ((lambda w: m.spmm(w, a["B"], X.row_ids, X.col_ids, X.n_rows_pad))
            if jax_side else (lambda w: m.spmm(w, a["B"], X)))
    return {
        "sddmm": lambda: m.sddmm(a["A"], a["B"], X.row_ids, X.col_ids),
        "segment_rowsum": lambda: seg(a["weights"]),
        "spmm": lambda: spmm(a["weights"]),
        "poisson_data_terms": lambda: m.poisson_data_terms(
            a["A"], a["B"], X, chunk),
        "poisson_f_data": lambda: m.poisson_f_data(a["A"], a["B"], X, chunk),
        "poisson_bdot": lambda: m.poisson_bdot(a["D"], a["B"], X),
        "poisson_f_gtd": lambda: m.poisson_f_gtd(
            a["A"], a["D"], a["bd"], a["B"], X, a["Bsum"], L2, 1.5, chunk,
            l2_in_f=False),
        "poisson_f_gtd_multi": lambda: m.poisson_f_gtd_multi(
            a["alphas"] * 0.1, a["A"], a["D"], a["bd"], a["B"], X,
            a["Bsum2"], L2, 1.0, chunk),
        "poisson_f_gtd_ray": lambda: m.poisson_f_gtd_ray(
            a["alpha"], coef(), a["px"], a["bd"], X, L2, 1.0, chunk),
        "poisson_f_ray_multi": lambda: m.poisson_f_ray_multi(
            a["alphas"], coef(), a["px"], a["bd"], X, L2, 2.0, chunk),
        "poisson_f_ray_multi_no_l2": lambda: m.poisson_f_ray_multi(
            a["alphas"], coef(), a["px"], a["bd"], X, L2, 1.0, chunk,
            l2_in_f=False),
        "poisson_f_gtd_ray_multi": lambda: m.poisson_f_gtd_ray_multi(
            a["alphas"], coef(), a["px"], a["bd"], X, L2, 1.0, chunk,
            l2_in_f=False),
        "poisson_fg": lambda: m.poisson_fg(a["A"], a["B"], X, a["Bsum"], L2,
                                           1.0, chunk),
        "poisson_fg_weighted": lambda: m.poisson_fg(
            a["A"], a["B"], X, a["Bsum2"], L2, 2.5, chunk),
        "poisson_f": lambda: m.poisson_f(a["A"], a["B"], X, a["Bsum2"], L2,
                                         1.0, chunk),
        "poisson_fgh": lambda: m.poisson_fgh(a["A"], a["B"], X, a["Bsum"],
                                             L2, 1.0, chunk, l2_in_f=False),
        "poisson_fgh_weighted": lambda: m.poisson_fgh(
            a["A"], a["B"], X, a["Bsum2"], L2, 0.5, chunk),
        "poisson_hvp_weights": lambda: m.poisson_hvp_weights(
            a["A"], a["B"], X, 1.5),
        "poisson_hvp": lambda: m.poisson_hvp(a["V"], a["B"], X, a["w2"], L2,
                                             chunk),
        "poisson_hess_diag": lambda: m.poisson_hess_diag(a["B"], X, a["w2"],
                                                         L2, chunk),
        "adjusted_bsum": lambda: m.adjusted_bsum(a["B"], a["Bsum"], X, 3.0),
    }


OPS = list(_ops(obj_pt, None, {}, None))


def _close(got, ref, rtol):
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    scale = np.abs(ref[fin]).max() if fin.any() else 0.0
    np.testing.assert_allclose(got[fin], ref[fin], rtol=rtol,
                               atol=rtol * scale)


def _both(host, dtype, chunk, name):
    """The op ``name`` in both packages, as lists of NumPy outputs."""
    np_dtype = np.dtype(dtype)
    with jax.enable_x64(dtype == "float64"):
        Xj = sparse_jax.build_counts(host["rows"], host["cols"],
                                     host["vals"], N_ROWS, N_COLS,
                                     dtype=np_dtype)
        aj = {n: jnp.asarray(v.astype(np_dtype)) for n, v in host.items()
              if n not in ("rows", "cols", "vals")}
        ref = _ops(obj_jax, Xj, aj, chunk)[name]()
        ref = [np.asarray(r) for r in
               (ref if isinstance(ref, tuple) else (ref,))]
    Xt = sparse_pt.to_device(
        sparse_pt.build_counts(host["rows"], host["cols"], host["vals"],
                               N_ROWS, N_COLS, dtype=np_dtype), "cpu")
    at = {n: torch.from_numpy(v.astype(np_dtype)) for n, v in host.items()
          if n not in ("rows", "cols", "vals")}
    got = _ops(obj_pt, Xt, at, chunk)[name]()
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    return got, ref


@pytest.mark.parametrize("chunk", [None, 1024], ids=["one-pass", "chunked"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", OPS)
def test_coo_op_matches_jax(host, name, dtype, chunk):
    got, ref = _both(host, dtype, chunk, name)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.dtype == np.dtype(dtype)
        _close(g, r, RTOL[dtype])


@pytest.mark.parametrize("name", ["poisson_fgh", "poisson_hvp",
                                  "poisson_f_gtd_ray_multi", "spmm"])
def test_coo_op_with_rows_in_pieces_matches_jax(host, name, monkeypatch):
    """Rows longer than SEGMENT_PIECE are summed in pieces, then their
    pieces: the same sums as the JAX package's sequential ones, in another
    order (float64)."""
    monkeypatch.setattr(sparse_pt, "SEGMENT_PIECE", 8)
    got, ref = _both(host, "float64", 1024, name)
    for g, r in zip(got, ref):
        _close(g, r, 1e-12)


def test_rows_in_pieces_plan(host):
    """The chunk plans: one segment a row where no row is longer than
    SEGMENT_PIECE, else pieces; padding entries outside every segment."""
    X = sparse_pt.to_device(sparse_pt.build_counts(
        host["rows"], host["cols"], host["vals"], N_ROWS, N_COLS), "cpu")
    (whole,) = X.chunks(None)
    assert (whole.start, whole.stop, whole.n_real) == (0, 3072, X.nnz)
    assert whole.row_offsets is None
    assert int(whole.piece_offsets[-1]) == X.nnz
    np.testing.assert_array_equal(np.diff(whole.piece_offsets.numpy()),
                                  X.row_nnz.numpy()[whole.r0:whole.r1])
    chunks = X.chunks(1024)
    assert [(c.start, c.stop) for c in chunks] == [
        (0, 1024), (1024, 2048), (2048, 3072)]
    assert sum(c.n_real for c in chunks) == X.nnz
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sparse_pt, "SEGMENT_PIECE", 8)
        Xp = sparse_pt.to_device(sparse_pt.build_counts(
            host["rows"], host["cols"], host["vals"], N_ROWS, N_COLS), "cpu")
        (cut,) = Xp.chunks(None)
    sizes = np.diff(cut.piece_offsets.numpy())
    assert sizes.max() == 8 and sizes.sum() == X.nnz
    np.testing.assert_array_equal(
        np.diff(cut.row_offsets.numpy()),
        -(-X.row_nnz.numpy()[cut.r0:cut.r1] // 8))


@pytest.mark.parametrize("chunk", [1000, 5000, 3072, None])
def test_chunk_rule_matches_jax(host, chunk):
    """A chunk that does not divide the padded nnz raises in both
    packages; one at or above it (or None) means one pass."""
    assert obj_pt._maybe_chunk(3072, None) is None
    if chunk == 1000:
        with pytest.raises(ValueError, match="must divide"):
            obj_jax._maybe_chunk(3072, chunk)
        with pytest.raises(ValueError, match="must divide"):
            obj_pt._maybe_chunk(3072, chunk)
        Xt = sparse_pt.to_device(sparse_pt.build_counts(
            host["rows"], host["cols"], host["vals"], N_ROWS, N_COLS), "cpu")
        with pytest.raises(ValueError, match="must divide"):
            obj_pt.poisson_fg(torch.ones(96, K), torch.ones(56, K), Xt,
                              torch.ones(K), L2, 1.0, chunk)
        return
    assert obj_pt._maybe_chunk(3072, chunk) == obj_jax._maybe_chunk(3072,
                                                                    chunk)


def test_sddmm_clamps_row_ids():
    """Row ids beyond A's rows (padding entries) read its last row, as in
    the JAX package."""
    A = np.arange(12.0).reshape(4, 3)
    B = np.arange(6.0).reshape(2, 3) + 1.0
    rows, cols = np.array([0, 3, 4, 9]), np.array([1, 0, 1, 0])
    ref = np.asarray(obj_jax.sddmm(jnp.asarray(A, jnp.float32),
                                   jnp.asarray(B, jnp.float32),
                                   jnp.asarray(rows), jnp.asarray(cols)))
    got = obj_pt.sddmm(torch.from_numpy(A).float(),
                       torch.from_numpy(B).float(), torch.from_numpy(rows),
                       torch.from_numpy(cols)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[2:], (A[3] * B[[1, 0]]).sum(1))
