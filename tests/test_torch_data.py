"""PyTorch port, data layer: ingestion, the planar-ELL build and the plane
gather against the JAX package (exact), and the port's independence from
JAX."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from tests.conftest import synth_counts  # noqa: E402
from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.native import host as host_pt  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _problem(seed=1, n_u=150, n_i=60, long_rows=0):
    rng = np.random.default_rng(seed)
    rows, cols, vals = synth_counts(rng, n_users=n_u, n_items=n_i,
                                    density=0.12)
    if long_rows:
        # rows past P_MAX (patched small) make extension chunks
        extra_r = np.repeat(np.arange(long_rows, dtype=np.int32), 40)
        extra_c = rng.integers(0, n_i, extra_r.shape[0]).astype(np.int32)
        rows = np.concatenate([rows, extra_r])
        cols = np.concatenate([cols, extra_c])
        vals = np.concatenate([vals, np.ones(extra_r.shape[0])])
    return rows, cols, vals, n_u, n_i


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_counts_equal(cj, ct):
    for name in ("row_ids", "col_ids", "vals", "row_nnz"):
        np.testing.assert_array_equal(np.asarray(getattr(cj, name)),
                                      getattr(ct, name))
    assert (cj.n_rows, cj.n_cols, cj.nnz) == (ct.n_rows, ct.n_cols, ct.nnz)


def test_ingest_and_build_counts_match():
    rows, cols, vals, n_u, n_i = _problem()
    # duplicated pairs are summed by both
    rows = np.concatenate([rows, rows[:20]])
    cols = np.concatenate([cols, cols[:20]])
    vals = np.concatenate([vals, vals[:20]])
    dj = sparse_jax.ingest((rows, cols, vals, (n_u, n_i)))
    dt = sparse_pt.ingest((rows, cols, vals, (n_u, n_i)))
    _assert_counts_equal(dj.by_user, dt.by_user)
    _assert_counts_equal(dj.by_item, dt.by_item)
    cj = sparse_jax.build_counts(rows, cols, vals, n_u, n_i, to_device=False)
    ct = sparse_pt.build_counts(rows, cols, vals, n_u, n_i)
    _assert_counts_equal(cj, ct)
    for a, b in zip(sparse_jax.csr_like(cj), sparse_pt.csr_like(ct)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_native_sort_matches_numpy():
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 50, 2000).astype(np.int32)
    cols = rng.integers(0, 30, 2000).astype(np.int32)
    vals = rng.random(2000).astype(np.float32)
    out = host_pt.sort_by_row(rows, cols, vals, 50)
    assert out is not None, "g++ build of the host library failed"
    order = np.argsort(rows, kind="stable")
    np.testing.assert_array_equal(out[0], rows[order])
    np.testing.assert_array_equal(out[1], cols[order])
    np.testing.assert_array_equal(out[2], vals[order])
    np.testing.assert_array_equal(out[3], np.bincount(rows, minlength=50))
    assert "build" in host_pt._lib_path().split(os.sep)


@pytest.mark.parametrize("p_max", [None, 16])
def test_ell_pair_arrays_match(monkeypatch, p_max):
    if p_max is not None:
        monkeypatch.setattr(ell_jax, "P_MAX", p_max)
        monkeypatch.setattr(ell_pt, "P_MAX", p_max)
    rows, cols, vals, n_u, n_i = _problem(long_rows=3 if p_max else 0)
    dj = sparse_jax.ingest((rows, cols, vals, (n_u, n_i)))
    dt = sparse_pt.ingest((rows, cols, vals, (n_u, n_i)))
    pair_j = ell_jax.ell_pair_from_counts(dj.by_user, dj.by_item)
    pair_t = ell_pt.ell_pair_from_counts(dt.by_user, dt.by_item)
    n_ext = 0
    for ej, et in zip(pair_j, pair_t):
        for name in ("perm", "inv_perm", "row_nnz_perm"):
            np.testing.assert_array_equal(np.asarray(getattr(ej, name)),
                                          _np(getattr(et, name)))
        assert (ej.n_rows, ej.n_cols, ej.nnz, ej.n_rows_pad, ej.n_rows_ell) \
            == (et.n_rows, et.n_cols, et.nnz, et.n_rows_pad, et.n_rows_ell)
        assert len(ej.buckets) == len(et.buckets)
        for bj, bt in zip(ej.buckets, et.buckets):
            assert (bj.offset, bj.n_rows, bj.P) == (bt.offset, bt.n_rows,
                                                    bt.P)
            assert bt.cols.dtype == torch.int64
            for name in ("cols", "vals", "src", "ext", "ext_src"):
                a, b = getattr(bj, name), getattr(bt, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_array_equal(np.asarray(a), _np(b))
            n_ext += 0 if bt.ext is None else int(bt.ext.numel())
    assert (n_ext > 0) == (p_max is not None)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_gather_planes_bitwise(dtype):
    rows, cols, vals, n_u, n_i = _problem(seed=4)
    dj = sparse_jax.ingest((rows, cols, vals, (n_u, n_i)))
    dt = sparse_pt.ingest((rows, cols, vals, (n_u, n_i)))
    ell_j = ell_jax.ell_from_counts(dj.by_user)
    ell_t = ell_pt.ell_from_counts(dt.by_user)
    B = np.random.default_rng(5).uniform(0.0, 1.0, (dj.by_item.n_rows_pad, 7))
    B = B.astype(np.float32)
    pj = ell_jax.gather_planes(jnp.asarray(B), ell_j,
                               None if dtype is None else jnp.bfloat16)
    pt = ell_pt.gather_planes(torch.from_numpy(B), ell_t, dtype)
    for a, b in zip(pj, pt):
        assert tuple(a.shape) == tuple(b.shape)
        if dtype is None:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        else:
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16),
                b.view(torch.int16).numpy().view(np.uint16),
            )


def test_cuda_device_is_explicit():
    from poismf_torch import PoisMF

    if torch.cuda.is_available():
        assert PoisMF(k=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            PoisMF(k=2)
    assert PoisMF(k=2, device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    script = (
        "import sys\n"
        "import numpy as np\n"
        "import poismf_torch\n"
        "from poismf_torch import PoisMF\n"
        "rng = np.random.default_rng(0)\n"
        "r = rng.integers(0, 40, 300); c = rng.integers(0, 25, 300)\n"
        "v = rng.poisson(2.0, 300) + 1.0\n"
        "m = PoisMF(k=3, niter=1, device='cpu').fit((r, c, v, (40, 25)))\n"
        "assert m.topN(0, n=3).shape == (3,)\n"
        "bad = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] in ('jax', 'jaxlib', 'poismf_tpu'))\n"
        "print('LOADED', bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "LOADED []" in out.stdout
