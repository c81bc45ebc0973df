"""PyTorch port, ``ops.ell._assemble``: the per-slot sums of the bucket
outputs, in one fixed order.

On layouts with long-row extension chunks (P_MAX = 16 and rows of up to
5 chunks, so at least 3 extension chunks a row), pure-primary buckets,
a compact sub-ELL whose buckets sum through ``src``, and a row-sharded
shard (``ShardedEll.local_ell``), in float32 and float64:

- bitwise equal (bit patterns, so signed zeros, NaN and inf included) to
  the sequential ``index_add_`` per bucket that ``_assemble`` used
  before, the CPU's order;
- equal to the JAX package's ``_assemble`` on the same pieces, within
  rtol 1e-7 (float32) / 1e-15 (float64) (measured: bitwise);
- the same number of torch operations whatever the number of chunks a
  row has (one row of 2 chunks against one of 12)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from poismf_tpu import sparse as sparse_jax  # noqa: E402
from poismf_tpu.ops import ell as ell_jax  # noqa: E402
from poismf_torch import sparse as sparse_pt  # noqa: E402
from poismf_torch.ops import ell as ell_pt  # noqa: E402
from poismf_torch.parallel.ell_mesh import shard_ell  # noqa: E402

P_MAX = 16
N_USERS, N_ITEMS = 200, 90
# the long rows: 5 chunks (76 items), 4 (64: no partial chunk), 3 (40)
LONG = (76, 64, 40)
SHAPES = [(), (5,)]
DTYPES = {"float32": (np.float32, torch.int32, 1e-7),
          "float64": (np.float64, torch.int64, 1e-15)}


def _triplets(long_rows=LONG, n_items=N_ITEMS, seed=3):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 9, N_USERS)
    lens[:len(long_rows)] = long_rows
    rows = np.repeat(np.arange(N_USERS), lens)
    cols = np.concatenate([rng.choice(n_items, n, replace=False)
                           for n in lens])
    vals = rng.poisson(2.0, rows.shape[0]) + 1.0
    return rows.astype(np.int32), cols.astype(np.int32), vals


def _sequential(ell, pieces, shape, dtype):
    """The sequential reference: slice writes, then one ``index_add_`` per
    bucket in bucket order."""
    out = torch.zeros((ell.n_rows_ell,) + tuple(shape), dtype=dtype)
    deferred = []
    for b, part in zip(ell.buckets, pieces):
        part = part.to(dtype)
        if b.src is None:
            out[b.offset:b.offset + b.n_rows] = part
        elif b.ext is not None:
            sm = ell_pt._self_mask(b).reshape((-1,) + (1,) * len(shape))
            out[b.offset:b.offset + b.n_rows] = torch.where(sm, part, 0)
            deferred.append((b.ext_src, part[b.ext]))
        else:
            deferred.append((b.src, part))
    for idx, upd in deferred:
        out.index_add_(0, idx, upd)
    return out


def _pieces(ell, shape, dtype, seed=0):
    """Per-bucket outputs spanning ten decades (so the order of the sums
    shows in their last bits), with a -0.0, a NaN and an inf."""
    rng = np.random.default_rng(seed)
    out = []
    for b in ell.buckets:
        size = (b.n_rows,) + tuple(shape)
        p = rng.standard_normal(size) * 10.0 ** rng.integers(-4, 6, size)
        out.append(p.astype(dtype))
    flat = out[-1].reshape(-1)
    flat[-3:] = (-0.0, np.nan, np.inf)
    return out


def _compact(ell_mod, ell, seed=5):
    """A compact sub-ELL of ``ell`` (``ell_mod``'s functions) over a random
    fifth of the slots and every long row."""
    active = np.random.default_rng(seed).random(ell.n_rows_ell) < 0.2
    active[np.asarray(ell.inv_perm)[:len(LONG)]] = True
    plan = ell_mod.plan_compact(ell, 2)
    sel = ell_mod.select_active(
        ell, plan, active, np.asarray(ell.row_nnz_perm),
        [None if b.src is None else np.asarray(b.src) for b in ell.buckets])
    assert sel is not None
    out = ell_mod.build_compact(ell, plan, *sel[:4])
    return out[0] if isinstance(out, tuple) else out


def _layouts():
    """{name: (port layout, JAX layout or None)} with P_MAX = 16."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ell_pt, "P_MAX", P_MAX)
        mp.setattr(ell_jax, "P_MAX", P_MAX)
        rows, cols, vals = _triplets()
        X = (rows, cols, vals, (N_USERS, N_ITEMS))
        full = ell_pt.ell_from_counts(sparse_pt.ingest(X).by_user)
        full_j = ell_jax.ell_from_counts(sparse_jax.ingest(X).by_user)
        se = shard_ell(sparse_pt.ingest(X).by_user, 2)
        return {"full": (full, full_j),
                "compact": (_compact(ell_pt, full), _compact(ell_jax, full_j)),
                "shard 0": (se.local_ell(0), None),
                "shard 1": (se.local_ell(1), None)}


@pytest.fixture(scope="module")
def layouts():
    return _layouts()


def test_layouts_hold_what_the_tests_need(layouts):
    full = layouts["full"][0]
    kinds = [(b.src is None, b.ext is not None) for b in full.buckets]
    assert (True, False) in kinds and (False, True) in kinds
    # the 76-item row: a primary and 4 extension chunks
    counts = np.bincount(np.asarray(torch.cat([b.ext_src for b in full.buckets
                                               if b.ext is not None])))
    assert counts.max() >= 4
    assert any(b.src is not None and b.ext is None
               for b in layouts["compact"][0].buckets)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["full", "compact", "shard 0", "shard 1"])
def test_assemble_equals_the_sequential_index_add(layouts, name, dtype,
                                                  shape):
    ell = layouts[name][0]
    np_dt, int_dt, _ = DTYPES[dtype]
    pieces = [torch.from_numpy(p) for p in _pieces(ell, shape, np_dt)]
    tdt = getattr(torch, dtype)
    got = ell_pt._assemble(ell, pieces, shape, tdt)
    want = _sequential(ell, pieces, shape, tdt)
    assert torch.equal(got.view(int_dt), want.view(int_dt))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["full", "compact"])
def test_assemble_equals_jax(layouts, name, dtype, shape):
    ell, ell_j = layouts[name]
    np_dt, _, rtol = DTYPES[dtype]
    pieces = _pieces(ell, shape, np_dt, seed=1)
    got = ell_pt._assemble(ell, [torch.from_numpy(p) for p in pieces],
                           shape, getattr(torch, dtype)).numpy()
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(ell_jax._assemble(
            ell_j, [jnp.asarray(p) for p in pieces], shape, np_dt))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_assemble_ops_do_not_grow_with_chunks(monkeypatch):
    monkeypatch.setattr(ell_pt, "P_MAX", P_MAX)
    ops = []
    for chunks in (2, 12):
        rows, cols, vals = _triplets(long_rows=(chunks * P_MAX,),
                                     n_items=12 * P_MAX)
        X = (rows, cols, vals, (N_USERS, 12 * P_MAX))
        ell = ell_pt.ell_from_counts(sparse_pt.ingest(X).by_user)
        pieces = [torch.from_numpy(p) for p in _pieces(ell, (5,),
                                                       np.float32)]
        with _CountOps() as count:
            ell_pt._assemble(ell, pieces, (5,), torch.float32)
        ops.append(([b.P for b in ell.buckets], count.n))
    # the same buckets, and the same operations
    assert ops[0][0] == ops[1][0]
    assert ops[0][1] == ops[1][1]
