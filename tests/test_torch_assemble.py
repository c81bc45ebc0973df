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
  row has (one row of 2 chunks against one of 12);
- the host plan of the card's kernel (``csrc/assemble.cu``): long and
  short groups partition the groups, and its in-place sums, run in
  Python in another order from a tail of NaN, give the plain result bit
  for bit (so no group reads what another writes); ``assembly`` refuses a
  layout where one would."""

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


LAYOUTS = ["full", "compact", "shard 0", "shard 1"]


@pytest.mark.parametrize("long_rows", [None, 4], ids=["module", "4"])
@pytest.mark.parametrize("name", LAYOUTS)
def test_long_and_short_groups_partition_the_groups(monkeypatch, name,
                                                    long_rows):
    """The card's two classes of groups (``Assembly.long_groups``,
    ``.short_groups``) partition the groups by their reads against
    ``LONG_GROUP_ROWS`` (the module's, and 4 so that both classes show on
    every layout with groups: 3 to 5 reads a long row, 98 the compact
    sub-ELL's zero tail), and ``max_len`` is the longest group's."""
    if long_rows is not None:
        monkeypatch.setattr(ell_pt, "LONG_GROUP_ROWS", long_rows)
    asm = _layouts()[name][0].asm
    threshold = ell_pt.LONG_GROUP_ROWS
    if asm.targets is None:
        assert asm.max_len == 0
        assert asm.long_groups is None and asm.short_groups is None
        return
    lens = np.diff(asm.offsets.numpy())
    long, short = asm.long_groups.numpy(), asm.short_groups.numpy()
    assert np.array_equal(np.sort(np.concatenate([long, short])),
                          np.arange(lens.shape[0]))
    assert (lens[long] >= threshold).all() and (lens[short] < threshold).all()
    assert asm.max_len == lens.max()
    if long_rows is not None:
        assert long.shape[0] > 0 and short.shape[0] > 0


def _kernel_model(flat, asm):
    """``csrc/assemble.cu``'s effects, one after another in an order the
    card may take: the zeroing blocks first, then the groups last to
    first, each summing its reads from -0.0 in order (the zero tail's
    last slot as +0.0, never read), zeroing its add rows and writing its
    target, all in place."""
    n_rows = flat.shape[0]
    zero_slot = n_rows - 1
    if asm.targets is None:
        rows = torch.arange(n_rows)
        mask = rows >= asm.covered
        if asm.drop is not None:
            mask[:asm.covered] |= asm.drop
        flat[mask] = 0
        return
    flat[asm.zero_rows] = 0
    offsets, order = asm.offsets.tolist(), asm.order.tolist()
    groups = asm.long_groups.tolist() + asm.short_groups.tolist()
    for g in reversed(sorted(groups)):
        target = int(asm.targets[g])
        reads = order[offsets[g]:offsets[g + 1]]
        acc = torch.full((flat.shape[1],), -0.0, dtype=flat.dtype)
        for r in reads:
            acc = acc + (torch.zeros_like(acc) if r == zero_slot
                         else flat[r])
        for r in reads:
            if r not in (zero_slot, target):
                flat[r] = 0
        flat[target] = acc


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", LAYOUTS)
def test_the_kernels_in_place_plan_gives_the_plain_result(layouts, name,
                                                          dtype, shape):
    """The card's kernel sums in place, reading the zero tail as +0.0 and
    zeroing what ``zero_rows`` (or, without groups, the drop mask and the
    tail) lists: that plan, run in another order than the plain route's
    (``_kernel_model``) from a tail of NaN, gives the plain route's result
    bit for bit, so no group reads what another writes."""
    ell = layouts[name][0]
    np_dt, int_dt, _ = DTYPES[dtype]
    tdt = getattr(torch, dtype)
    pieces = [torch.from_numpy(p) for p in _pieces(ell, shape, np_dt, 2)]
    want = ell_pt._assemble(ell, pieces, shape, tdt)
    got = torch.full((ell.n_rows_ell,) + shape, np.nan, dtype=tdt)
    torch.cat(pieces, out=got[:ell.asm.covered])
    _kernel_model(got.view(ell.n_rows_ell, -1), ell.asm)
    assert torch.equal(got.view(int_dt), want.view(int_dt))


def test_assembly_refuses_a_target_that_adds_elsewhere():
    """A row that adds into another slot while a group writes it would be
    read and written at once by the card's in-place sums."""
    src = np.array([1, 2, 2, 3], dtype=np.int64)
    with pytest.raises(ValueError, match="is itself a group's target"):
        ell_pt.assembly([(0, 4, src, None)], 8, "cpu")
    ok = np.array([1, 1, 2, 7], dtype=np.int64)
    asm = ell_pt.assembly([(0, 4, ok, None)], 8, "cpu")
    assert asm.zero_rows.tolist() == [4, 5, 6]  # rows 0 and 3 add
