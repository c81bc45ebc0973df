"""Planar-ELL sparse layout and gather-free objective evaluations (PyTorch).

Counterpart of ``poismf_tpu/ops/ell.py``.  Rows are bucketed by nonzero
count (powers of two, rows sorted by count so each bucket is a contiguous
row range in the permuted order); once per half-update the fixed factor
matrix's rows are gathered into per-bucket planes ``bg[k, P, R_b]`` (R_b,
the bucket's rows, innermost); every solver evaluation then streams those
planes through the kernels of :mod:`poismf_torch.kernels`.

The host builders are NumPy and produce exactly the JAX package's layout
(same constants, same order); the device tensors are built once, with
int64 indices.

Each bucket's sweep is asked of :mod:`poismf_torch.kernels` by name
(``kernels.sweep``, ``kernels.ray``), which picks the kernel or its
plain version (``kernels/route.py``); the outputs come back here in the
factors' dtype.  fgh and fg hand ``px`` back in that dtype, so float64
factors search on the plain route.  ``f_gtd_multi_ell`` keeps the JAX
package's float64 fallback, ``f_gtd_fused_ell`` at each projected trial.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..utils import profiling

# Row-count padding within a bucket.
ROW_TILE = 128
# Smallest nnz bucket width.
MIN_P = 4
# Rows with more nonzeros than this are split into chunks of P_MAX
# ("extension" virtual rows that scatter-add into the primary row's slot).
P_MAX = 2048
# Bucket-count ceiling and padding budget of the merge pass.
MAX_BUCKETS = 6
MERGE_PAD_BUDGET = 0.06

PRED_EPS = 1e-30


@dataclasses.dataclass(frozen=True)
class EllBucket:
    """One nnz bucket: virtual rows at ELL slots [offset, offset + n_rows),
    each holding at most P nonzeros.  ``cols`` is row-major [R_b, P] for
    the gather; ``vals`` is planar [P, R_b].  Padding entries have
    ``col == 0`` and ``val == 0``.

    ``src`` is None for a pure-primary bucket; otherwise ``src[i]`` is the
    ELL slot holding the factor vector bucket row i reads from and
    accumulates into (long-row extension chunks point at their primary,
    padding rows at the zero tail).  ``ext`` / ``ext_src`` list the real
    extension rows only (bucket-local position, primary's slot); compact
    sub-ELLs leave them None and go through the full ``src`` gather."""

    offset: int
    n_rows: int  # padded to ROW_TILE
    P: int
    cols: torch.Tensor  # [R_b, P] int64
    vals: torch.Tensor  # [P, R_b]
    src: Optional[torch.Tensor] = None  # [R_b] int64
    ext: Optional[torch.Tensor] = None  # [n_ext] int64
    ext_src: Optional[torch.Tensor] = None  # [n_ext] int64


@dataclasses.dataclass(frozen=True)
class Assembly:
    """How :func:`_assemble` turns the buckets' row outputs into one value
    per slot, built on the host with the layout.  The buckets tile slots
    ``[0, covered)`` in order; the rest is the zero tail.  ``drop`` marks
    the bucket rows that are not their slot's own row (extension chunks,
    padding rows, and every row of a bucket summed through ``src``): their
    slots read zero.  Each slot in ``targets`` then receives, in one fixed
    order, its own value (or the zero tail's) and the rows that add into
    it in slot order, which is chunk order: ``order`` lists those slots
    grouped by target, ``offsets`` bounds each group.  ``drop`` is None
    when every bucket row is its slot's own, the other three when no row
    adds into another slot.

    For the card's kernel (``kernels.assemble``), where there are groups:
    ``max_len``, the longest group's reads; ``long_groups`` and
    ``short_groups``, the groups of at least and of fewer than
    ``LONG_GROUP_ROWS`` reads (a block a group, or a warp); ``zero_rows``,
    the rows that read zero and that no group reads or writes (dropped
    rows that add nowhere, the zero tail but its targets).  These three
    and ``offsets`` are views of one copy to the card."""

    covered: int
    drop: Optional[torch.Tensor] = None  # [covered] bool
    targets: Optional[torch.Tensor] = None  # [n_targets] int64
    order: Optional[torch.Tensor] = None  # [n_targets + n_adds] int64
    offsets: Optional[torch.Tensor] = None  # [n_targets + 1] int64
    max_len: int = 0
    long_groups: Optional[torch.Tensor] = None  # [n_long] int64
    short_groups: Optional[torch.Tensor] = None  # [n_short] int64
    zero_rows: Optional[torch.Tensor] = None  # [n_zero] int64


# Reads from which a group is summed by a block of its own on the card
# (csrc/assemble.cu): below it, a warp's loads in flight cover the group.
LONG_GROUP_ROWS = 64


def assembly(buckets, n_rows_ell: int, device) -> Assembly:
    """The :class:`Assembly` of a layout from host arrays: ``buckets`` is
    ``[(offset, n_rows, src, ext)]`` per bucket, with ``src`` (the slot
    each row adds into) and ``ext`` (the rows to add, for a bucket whose
    own rows are written in place) None where the bucket has none."""
    covered, keep, rows, dest = 0, [], [], []
    for off, n, src, ext in buckets:
        if off != covered:
            raise ValueError(f"buckets must tile the slots in order: a "
                             f"bucket at slot {off} after {covered} slots")
        covered += n
        if src is None:
            keep.append(np.ones(n, dtype=bool))
        elif ext is not None:
            keep.append(src == off + np.arange(n))
            rows.append(off + ext)
            dest.append(src[ext])
        else:
            keep.append(np.zeros(n, dtype=bool))
            rows.append(off + np.arange(n))
            dest.append(src)
    if covered >= n_rows_ell:
        raise ValueError("the layout has no zero tail")

    def dev(a):
        return profiling.to_device(np.ascontiguousarray(a), device,
                                   "ell.assembly")

    keep = np.concatenate(keep) if keep else np.zeros(0, dtype=bool)
    drop = None if keep.all() else dev(~keep)
    if not rows or sum(r.shape[0] for r in rows) == 0:
        return Assembly(covered, drop=drop)
    rows = np.concatenate(rows).astype(np.int64)
    targets, inv = np.unique(np.concatenate(dest).astype(np.int64),
                             return_inverse=True)
    own = np.zeros(targets.shape[0], dtype=bool)
    in_range = targets < covered
    own[in_range] = keep[targets[in_range]]
    # a group: the target's own slot (the zero tail's where the target is
    # not a row written in place), then its adds in slot order
    group = np.concatenate([np.arange(targets.shape[0]), inv.reshape(-1)])
    reads = np.concatenate([np.where(own, targets, n_rows_ell - 1), rows])
    lens = np.bincount(group, minlength=targets.shape[0])
    offsets = np.zeros(targets.shape[0] + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    # the card sums in place: a row read as an add must not be another
    # group's target (a compact primary summed through ``src`` adds into
    # itself), so no group reads what another writes
    is_target = np.zeros(n_rows_ell, dtype=bool)
    is_target[targets] = True
    clash = is_target[rows] & (targets[inv.reshape(-1)] != rows)
    if clash.any():
        raise ValueError(f"slot {rows[clash][0]} adds into another slot and "
                         f"is itself a group's target")
    zero = np.ones(n_rows_ell, dtype=bool)
    zero[:covered] = ~keep
    zero[rows] = False
    zero[targets] = False
    long = lens >= LONG_GROUP_ROWS
    n_long, n_short = int(long.sum()), int((~long).sum())
    # one copy to the card for the four: each copy waits for the card
    g = dev(np.concatenate([offsets, np.nonzero(long)[0],
                            np.nonzero(~long)[0], np.nonzero(zero)[0]]))
    n_off = offsets.shape[0]
    return Assembly(covered, drop=drop, targets=dev(targets),
                    order=dev(reads[np.argsort(group, kind="stable")]),
                    offsets=g[:n_off], max_len=int(lens.max()),
                    long_groups=g[n_off:n_off + n_long],
                    short_groups=g[n_off + n_long:n_off + n_long + n_short],
                    zero_rows=g[n_off + n_long + n_short:])


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Bucketed planar-ELL view of a sparse counts matrix.

    ``perm[i]`` is the original row id at ELL position ``i`` (padding
    slots carry the sentinel ``n_rows_pad``, which :func:`permute_rows`
    turns into zero rows); ``inv_perm`` maps original row ids to ELL
    positions (empty rows point at the zero tail).  ``host`` keeps the
    NumPy copies of ``row_nnz_perm`` and the buckets' ``src`` that the
    cascade plans with (None on compact sub-ELLs); ``asm`` is the
    layout's :class:`Assembly`."""

    buckets: Tuple[EllBucket, ...]
    perm: torch.Tensor  # [n_rows_ell] int64
    inv_perm: torch.Tensor  # [n_rows_pad] int64
    row_nnz_perm: torch.Tensor  # [n_rows_ell] int32
    n_rows: int
    n_cols: int
    nnz: int
    n_rows_pad: int
    n_rows_ell: int
    host: Optional[dict] = None
    asm: Optional[Assembly] = None

    @property
    def device(self) -> torch.device:
        return self.perm.device


def _ceil_to(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _plan_buckets(counts_sorted: np.ndarray
                  ) -> List[Tuple[int, int, int, int]]:
    """Bucket spans over nnz-descending-sorted rows: [(start, end, P,
    ell_offset)].  One span per power-of-two octave, then adjacent spans
    are greedily merged (cheapest padding increase first) until at most
    MAX_BUCKETS remain, within MERGE_PAD_BUDGET."""
    n_nonempty = int(np.count_nonzero(counts_sorted))
    spans: List[Tuple[int, int, int]] = []
    start = 0
    while start < n_nonempty:
        c = int(counts_sorted[start])
        P = max(MIN_P, 1 << (c - 1).bit_length())
        lo_width = P // 2 if P > MIN_P else 0
        end = int(
            np.searchsorted(-counts_sorted, -(lo_width + 1), side="right")
        )
        end = max(end, start + 1)
        spans.append((start, end, P))
        start = end

    def cost(s: int, e: int, P: int) -> int:
        return _ceil_to(e - s, ROW_TILE) * P

    base = sum(cost(s, e, P) for s, e, P in spans)
    budget = MERGE_PAD_BUDGET * base
    added = 0.0
    while len(spans) > 1:
        best_i, best_d = -1, None
        for i in range(len(spans) - 1):
            (s1, e1, P1), (s2, e2, P2) = spans[i], spans[i + 1]
            d = cost(s1, e2, P1) - cost(s1, e1, P1) - cost(s2, e2, P2)
            if best_d is None or d < best_d:
                best_i, best_d = i, d
        free = best_d <= 0
        over_count = len(spans) > MAX_BUCKETS
        if not (free or (over_count and added + best_d <= budget)):
            break
        s1, e1, P1 = spans[best_i]
        s2, e2, P2 = spans[best_i + 1]
        spans[best_i : best_i + 2] = [(s1, e2, P1)]
        added += max(best_d, 0)

    out: List[Tuple[int, int, int, int]] = []
    ell_off = 0
    for s, e, P in spans:
        out.append((s, e, P, ell_off))
        ell_off += _ceil_to(e - s, ROW_TILE)
    return out


def _virtual_rows(rows: np.ndarray, n_rows: int):
    """Split rows longer than P_MAX into virtual rows; returns (counts,
    v_offsets, orig_of_v, chunk_of_v, vcounts)."""
    counts = np.bincount(rows, minlength=n_rows).astype(np.int64)
    n_chunks = -(-counts // P_MAX)  # ceil; 0 for empty rows
    v_offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(n_chunks, out=v_offsets[1:])
    n_virtual = int(v_offsets[-1])
    orig_of_v = np.repeat(np.arange(n_rows, dtype=np.int64), n_chunks)
    chunk_of_v = np.arange(n_virtual, dtype=np.int64) - v_offsets[orig_of_v]
    vcounts = np.minimum(P_MAX, counts[orig_of_v] - chunk_of_v * P_MAX)
    return counts, v_offsets, orig_of_v, chunk_of_v, vcounts


def _ell_slots(vcounts: np.ndarray):
    """(order, pos_of_v, spans, n_rows_ell, ell_of_v) of the virtual rows."""
    n_virtual = vcounts.shape[0]
    order = np.argsort(-vcounts, kind="stable").astype(np.int64)
    pos_of_v = np.empty(n_virtual, dtype=np.int64)
    pos_of_v[order] = np.arange(n_virtual, dtype=np.int64)
    spans = _plan_buckets(vcounts[order])
    covered = (spans[-1][3] + _ceil_to(spans[-1][1] - spans[-1][0], ROW_TILE)
               ) if spans else 0
    n_rows_ell = covered + ROW_TILE
    ell_of_pos = np.full(n_virtual, n_rows_ell - 1, dtype=np.int64)
    for s, e, _P, off in spans:
        ell_of_pos[s:e] = off + np.arange(e - s, dtype=np.int64)
    return order, pos_of_v, spans, n_rows_ell, ell_of_pos[pos_of_v]


def build_ell(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    n_rows_pad: int,
    dtype=np.float32,
    device="cpu",
    col_positions: Optional[np.ndarray] = None,
) -> EllMatrix:
    """Build the bucketed planar-ELL layout from COO triplets (the same
    layout as ``poismf_tpu.ops.ell.build_ell``), on ``device``.

    ``col_positions``, when given, remaps every column id through it (the
    OTHER orientation's permuted row positions, so both factor matrices
    live in their permuted orders for the whole fit)."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1)
    cols = np.asarray(cols, dtype=np.int64).reshape(-1)
    if col_positions is not None:
        cols = np.asarray(col_positions, dtype=np.int64)[cols]
    vals = np.asarray(vals, dtype=dtype).reshape(-1)
    nnz = int(rows.shape[0])

    counts, v_offsets, orig_of_v, chunk_of_v, vcounts = _virtual_rows(
        rows, n_rows
    )
    primary_of_v = v_offsets[orig_of_v]

    # CSR-style slot within each original row for every nonzero (the
    # CountsMatrix triplets arrive sorted; anything else is sorted here)
    if bool(np.all(rows[:-1] <= rows[1:])):
        r_sorted, cols_s, vals_s = rows, cols, vals
    else:
        sort_idx = np.argsort(rows, kind="stable")
        r_sorted = rows[sort_idx]
        cols_s = cols[sort_idx]
        vals_s = vals[sort_idx]
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    slot = np.arange(nnz, dtype=np.int64) - starts[r_sorted]
    vrow_e = v_offsets[r_sorted] + slot // P_MAX  # virtual row per edge
    vslot_e = slot % P_MAX

    order, pos_of_v, spans, n_rows_ell, ell_of_v = _ell_slots(vcounts)
    src_of_v = ell_of_v[primary_of_v]
    is_primary = chunk_of_v == 0

    perm = np.full(n_rows_ell, n_rows_pad, dtype=np.int64)  # pad sentinel
    inv_perm = np.full(n_rows_pad, n_rows_ell - 1, dtype=np.int64)
    row_nnz_perm = np.zeros(n_rows_ell, dtype=np.int32)
    perm[ell_of_v[is_primary]] = orig_of_v[is_primary]
    inv_perm[orig_of_v[is_primary]] = ell_of_v[is_primary]
    row_nnz_perm[ell_of_v[is_primary]] = counts[orig_of_v[is_primary]]

    # one vectorized scatter of every edge into flat per-bucket storage
    pos_e = pos_of_v[vrow_e]
    span_starts = np.array([s for s, _e, _P, _o in spans], dtype=np.int64)
    span_P = np.array([P for _s, _e, P, _o in spans], dtype=np.int64)
    span_Rb = np.array(
        [_ceil_to(e - s, ROW_TILE) for s, e, _P, _o in spans], dtype=np.int64
    )
    flat_off = np.zeros(len(spans) + 1, dtype=np.int64)
    np.cumsum(span_Rb * span_P, out=flat_off[1:])
    b_e = np.searchsorted(span_starts, pos_e, side="right") - 1
    dest = flat_off[b_e] + (pos_e - span_starts[b_e]) * span_P[b_e] + vslot_e
    flat_cols = np.zeros(int(flat_off[-1]), dtype=np.int64)
    flat_vals = np.zeros(int(flat_off[-1]), dtype=dtype)
    flat_cols[dest] = cols_s
    flat_vals[dest] = vals_s

    def dev(a):
        return profiling.to_device(np.ascontiguousarray(a), device,
                                   "ell.build")

    buckets: List[EllBucket] = []
    host_src: List[Optional[np.ndarray]] = []
    host_asm = []
    for i, (s, e, P, off) in enumerate(spans):
        Rb = int(span_Rb[i])
        sl = slice(int(flat_off[i]), int(flat_off[i + 1]))
        bcols = flat_cols[sl].reshape(Rb, P)
        bvals = flat_vals[sl].reshape(Rb, P)
        is_prim_b = is_primary[order[s:e]]
        if bool(np.all(is_prim_b)):
            src = ext = ext_src = None
        else:
            src = np.full(Rb, n_rows_ell - 1, dtype=np.int64)
            src[: e - s] = src_of_v[order[s:e]]
            ext = np.nonzero(~is_prim_b)[0].astype(np.int64)
            ext_src = src[ext]
        host_src.append(src)
        host_asm.append((off, Rb, src, ext))
        buckets.append(EllBucket(
            offset=off, n_rows=Rb, P=P, cols=dev(bcols), vals=dev(bvals.T),
            src=None if src is None else dev(src),
            ext=None if ext is None else dev(ext),
            ext_src=None if ext_src is None else dev(ext_src),
        ))

    return EllMatrix(
        buckets=tuple(buckets), perm=dev(perm), inv_perm=dev(inv_perm),
        row_nnz_perm=dev(row_nnz_perm), n_rows=n_rows, n_cols=n_cols,
        nnz=nnz, n_rows_pad=n_rows_pad, n_rows_ell=n_rows_ell,
        host=dict(row_nnz_perm=row_nnz_perm, src=host_src),
        asm=assembly(host_asm, n_rows_ell, device),
    )


def row_positions(rows: np.ndarray, n_rows: int, n_rows_pad: int
                  ) -> np.ndarray:
    """ELL-space position of each original row id: the ``inv_perm`` that
    :func:`build_ell` produces for the same row set."""
    _, _, orig_of_v, chunk_of_v, vcounts = _virtual_rows(
        np.asarray(rows, dtype=np.int64), n_rows
    )
    _, _, _, n_rows_ell, ell_of_v = _ell_slots(vcounts)
    is_primary = chunk_of_v == 0
    pos = np.full(n_rows_pad, n_rows_ell - 1, dtype=np.int64)
    pos[orig_of_v[is_primary]] = ell_of_v[is_primary]
    return pos


def ell_from_counts(X, dtype=None, col_positions=None, device="cpu"
                    ) -> EllMatrix:
    """Build from a :class:`~poismf_torch.sparse.CountsMatrix`."""
    rows, cols, vals = X.triplets()
    return build_ell(
        rows, cols, vals, X.n_rows, X.n_cols, X.n_rows_pad,
        dtype=dtype or vals.dtype, device=device,
        col_positions=col_positions,
    )


def ell_pair_from_counts(by_user, by_item, dtype=None, device="cpu"):
    """Both orientations with cross-referenced permuted column ids: the
    by-user ELL's columns index the by-item permuted order and vice
    versa, so A and B stay in permuted order for the whole fit."""
    with profiling.span("ell.build"):
        pos_u = row_positions(by_user.triplets()[0], by_user.n_rows,
                              by_user.n_rows_pad)
        pos_i = row_positions(by_item.triplets()[0], by_item.n_rows,
                              by_item.n_rows_pad)
        ell_user = ell_from_counts(by_user, dtype=dtype, col_positions=pos_i,
                                   device=device)
        ell_item = ell_from_counts(by_item, dtype=dtype, col_positions=pos_u,
                                   device=device)
        return ell_user, ell_item


# ---------------------------------------------------------------------------
# Device ops
# ---------------------------------------------------------------------------


def torch_dtype(dtype) -> Optional[torch.dtype]:
    """None, a torch dtype, or a name ("bfloat16", np.float32, ...)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return getattr(torch, name)


def gather_bucket(M_t: torch.Tensor, b: EllBucket) -> torch.Tensor:
    """One bucket's plane ``[k, P, R_b]`` (contiguous) from the transposed
    fixed matrix ``M_t [k, n]``: a single gather that writes the plane in
    place.  The index is made contiguous first: indexing follows the
    index's strides, and a transposed index gives a strided plane."""
    return M_t[:, b.cols.t().contiguous()].contiguous()


def gather_planes(M: torch.Tensor, ell: EllMatrix, dtype=None
                  ) -> Tuple[torch.Tensor, ...]:
    """Once per half-update: gather the FIXED matrix's rows for every
    nonzero into planar per-bucket tensors ``bg[k, P, R_b]``.  The cast
    happens BEFORE the gather, as in the JAX package (ell.py:514-524):
    the cast commutes with the gather, so the planes are bitwise those of
    gather-then-cast, at half the bytes moved for bf16."""
    dt = torch_dtype(dtype)
    if dt is not None:
        M = M.to(dt)
    M_t = M.t().contiguous()
    return tuple(gather_bucket(M_t, b) for b in ell.buckets)


def _self_mask(b: EllBucket) -> torch.Tensor:
    """[R_b] bool: bucket rows whose slot IS their own primary row."""
    return b.src == (b.offset + torch.arange(b.n_rows, device=b.src.device))


def _bucket_x(A_perm: torch.Tensor, b: EllBucket) -> torch.Tensor:
    """The factor rows a bucket reads: its own contiguous slot range; for
    mixed buckets with ``ext``, the same slice with extension rows set to
    their primary's vector and padding rows zeroed; otherwise the full
    ``src`` gather (compact sub-ELLs)."""
    if b.src is None:
        return A_perm[b.offset : b.offset + b.n_rows]
    if b.ext is not None:
        base = A_perm[b.offset : b.offset + b.n_rows]
        base = torch.where(_self_mask(b)[:, None], base, 0)
        base[b.ext] = A_perm[b.ext_src]
        return base
    return A_perm[b.src]


def _assemble(ell: EllMatrix, pieces: Sequence[torch.Tensor], shape,
              dtype) -> torch.Tensor:
    """Per-bucket row outputs -> [n_rows_ell, *shape]: every bucket row
    written to its own slot, the rows that are not their slot's own row
    then zeroed, and the extension chunks (or whole compact buckets) added
    into their primary slots (``ell.asm``).  Each primary slot sums its
    own value and its chunks one after another in chunk order, which is
    the order of a sequential ``index_add_`` per bucket (the CPU's, and
    JAX's ``.at[].add``): the result is a function of the inputs alone, on
    the card as on the CPU, in a fixed number of launches however many
    chunks a row has.  After the pieces' copy, ``kernels.assemble`` sums
    the groups in place: the plain version on the CPU, one launch on the
    card, bit for bit the same."""
    asm = ell.asm
    out = torch.empty((ell.n_rows_ell,) + tuple(shape), dtype=dtype,
                      device=ell.device)
    if pieces:
        torch.cat([part.to(dtype) for part in pieces], out=out[:asm.covered])
    kernels.assemble(out.view(ell.n_rows_ell, -1), asm)
    return out


def _linear_tail(A_perm, Bsum, l2_reg: float, w_mult: float,
                 l2_in_f: bool, neg_llk, grad_data=None):
    """The linear terms around the assembled data terms: f =
    ``<a, Bsum> (+ l2 |a|^2) + w_mult * neg_llk`` and, with ``grad_data``,
    g = ``Bsum + 2 l2 a + w_mult * grad_data``.  ``Bsum`` is [k] or
    [n_rows_ell, k].  The order of operations is fixed: the float32 card
    fits repeat bit for bit in this one."""
    if w_mult != 1.0:
        neg_llk = w_mult * neg_llk
        if grad_data is not None:
            grad_data = w_mult * grad_data
    if Bsum.dim() == 1:
        lin = A_perm @ Bsum
        g_lin = Bsum[None, :]
    else:
        lin = (A_perm * Bsum).sum(-1)
        g_lin = Bsum
    if l2_in_f:
        lin = lin + l2_reg * (A_perm * A_perm).sum(-1)
    f = lin + neg_llk
    if grad_data is None:
        return f
    return f, g_lin + 2.0 * l2_reg * A_perm + grad_data


def fgh_ell(A_perm, planes, ell: EllMatrix, Bsum, l2_reg: float,
            w_mult: float = 1.0, l2_in_f: bool = True, want_px: bool = True):
    """Fused f / grad / HVP weights / Hessian diagonal over all buckets.
    ``l2_in_f=False`` omits the l2 penalty from f only (the reference
    TNCG objective, whose f lacks the penalty its gradient carries).
    Returns ``(f [R], g [R, k], w2 (per-bucket planes), diag [R, k],
    px (per-bucket raw prediction planes, or None))``, each in
    ``A_perm``'s dtype."""
    k = A_perm.shape[1]
    dtype = A_perm.dtype
    nlls, grads, diags, w2s, preds = [], [], [], [], []
    for b, bg in zip(ell.buckets, planes):
        nll, grad, diag, w2, pred = kernels.sweep(
            "fgh_bucket", bg, b.vals, _bucket_x(A_perm, b).t(),
            w_mult=float(w_mult), want_pred=want_px)
        nlls.append(nll)
        grads.append(grad.t())
        diags.append(diag.t())
        w2s.append(w2.to(dtype))
        preds.append(pred.to(dtype) if want_px else None)

    neg_llk = _assemble(ell, nlls, (), dtype)
    grad_data = _assemble(ell, grads, (k,), dtype)
    diag_data = _assemble(ell, diags, (k,), dtype)
    f, g = _linear_tail(A_perm, Bsum, l2_reg, w_mult, l2_in_f, neg_llk,
                        grad_data)
    diag = 2.0 * l2_reg + diag_data
    return f, g, tuple(w2s), diag, (tuple(preds) if want_px else None)


def fg_ell(A_perm, planes, ell: EllMatrix, Bsum, l2_reg: float,
           w_mult: float = 1.0, want_px: bool = True):
    """Objective and gradient, no Hessian data: the CG solver's
    evaluation.  The log is unfloored, so a non-positive prediction at a
    positive count poisons the row's f with inf/NaN (the line search
    rejects such trials); the gradient weights keep the floor.  Returns
    ``(f [R], g [R, k], px (per-bucket raw prediction planes, or None))``;
    ``want_px=False`` (the fused, non-ray CG mode) writes no px planes."""
    k = A_perm.shape[1]
    dtype = A_perm.dtype
    nlls, grads, preds = [], [], []
    for b, bg in zip(ell.buckets, planes):
        nll, grad, pred = kernels.sweep(
            "fg_bucket", bg, b.vals, _bucket_x(A_perm, b).t(),
            want_pred=want_px)
        nlls.append(nll)
        grads.append(grad.t())
        preds.append(pred.to(dtype) if want_px else None)
    # the kernel's weights are unscaled; w_mult applies after assembly
    neg_llk = _assemble(ell, nlls, (), dtype)
    grad_data = _assemble(ell, grads, (k,), dtype)
    f, g = _linear_tail(A_perm, Bsum, l2_reg, w_mult, True, neg_llk,
                        grad_data)
    return f, g, (tuple(preds) if want_px else None)


def f_ell(A_perm, planes, ell: EllMatrix, Bsum, l2_reg: float,
          w_mult: float = 1.0, l2_in_f: bool = True):
    """Objective only (line-search trials), [n_rows_ell].  No eps floor:
    a non-positive prediction at a positive count poisons the row with
    +inf (NaN for a negative one).  ``w_mult`` applies after assembly;
    ``l2_in_f=False`` omits the l2 penalty (see :func:`fgh_ell`)."""
    nlls = [kernels.sweep("f_bucket", bg, b.vals, _bucket_x(A_perm, b).t())
            for b, bg in zip(ell.buckets, planes)]
    neg_llk = _assemble(ell, nlls, (), A_perm.dtype)
    return _linear_tail(A_perm, Bsum, l2_reg, w_mult, l2_in_f, neg_llk)


def f_gtd_ell(A_perm, D_perm, bds, planes, ell: EllMatrix, Bsum,
              l2_reg: float, w_mult: float = 1.0, l2_in_f: bool = True):
    """Objective and directional derivative ``g(trial) . d`` per row at
    the trial ``A_perm`` in one plane sweep, with the ``<B, d>`` planes
    ``bds`` hoisted by :func:`bdot_ell`.  Returns (f, gtd), each
    [n_rows_ell]; same poisoning as :func:`f_ell`."""
    from .objective import combine_f_gtd

    dtype = A_perm.dtype
    nlls, guds = [], []
    for b, bg, bd_b in zip(ell.buckets, planes, bds):
        nll, gud = kernels.sweep("f_gtd_bucket", bg, b.vals,
                                 _bucket_x(A_perm, b).t(), bd_b)
        nlls.append(nll)
        guds.append(gud)
    nll = _assemble(ell, nlls, (), dtype)
    gud = _assemble(ell, guds, (), dtype)
    return combine_f_gtd(nll, gud, A_perm, D_perm, Bsum, l2_reg, w_mult,
                         l2_in_f)


def f_gtd_fused_ell(A_perm, D_perm, planes, ell: EllMatrix, Bsum,
                    l2_reg: float, w_mult: float = 1.0, l2_in_f: bool = True):
    """:func:`f_gtd_ell` with ``<B, d>`` computed from the same plane read
    instead of a hoisted plane."""
    from .objective import combine_f_gtd

    dtype = A_perm.dtype
    nlls, guds = [], []
    for b, bg in zip(ell.buckets, planes):
        nll, gud = kernels.sweep("f_gtd_fused_bucket", bg, b.vals,
                                 _bucket_x(A_perm, b).t(),
                                 _bucket_x(D_perm, b).t())
        nlls.append(nll)
        guds.append(gud)
    nll = _assemble(ell, nlls, (), dtype)
    gud = _assemble(ell, guds, (), dtype)
    return combine_f_gtd(nll, gud, A_perm, D_perm, Bsum, l2_reg, w_mult,
                         l2_in_f)


def f_gtd_multi_ell(alphas, X_perm, D_perm, planes, ell: EllMatrix, Bsum,
                    l2_reg: float, w_mult: float = 1.0, l2_in_f: bool = True):
    """Complete (f, g(trial).d) at C projected trials
    ``max(0, x + alphas[c] * d)`` in one plane read per bucket.
    ``alphas`` [C, n_rows_ell] -> (f [C, n_rows_ell], gtd [C, n_rows_ell]);
    same poisoning as :func:`f_ell`.

    The kernel folds the linear, l2 and Bsum terms in on every primary
    row, including those of buckets that also hold long-row extension
    chunks (their ``_self_mask`` rows); the chunks and padding rows give
    data terms only, which :func:`_assemble` adds into the primary slots.
    So every true row equals the JAX package's jnp fallback, i.e.
    :func:`f_gtd_fused_ell` at each trial.  (The JAX kernel path folds per
    bucket, ``fold_linear=b.src is None``, and so drops the linear terms
    of the primary rows of such mixed buckets.)  Where the planes or the
    iterate are float64 (``kernels.takes_plain``), this is that fallback
    (``poismf_tpu/ops/ell.py:830-835``, :870-886): per candidate, the
    projected trial in the iterate's dtype through
    :func:`f_gtd_fused_ell`, whose own route takes the f_gtd_fused kernel
    unless the planes are float64.  ``Bsum`` is [k] or [n_rows_ell, k]
    (already permuted)."""
    C = alphas.shape[0]
    dtype = X_perm.dtype
    if (not planes or kernels.takes_plain(planes[0])
            or kernels.takes_plain(X_perm)):
        outs = [f_gtd_fused_ell(
            torch.clamp_min(X_perm + alphas[c][:, None] * D_perm, 0.0),
            D_perm, planes, ell, Bsum, l2_reg, w_mult, l2_in_f)
            for c in range(C)]
        return (torch.stack([f for f, _ in outs]),
                torch.stack([g for _, g in outs]))
    fs, gs = [], []
    for b, bg in zip(ell.buckets, planes):
        f_b, g_b = kernels.sweep(
            "f_gtd_multi_bucket", bg, b.vals, _bucket_x(X_perm, b).t(),
            _bucket_x(D_perm, b).t(), _bucket_x(alphas.t(), b).t(),
            Bsum if Bsum.dim() == 1 else _bucket_x(Bsum, b).t(),
            l2_reg=float(l2_reg), w_mult=float(w_mult), l2_in_f=l2_in_f,
            fold=None if b.src is None else _self_mask(b))
        fs.append(f_b.t())
        gs.append(g_b.t())
    # all C candidates assemble at once as [n_rows_ell, C] columns
    return (_assemble(ell, fs, (C,), dtype).t(),
            _assemble(ell, gs, (C,), dtype).t())


def pg_grad_ell(A_perm, planes, ell: EllMatrix):
    """``sum_i (x_i / pred_i) * B_i`` per row: the PG data term
    ([n_rows_ell, k])."""
    k = A_perm.shape[1]
    parts = [kernels.sweep("pg_bucket", bg, b.vals,
                           _bucket_x(A_perm, b).t()).t()
             for b, bg in zip(ell.buckets, planes)]
    return _assemble(ell, parts, (k,), A_perm.dtype)


def hvp_ell(V_perm, planes, ell: EllMatrix, w2s, l2_reg: float):
    """Exact Hessian-vector product with cached curvature weights ``w2``:
    ``(H v)_r = 2*l2*v_r + sum_i w2_ri * <B_i, v_r> * B_i``."""
    k = V_perm.shape[1]
    outs = [kernels.sweep("hvp_bucket", bg, w2, _bucket_x(V_perm, b).t(),
                          want_bv=False)[0].t()
            for b, bg, w2 in zip(ell.buckets, planes, w2s)]
    data = _assemble(ell, outs, (k,), V_perm.dtype)
    return 2.0 * l2_reg * V_perm + data


def hvp_bv_ell(V_perm, planes, ell: EllMatrix, w2s, l2_reg: float):
    """:func:`hvp_ell` that also returns the per-bucket ``<B, v>`` planes
    ([P, R_b], the layout of :func:`bdot_ell`'s output, in ``V_perm``'s
    dtype) - the TNCG inner CG accumulates the line search's direction
    plane from them."""
    k = V_perm.shape[1]
    outs, bvs = [], []
    for b, bg, w2 in zip(ell.buckets, planes, w2s):
        out, bv = kernels.sweep("hvp_bucket", bg, w2,
                                _bucket_x(V_perm, b).t(), want_bv=True)
        outs.append(out.t())
        bvs.append(bv.to(V_perm.dtype))
    data = _assemble(ell, outs, (k,), V_perm.dtype)
    return 2.0 * l2_reg * V_perm + data, tuple(bvs)


def bdot_ell(D_perm, planes, ell: EllMatrix):
    """Per-bucket ``<B_col, d_row>`` planes [P, R_b] for a direction
    D_perm (plain PyTorch: a full plane sweep)."""
    out = []
    for b, bg in zip(ell.buckets, planes):
        D_T = _bucket_x(D_perm, b).t()  # [k, R_b]
        out.append((bg * D_T[:, None, :]).sum(0))
    return tuple(out)


def f_gtd_ray_multi_ell(alphas, coef, pxs, bds, ell: EllMatrix,
                        l2_reg: float, w_mult: float = 1.0,
                        l2_in_f: bool = True):
    """Complete (f, g(trial).d) at C candidate steps along the ray
    ``x + alpha*d`` in one px/pd/vals stream per bucket.  ``alphas``
    [C, n_rows_ell] -> (f [C, n_rows_ell], gtd [C, n_rows_ell]).  A
    non-positive trial prediction poisons its row with inf/NaN."""
    from .objective import combine_f_gtd_ray

    dtype = alphas.dtype
    C = alphas.shape[0]
    nlls, guds = [], []
    for b, px, pd in zip(ell.buckets, pxs, bds):
        a_b = _bucket_x(alphas.t(), b).t()  # [C, R_b]
        nll, gud = kernels.ray("raygtd_multi_bucket", px, pd, b.vals, a_b)
        nlls.append(nll.t())
        guds.append(gud.t())
    # all C candidates assemble at once as [n_rows_ell, C] columns
    nll = _assemble(ell, nlls, (C,), dtype).t()
    gud = _assemble(ell, guds, (C,), dtype).t()
    return combine_f_gtd_ray(nll, gud, alphas, coef, l2_reg, w_mult, l2_in_f)


def f_gtd_ray_ell(alpha, coef, pxs, bds, ell: EllMatrix, l2_reg: float,
                  w_mult: float = 1.0, l2_in_f: bool = True):
    """(f, g(trial).d) at one step per row along the ray ``x + alpha*d``
    from the cached prediction planes ``pxs`` and ``<B, d>`` planes
    ``bds``: no [k, P, R] read.  ``alpha`` [n_rows_ell] -> (f, gtd), each
    [n_rows_ell]; exact while the step stays within the first bound
    crossing.  A non-positive trial prediction poisons its row."""
    from .objective import combine_f_gtd_ray

    dtype = alpha.dtype
    a_col = alpha[:, None]
    nlls, guds = [], []
    for b, px, pd in zip(ell.buckets, pxs, bds):
        # a_b [1, R_b]
        nll, gud = kernels.ray("ray_bucket", px, pd, b.vals,
                               _bucket_x(a_col, b).t())
        nlls.append(nll)
        guds.append(gud)
    nll = _assemble(ell, nlls, (), dtype)
    gud = _assemble(ell, guds, (), dtype)
    return combine_f_gtd_ray(nll, gud, alpha, coef, l2_reg, w_mult, l2_in_f)


def f_ray_multi_ell(alphas, coef, pxs, bds, ell: EllMatrix, l2_reg: float,
                    w_mult: float = 1.0, l2_in_f: bool = True):
    """Trial objective at C candidate steps along the ray ``x + alpha*d``
    in one px/pd/vals stream per bucket (CG's fixed backtracking
    sequence; the CG objective keeps the l2 penalty in f, ``l2_in_f``).
    ``alphas`` [C, n_rows_ell] -> f [C, n_rows_ell], with the same
    poisoning as :func:`f_gtd_ray_multi_ell`."""
    from .objective import combine_f_ray

    C = alphas.shape[0]
    nlls = [kernels.ray("rayf_multi_bucket", px, pd, b.vals,
                        _bucket_x(alphas.t(), b).t()).t()
            for b, px, pd in zip(ell.buckets, pxs, bds)]
    nll = _assemble(ell, nlls, (C,), alphas.dtype).t()
    return combine_f_ray(nll, alphas, coef, l2_reg, w_mult, l2_in_f)


def bd_zeros_ell(ell: EllMatrix, dtype=torch.float32):
    """Zeroed per-bucket [P, R_b] planes (the pd accumulator's init)."""
    return tuple(torch.zeros(b.vals.shape, dtype=dtype, device=ell.device)
                 for b in ell.buckets)


def bd_axpy_ell(bds, m, bvs, ell: EllMatrix):
    """``bd += m[row] * bv`` per bucket, with the per-row multiplier ``m``
    read through each bucket's source mapping."""
    out = []
    for b, bd, bv in zip(ell.buckets, bds, bvs):
        m_b = _bucket_x(m[:, None], b)[:, 0]
        out.append(bd + m_b[None, :] * bv)
    return tuple(out)


def bd_select_ell(use_first, bd1s, bds, ell: EllMatrix):
    """Per-row plane select: rows flagged in ``use_first`` take their
    ``bd1`` plane slice, the rest keep ``bd``."""
    uf = use_first.to(torch.float32)
    out = []
    for b, bd1, bd in zip(ell.buckets, bd1s, bds):
        u_b = _bucket_x(uf[:, None], b)[:, 0] > 0.5
        out.append(torch.where(u_b[None, :], bd1, bd))
    return tuple(out)


def adjusted_bsum_ell(planes, ell: EllMatrix, Bsum, w_mult: float):
    """Per-row weighted Bsum in permuted order:
    ``Bsum + (w_mult - 1) * sum_{i in nnz(r)} B_i``; padding entries are
    masked via ``vals > 0``.  Returns [n_rows_ell, k]."""
    parts = []
    for b, bg in zip(ell.buckets, planes):
        valid = (b.vals > 0).to(Bsum.dtype)
        parts.append((valid[None] * bg).sum(1).t())
    k = planes[0].shape[0] if planes else Bsum.shape[-1]
    row_b = _assemble(ell, parts, (k,), Bsum.dtype)
    return Bsum[None, :] + (w_mult - 1.0) * row_b


def permute_rows(M: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """M[perm] with out-of-range (sentinel) positions yielding zero rows -
    moves factor matrices between original and ELL row order."""
    n = M.shape[0]
    valid = perm < n
    return torch.where(valid[:, None], M[perm.clamp(max=n - 1)], 0)


# ---------------------------------------------------------------------------
# Active-set compaction: once few rows remain active, a compact sub-ELL
# with fixed capacities (a 1/denom share of each bucket) finishes them at a
# fraction of a full sweep's cost.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CompactPlan:
    """Capacities of a compact sub-ELL."""

    caps: Tuple[int, ...]  # rows per compact bucket
    offsets: Tuple[int, ...]  # compact slot offset per bucket
    n_slots: int  # total compact slots (incl. zero tail)
    denom: int  # capacity divisor used


def plan_compact(ell: EllMatrix, denom: int = 8) -> CompactPlan:
    caps, offsets = [], []
    off = 0
    for b in ell.buckets:
        cap = _ceil_to(max(b.n_rows // denom, 1), ROW_TILE)
        offsets.append(off)
        caps.append(cap)
        off += cap
    return CompactPlan(caps=tuple(caps), offsets=tuple(offsets),
                       n_slots=off + ROW_TILE, denom=denom)


def _ladder_ceil(want: int) -> int:
    """Smallest member of the ROW_TILE-multiple ladder {128, 256, 384,
    512, 768, 1024, 1536, ...} (1.5x spacing above 256) that is >=
    ``want``."""
    if want <= ROW_TILE:
        return ROW_TILE
    v = 2 * ROW_TILE
    while v < want:
        v3 = v + v // 2  # a ROW_TILE multiple for v >= 2 * ROW_TILE
        if v3 >= want:
            return v3
        v <<= 1
    return v


def plan_compact_from_profile(ell: EllMatrix, per_bucket_active,
                              margin: float = 2.0,
                              max_slot_frac: float = 0.7
                              ) -> Optional[CompactPlan]:
    """A compact plan sized from an observed per-bucket count of active
    rows (uniform plans reject tails whose stragglers cluster in one
    bucket, typically the long-row heads): caps ``margin`` times the
    counts, raised to the :func:`_ladder_ceil` ladder and clamped to each
    bucket's rows.  None when the plan would cost ``max_slot_frac`` of
    the full structure's slots or more.  ``denom`` 0 marks such a plan."""
    caps, offsets = [], []
    off = cost = full_cost = 0
    for b, c in zip(ell.buckets, per_bucket_active):
        cap = min(b.n_rows, _ladder_ceil(max(int(margin * int(c)),
                                             ROW_TILE)))
        offsets.append(off)
        caps.append(cap)
        off += cap
        cost += cap * b.P
        full_cost += b.n_rows * b.P
    if cost >= max_slot_frac * full_cost:
        return None
    return CompactPlan(caps=tuple(caps), offsets=tuple(offsets),
                       n_slots=off + ROW_TILE, denom=0)


def select_active(ell: EllMatrix, plan: CompactPlan, active: np.ndarray,
                  row_nnz_host: np.ndarray,
                  src_host: Sequence[Optional[np.ndarray]]):
    """Host-side selection of the still-active rows into the compact
    layout.  A bucket row is selected iff its source row (itself, or its
    long-row primary) is active.  Returns None if any bucket overflows its
    capacity, else (sel [per bucket], src_c [per bucket or None],
    slot_map, row_nnz_c, n_primary) host index arrays."""
    compact_of_orig = np.full(ell.n_rows_ell, plan.n_slots - 1,
                              dtype=np.int64)
    sels = []
    selected = []
    slot_map = np.full(plan.n_slots, ell.n_rows_ell - 1, dtype=np.int64)
    row_nnz_c = np.zeros(plan.n_slots, dtype=np.int32)
    n_primary = 0
    for b, cap, coff, srch in zip(ell.buckets, plan.caps, plan.offsets,
                                  src_host):
        m = (active[b.offset : b.offset + b.n_rows] if srch is None
             else active[srch])
        idx = np.nonzero(m)[0]
        if idx.shape[0] > cap:
            return None
        sel = np.full(cap, b.n_rows, dtype=np.int64)  # fill -> out of range
        sel[: idx.shape[0]] = idx
        sels.append(sel)
        compact_slots = coff + np.arange(idx.shape[0], dtype=np.int64)
        if srch is None:
            orig_slots = b.offset + idx.astype(np.int64)
            compact_of_orig[orig_slots] = compact_slots
            slot_map[compact_slots] = orig_slots
            row_nnz_c[compact_slots] = row_nnz_host[orig_slots]
            n_primary += idx.shape[0]
            selected.append((idx, None))
        else:
            orig_src = srch[idx].astype(np.int64)
            own = orig_src == (b.offset + idx.astype(np.int64))
            prim_slots = compact_slots[own]
            orig_prim = orig_src[own]
            compact_of_orig[orig_prim] = prim_slots
            slot_map[prim_slots] = orig_prim
            row_nnz_c[prim_slots] = row_nnz_host[orig_prim]
            n_primary += int(own.sum())
            selected.append((idx, orig_src))
    src_cs = []
    for (idx, orig_src), cap in zip(selected, plan.caps):
        if orig_src is None:
            src_cs.append(None)
        else:
            src_c = np.full(cap, plan.n_slots - 1, dtype=np.int64)
            src_c[: idx.shape[0]] = compact_of_orig[orig_src]
            src_cs.append(src_c)
    return sels, src_cs, slot_map, row_nnz_c, n_primary


def build_compact(ell: EllMatrix, plan: CompactPlan, sels, src_cs,
                  slot_map, row_nnz_c) -> EllMatrix:
    """The compact EllMatrix, with its edge data gathered on the device
    from the parent buckets; only the small index arrays cross from the
    host.  ``perm`` (= ``inv_perm``) is the compact-slot -> parent-slot
    map; ``n_rows`` is 0 (compact solves ignore the early-stop share)."""
    dev = ell.device
    buckets = []
    asm = assembly([(coff, cap, src_c, None) for cap, coff, src_c
                    in zip(plan.caps, plan.offsets, src_cs)], plan.n_slots,
                   dev)
    for b, cap, coff, sel, src_c in zip(ell.buckets, plan.caps,
                                        plan.offsets, sels, src_cs):
        sel_d = profiling.to_device(sel, dev, "cascade.build")
        ok = sel_d < b.n_rows
        sel_c = sel_d.clamp(max=b.n_rows - 1)
        cols_c = torch.where(ok[:, None], b.cols[sel_c], 0)
        vals_c = torch.where(ok[None, :], b.vals[:, sel_c], 0)
        buckets.append(EllBucket(
            offset=coff, n_rows=cap, P=b.P, cols=cols_c, vals=vals_c,
            src=None if src_c is None else profiling.to_device(
                src_c, dev, "cascade.build"),
        ))
    slot_map_d = profiling.to_device(slot_map, dev, "cascade.build")
    return EllMatrix(
        buckets=tuple(buckets), perm=slot_map_d, inv_perm=slot_map_d,
        row_nnz_perm=profiling.to_device(row_nnz_c, dev, "cascade.build"),
        n_rows=0,
        n_cols=ell.n_cols, nnz=ell.nnz, n_rows_pad=ell.n_rows_ell,
        n_rows_ell=plan.n_slots, asm=asm,
    )


def scatter_back(x_full, x_compact, slot_map, row_nnz_c):
    """Write the compact solve's rows back into the full ELL-space matrix.
    Fill slots all map to the parent zero tail and carry zeros, so the
    duplicate writes there agree."""
    out = x_full.clone()
    valid = (row_nnz_c > 0)[:, None]
    out[slot_map] = torch.where(valid, x_compact, 0)
    return out
