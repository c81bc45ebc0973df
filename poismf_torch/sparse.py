"""Sparse counts-data layer: host-side ingestion into padded, row-sorted COO.

Counterpart of ``poismf_tpu/sparse.py``.  The arrays stay host NumPy: the
hot loop runs on the planar-ELL layout (:mod:`poismf_torch.ops.ell`), which
is built from these triplets and moved to the device once.  Both
orientations are kept, like the reference's CSR + CSC pair: the by-user
view updates A and the by-item view updates B.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .native import host as _native_host

# Pad the flat nnz stream up to a multiple of this (kept from the JAX
# package so both layouts are identical and comparable).
NNZ_PAD_MULTIPLE = 1024
# Pad row counts to a multiple of this.
ROW_PAD_MULTIPLE = 8


def _pad_to(n: int, multiple: int) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class CountsMatrix:
    """One orientation of a sparse counts matrix as padded flat COO (host).

    ``row_ids`` is sorted ascending.  Padding entries carry ``row_id ==
    n_rows_pad``, ``col_id == 0`` and ``val == 0``."""

    row_ids: np.ndarray  # [nnz_pad] int32, sorted, pad = n_rows_pad
    col_ids: np.ndarray  # [nnz_pad] int32, pad = 0
    vals: np.ndarray  # [nnz_pad] dtype, pad = 0
    row_nnz: np.ndarray  # [n_rows_pad] int32 nonzero count per row
    n_rows: int
    n_cols: int
    nnz: int

    @property
    def n_rows_pad(self) -> int:
        return int(self.row_nnz.shape[0])

    @property
    def nnz_pad(self) -> int:
        return int(self.row_ids.shape[0])

    def triplets(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, vals) without the padding."""
        n = self.nnz
        return self.row_ids[:n], self.col_ids[:n], self.vals[:n]


def _sort_by_row(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Stable sort of the triplets by row; returns sorted arrays + row
    counts.  Native O(nnz) counting sort when available, else argsort."""
    if rows.size > 0:
        out = _native_host.sort_by_row(rows, cols, vals, n_rows)
        if out is not None:
            return out
    order = np.argsort(rows, kind="stable")
    rows_s = rows[order]
    cols_s = cols[order]
    vals_s = vals[order]
    counts = np.bincount(rows_s, minlength=n_rows).astype(np.int32)
    return rows_s, cols_s, vals_s, counts


def dedupe_sum(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_cols: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sum values of duplicate (row, col) pairs, like the reference's
    ``coo.tocsr()`` ingestion.  No-op when there are no duplicates."""
    if rows.size == 0:
        return rows, cols, vals
    key = rows.astype(np.int64) * np.int64(n_cols) + cols
    uniq, inv = np.unique(key, return_inverse=True)
    if uniq.size == rows.size:
        return rows, cols, vals
    summed = np.zeros(uniq.size, dtype=vals.dtype)
    np.add.at(summed, inv, vals)
    return (
        (uniq // n_cols).astype(rows.dtype),
        (uniq % n_cols).astype(cols.dtype),
        summed,
    )


def build_counts(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    dtype=np.float32,
    aggregate_duplicates: bool = True,
) -> CountsMatrix:
    """Build one orientation (row-sorted flat COO) of the counts matrix."""
    rows = np.asarray(rows, dtype=np.int32).reshape(-1)
    cols = np.asarray(cols, dtype=np.int32).reshape(-1)
    vals = np.asarray(vals, dtype=dtype).reshape(-1)
    nnz = int(rows.shape[0])
    if nnz:
        if rows.min() < 0 or rows.max() >= n_rows:
            raise ValueError("row indices out of range")
        if cols.min() < 0 or cols.max() >= n_cols:
            raise ValueError("column indices out of range")
    if aggregate_duplicates:
        rows, cols, vals = dedupe_sum(rows, cols, vals, n_cols)
        nnz = int(rows.shape[0])

    rows_s, cols_s, vals_s, counts = _sort_by_row(rows, cols, vals, n_rows)

    nnz_pad = _pad_to(nnz, NNZ_PAD_MULTIPLE)
    n_rows_pad = _pad_to(n_rows, ROW_PAD_MULTIPLE)

    row_ids = np.full(nnz_pad, n_rows_pad, dtype=np.int32)
    col_ids = np.zeros(nnz_pad, dtype=np.int32)
    data = np.zeros(nnz_pad, dtype=dtype)
    row_ids[:nnz] = rows_s
    col_ids[:nnz] = cols_s
    data[:nnz] = vals_s

    row_nnz = np.zeros(n_rows_pad, dtype=np.int32)
    row_nnz[:n_rows] = counts
    return CountsMatrix(
        row_ids=row_ids, col_ids=col_ids, vals=data, row_nnz=row_nnz,
        n_rows=n_rows, n_cols=n_cols, nnz=nnz,
    )


def build_both_orientations(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_cols: int,
    dtype=np.float32,
) -> Tuple[CountsMatrix, CountsMatrix]:
    """(by-row, by-col) views - the CSR+CSC pair of the reference."""
    rows = np.asarray(rows, dtype=np.int32).reshape(-1)
    cols = np.asarray(cols, dtype=np.int32).reshape(-1)
    vals = np.asarray(vals, dtype=dtype).reshape(-1)
    rows, cols, vals = dedupe_sum(rows, cols, vals, n_cols)
    by_row = build_counts(rows, cols, vals, n_rows, n_cols, dtype,
                          aggregate_duplicates=False)
    by_col = build_counts(cols, rows, vals, n_cols, n_rows, dtype,
                          aggregate_duplicates=False)
    return by_row, by_col


@dataclasses.dataclass
class IngestResult:
    by_user: CountsMatrix
    by_item: CountsMatrix
    n_users: int
    n_items: int
    user_mapping: Optional[np.ndarray]
    item_mapping: Optional[np.ndarray]


def ingest(X, reindex: bool = True, dtype=np.float32) -> IngestResult:
    """Accepts a pandas DataFrame(UserId, ItemId, Count), a SciPy COO
    matrix/array, or a (rows, cols, vals, shape) tuple."""
    user_mapping = None
    item_mapping = None

    if hasattr(X, "tocoo") and hasattr(X, "shape") and not _is_dataframe(X):
        coo = X.tocoo()
        rows, cols, vals = coo.row, coo.col, coo.data
        n_users, n_items = coo.shape
    elif _is_dataframe(X):
        import pandas as pd

        required = ["UserId", "ItemId", "Count"]
        missing = [c for c in required if c not in X.columns]
        if missing:
            raise ValueError("'X' should have columns: " + ", ".join(required))
        if reindex:
            user_codes, user_mapping = pd.factorize(X["UserId"])
            item_codes, item_mapping = pd.factorize(X["ItemId"])
            user_mapping = np.asarray(user_mapping).reshape(-1)
            item_mapping = np.asarray(item_mapping).reshape(-1)
            rows = np.asarray(user_codes)
            cols = np.asarray(item_codes)
        else:
            rows = X["UserId"].to_numpy()
            cols = X["ItemId"].to_numpy()
        vals = X["Count"].to_numpy()
        n_users = int(rows.max()) + 1 if rows.size else 0
        n_items = int(cols.max()) + 1 if cols.size else 0
    elif isinstance(X, tuple) and len(X) == 4:
        rows, cols, vals, (n_users, n_items) = X
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals)
    else:
        raise ValueError(
            "'X' must be a pandas DataFrame, SciPy COO matrix, or "
            "(rows, cols, vals, shape) tuple."
        )

    vals = np.asarray(vals)
    if vals.size and float(np.min(vals)) <= 0:
        raise ValueError("Counts must all be greater than zero.")

    by_user, by_item = build_both_orientations(
        rows, cols, vals, n_users, n_items, dtype=dtype
    )
    return IngestResult(
        by_user=by_user, by_item=by_item, n_users=n_users, n_items=n_items,
        user_mapping=user_mapping, item_mapping=item_mapping,
    )


def _is_dataframe(X) -> bool:
    return type(X).__name__ == "DataFrame"


def csr_like(mat: CountsMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Export (indptr, indices, data) NumPy CSR views (testing/interop)."""
    row_ids, col_ids, vals = mat.triplets()
    indptr = np.zeros(mat.n_rows + 1, dtype=np.int64)
    np.add.at(indptr, row_ids + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, col_ids, vals
