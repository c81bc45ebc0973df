"""ctypes loader for the native host-side data-preparation kernels.

Compiles ``host.cpp`` with g++ at first use into ``build/native/`` at the
repository root (git-ignored), keyed on a hash of the source so an edited
source rebuilds.  Every entry point returns None when the library cannot
be built or loaded; callers then take their NumPy path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                          "native")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libpoismf_host-{digest}.so")


def _build(out: str) -> bool:
    """g++ with tuned flags, then a plain -O3 build if those are refused.
    Writes to a temporary name and renames, so concurrent test workers
    never load a half-written library."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        for flags in (["-O3", "-march=native"], ["-O3"]):
            cmd = ["g++", *flags, "-shared", "-fPIC", "-o", tmp, _SRC]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
            except (OSError, subprocess.SubprocessError):
                continue
            os.replace(tmp, out)
            return True
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.poismf_sort_by_row_f32.restype = ctypes.c_int
        lib.poismf_sort_by_row_f32.argtypes = [
            ctypes.c_int64, i32p, i32p, f32p, ctypes.c_int64,
            i32p, i32p, f32p, i32p,
        ]
        lib.poismf_sort_by_row_f64.restype = ctypes.c_int
        lib.poismf_sort_by_row_f64.argtypes = [
            ctypes.c_int64, i32p, i32p, f64p, ctypes.c_int64,
            i32p, i32p, f64p, i32p,
        ]
        lib.poismf_dedupe_pairs.restype = ctypes.c_int64
        lib.poismf_dedupe_pairs.argtypes = [
            ctypes.c_int64, i32p, i32p, ctypes.c_int64, i64p,
        ]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def sort_by_row(
    rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, n_rows: int
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Stable O(nnz) counting sort by row.  Returns None if the native
    library is unavailable or dtypes are unsupported."""
    lib = _load()
    if lib is None:
        return None
    if vals.dtype == np.float32:
        fn, ctyp = lib.poismf_sort_by_row_f32, ctypes.c_float
    elif vals.dtype == np.float64:
        fn, ctyp = lib.poismf_sort_by_row_f64, ctypes.c_double
    else:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals)
    nnz = rows.shape[0]
    rows_out = np.empty(nnz, dtype=np.int32)
    cols_out = np.empty(nnz, dtype=np.int32)
    vals_out = np.empty(nnz, dtype=vals.dtype)
    counts = np.empty(max(n_rows, 1), dtype=np.int32)
    rc = fn(
        nnz, _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        _ptr(vals, ctyp), n_rows, _ptr(rows_out, ctypes.c_int32),
        _ptr(cols_out, ctypes.c_int32), _ptr(vals_out, ctyp),
        _ptr(counts, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return rows_out, cols_out, vals_out, counts[:n_rows]


def dedupe_pairs(
    rows: np.ndarray, cols: np.ndarray, n_cols: int
) -> Optional[np.ndarray]:
    """Indices of first occurrences of each (row, col) pair, in order.
    Returns None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    nnz = rows.shape[0]
    keep = np.empty(nnz, dtype=np.int64)
    kept = lib.poismf_dedupe_pairs(
        nnz, _ptr(rows, ctypes.c_int32), _ptr(cols, ctypes.c_int32),
        n_cols, _ptr(keep, ctypes.c_int64),
    )
    return keep[:kept]
