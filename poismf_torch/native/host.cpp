// Native host-side data-preparation kernels for poismf_torch (a copy of
// poismf_tpu/native/host.cpp, kept so the PyTorch port never imports the
// JAX package).
//
// The hot host-side ingestion step is a counting sort of the COO triplets
// by row (O(nnz), stable).  Exposed with a plain C ABI and loaded via
// ctypes (native/host.py builds it into build/native/ at first use).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Stable counting sort of COO triplets by row id.
//   rows/cols: int32[nnz], vals: float/double[nnz], n_rows: segment count
//   *_out buffers must be pre-allocated by the caller (nnz each);
//   counts_out: int32[n_rows] per-row nonzero counts.
// Returns 0 on success, 1 on out-of-range row id.
static int sort_by_row_impl_f32(int64_t nnz, const int32_t* rows,
                                const int32_t* cols, const float* vals,
                                int64_t n_rows, int32_t* rows_out,
                                int32_t* cols_out, float* vals_out,
                                int32_t* counts_out) {
  std::vector<int64_t> offsets(n_rows + 1, 0);
  for (int64_t e = 0; e < nnz; ++e) {
    int32_t r = rows[e];
    if (r < 0 || r >= n_rows) return 1;
    ++offsets[r + 1];
  }
  for (int64_t r = 0; r < n_rows; ++r) {
    counts_out[r] = static_cast<int32_t>(offsets[r + 1]);
    offsets[r + 1] += offsets[r];
  }
  std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
  for (int64_t e = 0; e < nnz; ++e) {
    int64_t dst = cursor[rows[e]]++;
    rows_out[dst] = rows[e];
    cols_out[dst] = cols[e];
    vals_out[dst] = vals[e];
  }
  return 0;
}

static int sort_by_row_impl_f64(int64_t nnz, const int32_t* rows,
                                const int32_t* cols, const double* vals,
                                int64_t n_rows, int32_t* rows_out,
                                int32_t* cols_out, double* vals_out,
                                int32_t* counts_out) {
  std::vector<int64_t> offsets(n_rows + 1, 0);
  for (int64_t e = 0; e < nnz; ++e) {
    int32_t r = rows[e];
    if (r < 0 || r >= n_rows) return 1;
    ++offsets[r + 1];
  }
  for (int64_t r = 0; r < n_rows; ++r) {
    counts_out[r] = static_cast<int32_t>(offsets[r + 1]);
    offsets[r + 1] += offsets[r];
  }
  std::vector<int64_t> cursor(offsets.begin(), offsets.end() - 1);
  for (int64_t e = 0; e < nnz; ++e) {
    int64_t dst = cursor[rows[e]]++;
    rows_out[dst] = rows[e];
    cols_out[dst] = cols[e];
    vals_out[dst] = vals[e];
  }
  return 0;
}

int poismf_sort_by_row_f32(int64_t nnz, const int32_t* rows,
                           const int32_t* cols, const float* vals,
                           int64_t n_rows, int32_t* rows_out,
                           int32_t* cols_out, float* vals_out,
                           int32_t* counts_out) {
  return sort_by_row_impl_f32(nnz, rows, cols, vals, n_rows, rows_out,
                              cols_out, vals_out, counts_out);
}

int poismf_sort_by_row_f64(int64_t nnz, const int32_t* rows,
                           const int32_t* cols, const double* vals,
                           int64_t n_rows, int32_t* rows_out,
                           int32_t* cols_out, double* vals_out,
                           int32_t* counts_out) {
  return sort_by_row_impl_f64(nnz, rows, cols, vals, n_rows, rows_out,
                              cols_out, vals_out, counts_out);
}

// Deduplicate (row, col) pairs keeping the FIRST occurrence, preserving
// order of first occurrences.  Used by data ingestion; O(nnz) expected via
// open-addressing hash set.  Returns the deduped count.
int64_t poismf_dedupe_pairs(int64_t nnz, const int32_t* rows,
                            const int32_t* cols, int64_t n_cols,
                            int64_t* keep_idx_out) {
  // open addressing on 64-bit keys
  int64_t cap = 1;
  while (cap < nnz * 2) cap <<= 1;
  std::vector<int64_t> table(cap, -1);
  int64_t kept = 0;
  const uint64_t mask = static_cast<uint64_t>(cap - 1);
  for (int64_t e = 0; e < nnz; ++e) {
    uint64_t key = static_cast<uint64_t>(rows[e]) *
                       static_cast<uint64_t>(n_cols) +
                   static_cast<uint64_t>(cols[e]);
    uint64_t h = key * 0x9E3779B97F4A7C15ull;
    uint64_t slot = (h >> 17) & mask;
    for (;;) {
      int64_t cur = table[slot];
      if (cur == -1) {
        table[slot] = static_cast<int64_t>(key);
        keep_idx_out[kept++] = e;
        break;
      }
      if (cur == static_cast<int64_t>(key)) break;  // duplicate
      slot = (slot + 1) & mask;
    }
  }
  return kept;
}

int poismf_host_abi_version(void) { return 1; }

}  // extern "C"
