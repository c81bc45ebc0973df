// fg: the CG solver's fused f / gradient evaluation of one ELL bucket, and
// f: the same objective without the gradient (line-search trials).
//
// fg replaces poismf_tpu/ops/pallas_kernels.py fg_bucket (def :216,
// pallas_call :238, body _fg_kernel :188-210); f replaces f_bucket (def
// :320, pallas_call :324, body _f_kernel :304-316).  Per row r and slot p:
//   pred = sum_k bg[k,p,r] * a[k,r]
//   nll  = -sum_p x * log(pred)                   (UNfloored log)
//   grad = -sum_p (x / max(pred, eps)) * bg        [k, R]   (fg only)
// and, when px is not null (fg only), writes the raw prediction plane
// px = pred that seeds the ray line search.  Unlike fgh the log is not
// floored: a non-positive prediction at a positive count gives +inf or NaN
// in nll, which is how the line search rejects a trial.  The gradient
// weights keep the floor, so grad stays finite there.  Slots with x <= 0
// (padding) contribute nothing, by selection, never by a multiply.
//
// Bound by bytes: it streams bg once (k * itemsize bytes a slot) plus
// vals, and writes px (4 bytes a slot) when asked; ~4 flops per plane
// element for fg, 2 for f.
//
// Design: plane_sweep.cuh.  fg has the one weight w = x / max(pred, eps)
// and one register sum per owned (k, row), -w b; the log sum over P is
// kept per thread and added over the block's k groups in a fixed order;
// the first k chunk's blocks write the nll row and px, for every slot of
// their split, padding included.  A valid slot whose prediction is +inf
// has w = 0 and is skipped in pass 2, where it would add exactly nothing;
// its log term was already taken with the weights.  f is the same sweep
// with no register sum: pass 1 and the log sum only, one k chunk of
// blocks.  Both copy whole tiles, so f reads the padding's bg too.

#include "plane_sweep.cuh"

namespace poismf {
namespace {

struct FgOp {
  static constexpr int NW = 1;    // slot weight: w
  static constexpr int NACC = 1;  // register sum: grad
  static constexpr bool LOGSUM = true;
  float* px;  // [P, R] or null

  __device__ __forceinline__ void weights(float pred, float x, size_t off,
                                          bool write, float* wt, int,
                                          float& logsum) const {
    const bool valid = x > 0.f;
    if (write && px != nullptr) px[off] = pred;
    if (valid) logsum += x * logf(pred);
    wt[0] = valid ? x / floor_eps(pred) : 0.f;
  }
  static __device__ __forceinline__ bool skip(const float* w) {
    return w[0] == 0.f;
  }
  static __device__ __forceinline__ void accumulate(
      float (&acc)[NACC][SWEEP_KPT], int j, float b, const float* w) {
    acc[0][j] += (-w[0]) * b;
  }
  // out is a split's [1 + k, R] block: nll row, then grad
  static __host__ __device__ __forceinline__ int out_rows(int k) {
    return 1 + k;
  }
  static __device__ __forceinline__ void store(
      float* o, const float (&acc)[NACC][SWEEP_KPT], int j, int kk, int,
      int R, int r) {
    o[(size_t)(1 + kk) * R + r] = acc[0][j];
  }
};

struct FOp {
  static constexpr int NW = 0;    // no slot weights,
  static constexpr int NACC = 0;  // no register sums: no pass 2
  static constexpr bool LOGSUM = true;

  __device__ __forceinline__ void weights(float pred, float x, size_t, bool,
                                          float*, int, float& logsum) const {
    if (x > 0.f) logsum += x * logf(pred);
  }
  // out is a split's [1, R] nll row
  static __host__ __device__ __forceinline__ int out_rows(int) { return 1; }
};

}  // namespace
}  // namespace poismf

// out: [1 + k, R] f32 (nll, grad); px: [P, R] f32 or null; scratch:
// [splits, 1 + k, R] f32 when P is split, else unused.  kg, pt, stages,
// p_per_split: the launch plan (kernels/_lib.sweep_plan).
extern "C" int poismf_fg(const void* bg, int bg_bf16, const void* vals,
                         const void* a_t, void* out, void* px, void* scratch,
                         int k, int P, int R, int kg, int pt, int stages,
                         int p_per_split, void* stream) {
  const poismf::FgOp op{static_cast<float*>(px)};
  return poismf::launch_sweep_as(bg, bg_bf16, vals, a_t, out, scratch, op, k,
                                 P, R, kg, pt, stages, p_per_split, stream);
}

// out: [R] f32 (nll); scratch: [splits, R] f32 when P is split.
extern "C" int poismf_f(const void* bg, int bg_bf16, const void* vals,
                        const void* a_t, void* out, void* scratch, int k,
                        int P, int R, int kg, int pt, int stages,
                        int p_per_split, void* stream) {
  return poismf::launch_sweep_as(bg, bg_bf16, vals, a_t, out, scratch,
                                 poismf::FOp{}, k, P, R, kg, pt, stages,
                                 p_per_split, stream);
}

// Shared memory of one fg (f) block at this plan, and how many fit on an
// SM (0 when it exceeds what a block may use).
extern "C" int poismf_fg_occupancy(int bg_bf16, int k, int kg, int pt,
                                   int stages, int* smem, int* blocks) {
  return poismf::sweep_occupancy_as<poismf::FgOp>(bg_bf16, k, kg, pt, stages,
                                                  smem, blocks);
}

extern "C" int poismf_f_occupancy(int bg_bf16, int k, int kg, int pt,
                                  int stages, int* smem, int* blocks) {
  return poismf::sweep_occupancy_as<poismf::FOp>(bg_bf16, k, kg, pt, stages,
                                                 smem, blocks);
}
