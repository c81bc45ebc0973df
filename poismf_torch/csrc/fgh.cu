// fgh: the TNCG outer iteration's fused evaluation of one ELL bucket.
//
// Replaces poismf_tpu/ops/pallas_kernels.py fgh_bucket (def :129,
// pallas_call :164, body _fgh_kernel :95-123).  Per row r and slot p:
//   pred = sum_k bg[k,p,r] * a[k,r]
//   nll  = -sum_p x * log(max(pred, eps))        (floored log)
//   grad = -sum_p (x / safe) * bg                 [k, R]
//   diag =  sum_p w_mult * x / safe^2 * bg^2      [k, R]
// and writes the planes w2 = w_mult * x / safe^2 and px = pred (raw,
// unfloored: the ray line search must see non-positive predictions).
// Slots with x <= 0 (padding) contribute nothing, by selection.
//
// Bound by bytes: it streams bg once (k * itemsize bytes a slot, 100 at
// k=50 in bf16) plus vals, and writes w2 and px (4 + 4 + 4 bytes a slot);
// its arithmetic is ~5 flops per plane element.  It reads every slot, the
// padding included, since it writes both planes for every slot.
//
// Design: plane_sweep.cuh, with the weights w = x / safe and w2 (one
// shared reciprocal, as the TPU kernel does) and two register sums per
// owned (k, row): -w b and w2 b^2.  The log sum over P is kept per thread
// and added over the block's k groups in a fixed order; the first k
// chunk's blocks write the nll row and the two planes.

#include "plane_sweep.cuh"

namespace poismf {
namespace {

struct FghOp : SweepRows<1> {  // dot: pred, against a_t
  static constexpr int NW = 2;    // slot weights: w, w2
  static constexpr int NACC = 2;  // register sums: grad, diag
  static constexpr int NSLOT = 1;  // slot plane: vals
  static constexpr int NSUM = 1;  // row sum: the log sum
  float w_mult;
  float* w2;  // [P, R]
  float* px;  // [P, R] or null

  __device__ __forceinline__ void weights(const float* dot, const float* slot,
                                          size_t off, bool write, float* wt,
                                          int stride, float* sums) const {
    const float pred = dot[0], x = slot[0];
    const bool valid = x > 0.f;
    const float safe = floor_eps(pred);
    const float recip = 1.f / safe;
    const float w = valid ? x * recip : 0.f;
    const float w2v = valid ? (w_mult * x) * (recip * recip) : 0.f;
    if (write) {
      w2[off] = w2v;
      if (px != nullptr) px[off] = pred;
    }
    if (valid) sums[0] += x * logf(safe);
    wt[0] = w;
    wt[stride] = w2v;
  }
  static __device__ __forceinline__ bool skip(const float* w) {
    return w[0] == 0.f && w[1] == 0.f;
  }
  static __device__ __forceinline__ void accumulate(
      float (&acc)[NACC][SWEEP_KPT], int j, float b, const float* w) {
    acc[0][j] += (-w[0]) * b;
    acc[1][j] += w[1] * (b * b);
  }
  // out is a split's [1 + 2k, R] block: nll row, then grad, then diag
  static __host__ __device__ __forceinline__ int out_rows(int k) {
    return 1 + 2 * k;
  }
  // the nll row: the log sum, negated
  __device__ __forceinline__ void store_sum(float* o, int, float t, int,
                                            int r) const {
    o[r] = -t;
  }
  static __device__ __forceinline__ void store(
      float* o, const float (&acc)[NACC][SWEEP_KPT], int j, int kk, int k,
      int R, int r) {
    o[(size_t)(1 + kk) * R + r] = acc[0][j];
    o[(size_t)(1 + k + kk) * R + r] = acc[1][j];
  }
};

}  // namespace
}  // namespace poismf

// out: [1 + 2k, R] f32 (nll, grad, diag); w2 / px: [P, R] f32 (px may be
// null); scratch: [splits, 1 + 2k, R] f32 when P is split, else unused.
// kg, pt, stages, p_per_split: the launch plan (kernels/_lib.sweep_plan).
extern "C" int poismf_fgh(const void* bg, int bg_bf16, const void* vals,
                          const void* a_t, void* out, void* w2, void* px,
                          void* scratch, int k, int P, int R, int kg, int pt,
                          int stages, int p_per_split, float w_mult,
                          void* stream) {
  const poismf::FghOp op{{}, w_mult, static_cast<float*>(w2),
                         static_cast<float*>(px)};
  return poismf::launch_sweep_as(bg, bg_bf16, vals, a_t, out, scratch, op, k,
                                 P, R, kg, pt, stages, p_per_split, stream);
}

// Shared memory of one fgh block at this plan, and how many fit on an SM
// (0 when it exceeds what a block may use), with the stage bytes, blocks
// along k and slot planes of the launch (sweep_occupancy).
extern "C" int poismf_fgh_occupancy(int bg_bf16, int k, int kg, int pt,
                                    int stages, int* smem, int* blocks,
                                    int* stage_bytes, int* blocks_k,
                                    int* slot_planes) {
  return poismf::sweep_occupancy_as<poismf::FghOp>(
      bg_bf16, k, kg, pt, stages, smem, blocks, stage_bytes, blocks_k,
      slot_planes);
}

// The plane sweeps' fixed shape, for the wrappers' launch plans: rows per
// block, k values a thread sums in registers, most k groups a block has.
extern "C" void poismf_sweep_shape(int* rows, int* kpt, int* max_kg) {
  *rows = poismf::SWEEP_TR;
  *kpt = poismf::SWEEP_KPT;
  *max_kg = poismf::SWEEP_MAX_KG;
}
