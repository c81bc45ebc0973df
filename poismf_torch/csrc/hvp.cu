// hvp: the TNCG inner-CG Hessian-vector product of one ELL bucket, with an
// optional <B, v> plane output.
//
// Replaces poismf_tpu/ops/pallas_kernels.py hvp_bucket (def :851,
// pallas_call :855) and hvp_bv_bucket (def :875, pallas_call :886), whose
// shared body is _hvp_kernel (:830-847).  Per row r and slot p:
//   bv  = sum_k bg[k,p,r] * v[k,r]          (written out when bv != null)
//   out = sum_p (w2 * bv) * bg              [k, R]
//
// Bound by bytes: one read of bg (k * itemsize bytes a slot) plus w2, and
// a 4-byte bv write in the accumulating variant; ~4 flops per plane
// element.
//
// Design: plane_sweep.cuh, with one slot weight t = w2 * bv and one
// register sum per owned (k, row): t b.  A slot with t == 0 (padding
// slots have w2 = 0) adds exactly nothing for finite planes and is
// skipped; a NaN or inf t still goes through.

#include "plane_sweep.cuh"

namespace poismf {
namespace {

struct HvpOp : SweepRows<1> {  // dot: <B, v>, against v_t
  static constexpr int NW = 1;    // slot weight: w2 <B, v>
  static constexpr int NACC = 1;  // register sum: the product
  static constexpr int NSLOT = 1;  // slot plane: w2
  static constexpr int NSUM = 0;  // no row sum
  float* bv;  // [P, R] or null

  __device__ __forceinline__ void weights(const float* dot, const float* slot,
                                          size_t off, bool write, float* wt,
                                          int, float*) const {
    if (write && bv != nullptr) bv[off] = dot[0];
    wt[0] = slot[0] * dot[0];
  }
  static __device__ __forceinline__ bool skip(const float* w) {
    return w[0] == 0.f;
  }
  static __device__ __forceinline__ void accumulate(
      float (&acc)[NACC][SWEEP_KPT], int j, float b, const float* w) {
    acc[0][j] += w[0] * b;
  }
  static __host__ __device__ __forceinline__ int out_rows(int k) { return k; }
  static __device__ __forceinline__ void store(
      float* o, const float (&acc)[NACC][SWEEP_KPT], int j, int kk, int,
      int R, int r) {
    o[(size_t)kk * R + r] = acc[0][j];
  }
};

}  // namespace
}  // namespace poismf

// out: [k, R] f32; bv: [P, R] f32 or null; scratch: [splits, k, R] f32
// when P is split, else unused.  kg, pt, stages, p_per_split: the launch
// plan (kernels/_lib.sweep_plan).
extern "C" int poismf_hvp(const void* bg, int bg_bf16, const void* w2,
                          const void* v_t, void* out, void* bv, void* scratch,
                          int k, int P, int R, int kg, int pt, int stages,
                          int p_per_split, void* stream) {
  const poismf::HvpOp op{{}, static_cast<float*>(bv)};
  return poismf::launch_sweep_as(bg, bg_bf16, w2, v_t, out, scratch, op, k, P,
                                 R, kg, pt, stages, p_per_split, stream);
}

// Shared memory of one hvp block at this plan, and how many fit on an SM
// (0 when it exceeds what a block may use), with the stage bytes, blocks
// along k and slot planes of the launch (sweep_occupancy).
extern "C" int poismf_hvp_occupancy(int bg_bf16, int k, int kg, int pt,
                                    int stages, int* smem, int* blocks,
                                    int* stage_bytes, int* blocks_k,
                                    int* slot_planes) {
  return poismf::sweep_occupancy_as<poismf::HvpOp>(
      bg_bf16, k, kg, pt, stages, smem, blocks, stage_bytes, blocks_k,
      slot_planes);
}
