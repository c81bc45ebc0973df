// pg: the proximal-gradient solver's data term of one ELL bucket.
//
// Replaces poismf_tpu/ops/pallas_kernels.py pg_bucket (def :277,
// pallas_call :281, body _pg_kernel :261-273).  Per row r and slot p:
//   pred = sum_k bg[k,p,r] * a[k,r]
//   out  = sum_p (x / max(pred, eps)) * bg        [k, R]
// (positive sign, no objective).  Slots with x <= 0 (padding) contribute
// nothing, by selection.
//
// Bound by bytes: it streams bg once (k * itemsize bytes a slot, 20 at
// k=10 in bf16) plus vals; ~4 flops per plane element.
//
// Design: plane_sweep.cuh, fg's sweep without the log sum and the px
// plane: one slot weight w = x / max(pred, eps) (zero at the padding) and
// one register sum per owned (k, row), w b.  A slot with w == 0 adds
// exactly nothing for finite planes and is skipped; a NaN w still goes
// through.  At the pg configuration's k = 10 the plan has 2 k groups of 8
// (k rows padded to 16: the copies' zero fill brings rows 10-15, which cost
// no HBM bytes but 6/16 of the tile's shared memory and multiply-adds) and
// 8-slot tiles.

#include "plane_sweep.cuh"

namespace poismf {
namespace {

struct PgOp : SweepRows<1> {  // dot: pred, against a_t
  static constexpr int NW = 1;    // slot weight: x / max(pred, eps)
  static constexpr int NACC = 1;  // register sum: the data term
  static constexpr int NSLOT = 1;  // slot plane: vals
  static constexpr int NSUM = 0;  // no row sum

  __device__ __forceinline__ void weights(const float* dot, const float* slot,
                                          size_t, bool, float* wt, int,
                                          float*) const {
    const float pred = dot[0], x = slot[0];
    wt[0] = x > 0.f ? x / floor_eps(pred) : 0.f;
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

// out: [k, R] f32; scratch: [splits, k, R] f32 when P is split, else
// unused.  kg, pt, stages, p_per_split: the launch plan
// (kernels/_lib.sweep_plan).
extern "C" int poismf_pg(const void* bg, int bg_bf16, const void* vals,
                         const void* a_t, void* out, void* scratch, int k,
                         int P, int R, int kg, int pt, int stages,
                         int p_per_split, void* stream) {
  return poismf::launch_sweep_as(bg, bg_bf16, vals, a_t, out, scratch,
                                 poismf::PgOp{}, k, P, R, kg, pt, stages,
                                 p_per_split, stream);
}

// Shared memory of one pg block at this plan, and how many fit on an SM
// (0 when it exceeds what a block may use), with the stage bytes, blocks
// along k and slot planes of the launch (sweep_occupancy).
extern "C" int poismf_pg_occupancy(int bg_bf16, int k, int kg, int pt,
                                   int stages, int* smem, int* blocks,
                                   int* stage_bytes, int* blocks_k,
                                   int* slot_planes) {
  return poismf::sweep_occupancy_as<poismf::PgOp>(
      bg_bf16, k, kg, pt, stages, smem, blocks, stage_bytes, blocks_k,
      slot_planes);
}
