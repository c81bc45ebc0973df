// f_gtd: a line-search trial's objective and directional-derivative data
// terms for one ELL bucket, with <B, d> either read from a hoisted [P, R]
// plane ("bd plane") or computed from the same bg read ("fused").
//
// The bd-plane instance replaces poismf_tpu/ops/pallas_kernels.py
// f_gtd_bucket (def :370, pallas_call :374, body _f_gtd_kernel :350-366);
// the fused one replaces f_gtd_fused_bucket (def :435, pallas_call :445,
// body _f_gtd_fused_kernel :414-431).  Per row r and slot p, at the trial
// a[k, r] and the direction d[k, r]:
//   pred = sum_k bg[k,p,r] * a[k,r]
//   bd   = sum_k bg[k,p,r] * d[k,r]        (fused) or bd[p, r] (bd plane)
//   nll  = -sum_p x * log(pred)                   (UNfloored log)
//   gud  =  sum_p x * bd / max(pred, eps)
// A non-positive prediction at a positive count gives +inf or NaN in nll,
// which is how the line search rejects the trial; the ratio keeps the
// floor (a NaN passes through it, as jnp.maximum lets it), and x * bd is
// formed before the division, as the TPU kernel forms it.  Slots with
// x <= 0 (padding) contribute nothing, by selection.
//
// Bound by bytes: one read of bg (k * itemsize bytes a slot) plus vals,
// and the 4-byte bd plane in the hoisted variant; 2 (4 fused) flops per
// plane element and a log and a division per nonzero slot.
//
// Design: plane_sweep.cuh without pass 2 (no register sums, one k chunk
// of blocks), as f in fg.cu, with two row sums (the log sum and g.d) kept
// by the thread that owns a slot's weights and added over the block's k
// groups in a fixed order.  The bd-plane instance copies the bd tile with
// the vals tile, a second [PT, 64] box in the same ring stage; the fused
// one reads each staged bg element once for two multiply-adds, against
// the trial's and the direction's values in registers (both factor
// blocks in shared memory when k spans several chunks, which lowers its
// k limit to 256 in bf16 and 192 in f32).  Both copy whole tiles, so they
// read the padding's bg too.

#include "plane_sweep.cuh"

namespace poismf {
namespace {

// dots: pred, against a_t (and bd, against d_t, fused)
template <bool FUSED>
struct FGtdOp : SweepRows<FUSED ? 2 : 1> {
  static constexpr int NW = 0;    // no slot weights,
  static constexpr int NACC = 0;  // no register sums: no pass 2
  static constexpr int NSLOT = FUSED ? 1 : 2;  // vals (and the bd plane)
  static constexpr int NSUM = 2;  // row sums: the log sum, g.d

  __device__ __forceinline__ void weights(const float* dot, const float* slot,
                                          size_t, bool, float*, int,
                                          float* sums) const {
    const float pred = dot[0], x = slot[0];
    const float bd = FUSED ? dot[1] : slot[1];
    if (x > 0.f) {
      sums[0] += x * logf(pred);
      sums[1] += (x * bd) / floor_eps(pred);
    }
  }
  // out is a split's [2, R] block: the nll row (the log sum, negated),
  // then the gud row
  static __host__ __device__ __forceinline__ int out_rows(int) { return 2; }
  __device__ __forceinline__ void store_sum(float* o, int s, float t, int R,
                                            int r) const {
    o[(size_t)s * R + r] = s == 0 ? -t : t;
  }
};

}  // namespace
}  // namespace poismf

// bd: the [P, R] f32 <B, d> plane; out: [2, R] f32 (nll, gud); scratch:
// [splits, 2, R] f32 when P is split, else unused.  kg, pt, stages,
// p_per_split: the launch plan (kernels/_lib.sweep_plan).
extern "C" int poismf_f_gtd(const void* bg, int bg_bf16, const void* vals,
                            const void* a_t, const void* bd, void* out,
                            void* scratch, int k, int P, int R, int kg,
                            int pt, int stages, int p_per_split,
                            void* stream) {
  return poismf::launch_sweep_as(bg, bg_bf16, vals, a_t, out, scratch,
                                 poismf::FGtdOp<false>{}, k, P, R, kg, pt,
                                 stages, p_per_split, stream, bd, nullptr);
}

// d_t: the [k, R] f32 direction; otherwise as poismf_f_gtd.
extern "C" int poismf_f_gtd_fused(const void* bg, int bg_bf16,
                                  const void* vals, const void* a_t,
                                  const void* d_t, void* out, void* scratch,
                                  int k, int P, int R, int kg, int pt,
                                  int stages, int p_per_split, void* stream) {
  return poismf::launch_sweep_as(bg, bg_bf16, vals, a_t, out, scratch,
                                 poismf::FGtdOp<true>{}, k, P, R, kg, pt,
                                 stages, p_per_split, stream, nullptr, d_t);
}

// Shared memory of one f_gtd (f_gtd_fused) block at this plan, how many
// fit on an SM (0 when it exceeds what a block may use), the bytes of a
// ring stage, the blocks along k and the slot planes a launch takes.
extern "C" int poismf_f_gtd_occupancy(int bg_bf16, int k, int kg, int pt,
                                      int stages, int* smem, int* blocks,
                                      int* stage_bytes, int* blocks_k,
                                      int* slot_planes) {
  return poismf::sweep_occupancy_as<poismf::FGtdOp<false>>(
      bg_bf16, k, kg, pt, stages, smem, blocks, stage_bytes, blocks_k,
      slot_planes);
}

extern "C" int poismf_f_gtd_fused_occupancy(int bg_bf16, int k, int kg,
                                            int pt, int stages, int* smem,
                                            int* blocks, int* stage_bytes,
                                            int* blocks_k, int* slot_planes) {
  return poismf::sweep_occupancy_as<poismf::FGtdOp<true>>(
      bg_bf16, k, kg, pt, stages, smem, blocks, stage_bytes, blocks_k,
      slot_planes);
}
