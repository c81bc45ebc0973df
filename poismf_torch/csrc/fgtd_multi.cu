// f_gtd_multi: COMPLETE (f, g(trial).d) of one ELL bucket at C projected
// trials trial_c = max(0, x + alpha_c * d), in one read of the bg plane.
//
// Replaces poismf_tpu/ops/pallas_kernels.py f_gtd_multi_bucket (def :549,
// pallas_call :567, body _f_gtd_multi_kernel :490-542).  Per row r, for
// each candidate c (C <= 8) and slot p:
//   pred_c = sum_k bg[k,p,r] * trial_c[k,r]
//   bd     = sum_k bg[k,p,r] * d[k,r]
//   f_c    = lin_c - w_mult * sum_p x * log(pred_c)          (UNfloored)
//   gtd_c  = lin_d + 2 l2 <trial_c, d> - w_mult * sum_p x * bd / max(pred_c, eps)
// with lin_c = <trial_c, bsum> (+ l2 |trial_c|^2 when l2_in_f) and lin_d =
// <d, bsum>, folded in on the rows that ``fold`` marks (null: every row)
// and on split 0 only, so they enter each row exactly once.  The caller
// marks the primary rows of a bucket: a bucket of long-row extension
// chunks still folds the linear terms of the primary rows it holds (the
// TPU caller folds per bucket and drops them there).  Extension chunks and
// padding rows give data terms only.  bsum is [k] (per_row = 0) or [k, R]
// (per_row = 1).  Slots with x <= 0 (padding) contribute nothing, by
// selection.
//
// The trials are projected, so predictions are not linear in alpha (the
// ray kernels' trick does not apply): each candidate needs its own k-deep
// dot.  Bound by bytes all the same: one read of bg (k * itemsize bytes a
// slot) plus vals carries 2k (C + 1) flops, 22 at C = 4 and bf16 planes,
// and a valid slot C logs and C divisions.
//
// Design: plane_sweep.cuh without pass 2 (one k chunk of blocks), with
// C + 1 dots a slot: each staged bg element read from shared memory feeds
// C + 1 multiply-adds, against the thread's 8 values of k of each trial
// and of d, formed in registers before the sweep.  When k spans several
// chunks only x and d lie in shared memory (as f_gtd_fused's two blocks,
// so the k limits are its own at every C) and the other chunks' trials are
// formed as they are read.  A slot's weights come in C parts, one a
// candidate (a log and a division), spread over the block's k groups, the
// first slots of a thread's parts in straight-line code.  The thread that
// writes a row adds the linear terms over all k of the row, in a fixed
// order.  C is a template parameter (1, 2, 4, 8; a C between runs on the
// next one up, the spare candidates' steps at zero and their sums not
// stored).  Every trial, in registers, from shared memory or for the
// linear terms, is rounded as PyTorch rounds x + (alpha * d): the
// product, then the sum, never one fused multiply-add, so a trial lands
// on zero exactly where the plain version's does.
//
// What holds it (PERF.md, PR 8): from four candidates on, the 8 (C + 1)
// factor values and the row sums take ~128 registers a thread, so an SM
// holds one block (14 warps at k = 50) and the sweep is bound by issue
// and latency, not bytes: the plan takes the largest slot tile that fits
// (8 slots in bf16, 4 in f32), which halves the barriers a slot.

#include "plane_sweep.cuh"

namespace poismf {
namespace {

// max(0, x + alpha d), the product rounded before the sum; the max keeps
// a NaN, like torch.clamp_min / jnp.maximum
__device__ __forceinline__ float project(float x, float alpha, float d) {
  const float t = __fadd_rn(x, __fmul_rn(alpha, d));
  return (t != t) ? t : fmaxf(t, 0.f);
}

template <int CT>
struct FGtdMultiOp {
  static constexpr int NW = 0;    // no slot weights,
  static constexpr int NACC = 0;  // no register sums: no pass 2
  static constexpr int NDOT = CT + 1;  // pred at each trial, then bd
  static constexpr int NBLK = 2;   // x and d in shared memory past a chunk
  static constexpr bool FORMS_FACTORS = true;  // the trials, from x and d
  static constexpr int NSLOT = 1;  // slot plane: vals
  static constexpr int NSUM = 2 * CT;  // log sums, then g.d sums
  static constexpr int NPART = CT;  // a slot's weights: a part a candidate
  const float* x_t;     // [k, R]
  const float* d_t;     // [k, R]
  const float* alphas;  // [C, R]
  const float* bsum;    // [k] or [k, R]
  const unsigned char* fold;  // [R] or null
  int C;  // candidates, <= CT
  int bsum_per_row;
  int l2_in_f;
  float l2_reg;
  float w_mult;

  // candidate c's step at row r; zero for the spare candidates.  Read
  // where it is used (a volatile load): the compiler would otherwise hold
  // the steps in registers across the sweep, for the rare k > 64
  __device__ __forceinline__ float alpha(int c, int r, int R) const {
    return c < C ? static_cast<const volatile float*>(alphas)[(size_t)c * R +
                                                              r]
                 : 0.f;
  }
  __device__ __forceinline__ float block(int b, const float*,
                                         size_t idx) const {
    return (b == 0 ? x_t : d_t)[idx];
  }
  __device__ __forceinline__ float factor(int n, const float*, int kk, int r,
                                          int R) const {
    const size_t idx = (size_t)kk * R + r;
    return n < CT ? project(x_t[idx], alpha(n, r, R), d_t[idx]) : d_t[idx];
  }
  // dot n's value from x and d in shared memory, a_block floats apart:
  // a[off] is x at (kk, r)
  __device__ __forceinline__ float shared_factor(int n, const float* a,
                                                 size_t a_block, int off,
                                                 int r, int R) const {
    return n < CT ? project(a[off], alpha(n, r, R), a[a_block + off])
                  : a[a_block + off];
  }
  // candidate c's log and g.d terms of one slot, added to row sums c and
  // CT + c (those of part c: s mod NPART = c)
  template <typename Dot>
  __device__ __forceinline__ void part(int c, const Dot& dot,
                                       const float* slot, float* sums) const {
    const float x = slot[0];
    if (c < C && x > 0.f) {
      const float pred = dot(c);
      sums[c] += x * logf(pred);
      sums[CT + c] += (x * dot(CT)) / floor_eps(pred);
    }
  }
  // out is a split's [2, C, R] block: f rows, then gtd rows
  __host__ __device__ __forceinline__ int out_rows(int) const {
    return 2 * C;
  }
  // candidate c's f row from its log sum t[c] and gtd row from its g.d
  // sum t[CT + c], with the linear terms added over all k of the row, in
  // order, on split 0 and the rows that fold marks
  __device__ __forceinline__ void store_sums(float* o, const float* t,
                                             bool first_split, int k, int R,
                                             int r) const {
    float f[CT], gt[CT];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      f[c] = -w_mult * t[c];
      gt[c] = -w_mult * t[CT + c];
    }
    if (first_split && (fold == nullptr || fold[r] != 0)) {
      float a[CT], lin[CT], sq[CT], td[CT], lin_d = 0.f;
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        a[c] = alpha(c, r, R);
        lin[c] = sq[c] = td[c] = 0.f;
      }
      for (int kk = 0; kk < k; ++kk) {
        const size_t idx = (size_t)kk * R + r;
        const float x = x_t[idx], d = d_t[idx];
        const float bs = bsum[bsum_per_row ? idx : kk];
        lin_d += d * bs;
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          const float tr = project(x, a[c], d);
          lin[c] += tr * bs;
          sq[c] += tr * tr;
          td[c] += tr * d;
        }
      }
#pragma unroll
      for (int c = 0; c < CT; ++c) {
        if (l2_in_f) lin[c] += l2_reg * sq[c];
        f[c] = lin[c] + f[c];
        gt[c] = (lin_d + 2.f * l2_reg * td[c]) + gt[c];
      }
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < C) {
        o[(size_t)c * R + r] = f[c];
        o[(size_t)(C + c) * R + r] = gt[c];
      }
    }
  }
};

template <int CT>
int launch_multi(const void* bg, int bg_bf16, const void* vals,
                 const void* x_t, const void* d_t, const void* alphas,
                 const void* bsum, int bsum_per_row, const void* fold,
                 float l2_reg, float w_mult, int l2_in_f, void* out,
                 void* scratch, int C, int k, int P, int R, int kg, int pt,
                 int stages, int p_per_split, void* stream) {
  const FGtdMultiOp<CT> op{static_cast<const float*>(x_t),
                           static_cast<const float*>(d_t),
                           static_cast<const float*>(alphas),
                           static_cast<const float*>(bsum),
                           static_cast<const unsigned char*>(fold),
                           C,
                           bsum_per_row,
                           l2_in_f,
                           l2_reg,
                           w_mult};
  return launch_sweep_as(bg, bg_bf16, vals, nullptr, out, scratch, op, k, P,
                         R, kg, pt, stages, p_per_split, stream);
}

}  // namespace
}  // namespace poismf

// x_t, d_t: [k, R] f32; alphas: [C, R] f32 (1 <= C <= 8); bsum: [k] f32
// (bsum_per_row = 0) or [k, R] f32 (1); fold: [R] bool or null (every
// row); out: [2, C, R] f32 (f, gtd); scratch: [splits, 2, C, R] f32 when
// P is split, else unused.  kg, pt, stages, p_per_split: the launch plan
// of the instance that runs C (kernels/_lib.sweep_plan).
extern "C" int poismf_f_gtd_multi(const void* bg, int bg_bf16,
                                  const void* vals, const void* x_t,
                                  const void* d_t, const void* alphas,
                                  const void* bsum, int bsum_per_row,
                                  const void* fold, float l2_reg,
                                  float w_mult, int l2_in_f, void* out,
                                  void* scratch, int C, int k, int P, int R,
                                  int kg, int pt, int stages, int p_per_split,
                                  void* stream) {
  using namespace poismf;
  decltype(&launch_multi<1>) launch = nullptr;
  if (C == 1)
    launch = launch_multi<1>;
  else if (C == 2)
    launch = launch_multi<2>;
  else if (C >= 3 && C <= 4)
    launch = launch_multi<4>;
  else if (C >= 5 && C <= MAX_C)
    launch = launch_multi<8>;
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(bg, bg_bf16, vals, x_t, d_t, alphas, bsum, bsum_per_row,
                fold, l2_reg, w_mult, l2_in_f, out, scratch, C, k, P, R, kg,
                pt, stages, p_per_split, stream);
}

// Shared memory of one block of the instance for template C (1, 2, 4, 8)
// at this plan, how many fit on an SM (0 when it exceeds what a block may
// use), the bytes of a ring stage, the blocks along k and the slot planes
// a launch takes.
#define POISMF_F_GTD_MULTI_OCCUPANCY(CT)                                      \
  extern "C" int poismf_f_gtd_multi_c##CT##_occupancy(                       \
      int bg_bf16, int k, int kg, int pt, int stages, int* smem,            \
      int* blocks, int* stage_bytes, int* blocks_k, int* slot_planes) {     \
    return poismf::sweep_occupancy_as<poismf::FGtdMultiOp<CT>>(             \
        bg_bf16, k, kg, pt, stages, smem, blocks, stage_bytes, blocks_k,    \
        slot_planes);                                                       \
  }
POISMF_F_GTD_MULTI_OCCUPANCY(1)
POISMF_F_GTD_MULTI_OCCUPANCY(2)
POISMF_F_GTD_MULTI_OCCUPANCY(4)
POISMF_F_GTD_MULTI_OCCUPANCY(8)
