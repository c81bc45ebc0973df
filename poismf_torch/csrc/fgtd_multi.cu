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
// (per_row = 1).  Slots with x <= 0 (padding) are skipped before the dots.
//
// The trials are projected, so predictions are not linear in alpha (the
// ray kernels' trick does not apply): each candidate needs its own k-deep
// dot.  Bound by bytes all the same: one read of bg (k * itemsize bytes a
// slot) plus vals carries 2k (C + 1) flops, 22 at C = 4 and bf16 planes.
// Design: a lane per row (coalesced [P, R] reads); the C trial rows and
// the direction row are computed once per block into shared memory
// (4 k (C + 1) bytes a row, 32 KB at k = 50, C = 4); each bg element read
// feeds the C + 1 dots from registers; warps and splits over P are added
// in a fixed order.  The trial is rounded as x + (alpha * d) without a
// fused multiply-add, as PyTorch computes it, so a trial lands on zero
// exactly where the plain version's does.

#include "common.cuh"

namespace poismf {
namespace {

template <typename T>
__global__ void __launch_bounds__(TILE_R * MAX_WARPS)
fgtd_multi_kernel(const T* __restrict__ bg, const float* __restrict__ vals,
                  const float* __restrict__ x_t, const float* __restrict__ d_t,
                  const float* __restrict__ alphas,
                  const float* __restrict__ bsum, int bsum_per_row,
                  const unsigned char* __restrict__ fold, float l2_reg,
                  float w_mult, int l2_in_f, float* __restrict__ out, int C,
                  int k, int P, int R, int p_per_split) {
  extern __shared__ float smem[];
  __shared__ float red[MAX_WARPS][2 * MAX_C][TILE_R];
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int W = blockDim.y;
  const int r = blockIdx.x * TILE_R + lane;
  const int split = blockIdx.y;
  const bool row_ok = r < R;

  float* d_s = smem;              // [k][32]
  float* t_s = d_s + k * TILE_R;  // [C][k][32]
  for (int kk = wp; kk < k; kk += W) {
    const float x = row_ok ? x_t[(size_t)kk * R + r] : 0.f;
    const float d = row_ok ? d_t[(size_t)kk * R + r] : 0.f;
    d_s[kk * TILE_R + lane] = d;
    for (int c = 0; c < C; ++c) {
      const float a = row_ok ? alphas[(size_t)c * R + r] : 0.f;
      const float t = __fadd_rn(x, __fmul_rn(a, d));
      // max(t, 0) that keeps a NaN, like torch.clamp_min / jnp.maximum
      t_s[(c * k + kk) * TILE_R + lane] = (t != t) ? t : fmaxf(t, 0.f);
    }
  }
  __syncthreads();

  float logsum[MAX_C], gud[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    logsum[c] = 0.f;
    gud[c] = 0.f;
  }
  if (row_ok) {
    const size_t plane = (size_t)P * R;
    const int p0 = split * p_per_split;
    const int p1 = min(P, p0 + p_per_split);
    for (int p = p0 + wp; p < p1; p += W) {
      const size_t off = (size_t)p * R + r;
      const float x = vals[off];
      if (!(x > 0.f)) continue;
      const T* col = bg + off;
      float pred[MAX_C];
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) pred[c] = 0.f;
      float bd = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < k; ++kk) {
        const float b = to_f32(col[kk * plane]);
        bd += b * d_s[kk * TILE_R + lane];
#pragma unroll
        for (int c = 0; c < MAX_C; ++c)
          if (c < C) pred[c] += b * t_s[(c * k + kk) * TILE_R + lane];
      }
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < C) {
          logsum[c] += x * logf(pred[c]);
          gud[c] += (x * bd) / floor_eps(pred[c]);
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    red[wp][c][lane] = logsum[c];
    red[wp][MAX_C + c][lane] = gud[c];
  }
  __syncthreads();
  if (!row_ok) return;

  // out is this split's [2, C, R] block: f rows, then gtd rows
  const bool fold_row = split == 0 && (fold == nullptr || fold[r] != 0);
  float* o = out + (size_t)split * 2 * C * R;
  for (int c = wp; c < C; c += W) {
    float n = 0.f, g = 0.f;
    for (int w = 0; w < W; ++w) {
      n += red[w][c][lane];
      g += red[w][MAX_C + c][lane];
    }
    float f = -w_mult * n;
    float gt = -w_mult * g;
    if (fold_row) {
      float lin = 0.f, sq = 0.f, td = 0.f, lin_d = 0.f;
      for (int kk = 0; kk < k; ++kk) {
        const float t = t_s[(c * k + kk) * TILE_R + lane];
        const float d = d_s[kk * TILE_R + lane];
        const float bs = bsum[bsum_per_row ? (size_t)kk * R + r : kk];
        lin += t * bs;
        sq += t * t;
        td += t * d;
        lin_d += d * bs;
      }
      if (l2_in_f) lin += l2_reg * sq;
      f = lin + f;
      gt = (lin_d + 2.f * l2_reg * td) + gt;
    }
    o[(size_t)c * R + r] = f;
    o[(size_t)(C + c) * R + r] = gt;
  }
}

template <typename T>
cudaError_t launch_fgtd_multi(const void* bg, const void* vals,
                              const void* x_t, const void* d_t,
                              const void* alphas, const void* bsum,
                              int bsum_per_row, const void* fold,
                              float l2_reg, float w_mult, int l2_in_f,
                              void* out, void* scratch, int C, int k, int P,
                              int R, int warps, int splits,
                              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)k * TILE_R * (1 + C);
  cudaError_t err = cudaFuncSetAttribute(
      fgtd_multi_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int p_per_split = (P + splits - 1) / splits;
  dim3 grid((R + TILE_R - 1) / TILE_R, splits);
  dim3 block(TILE_R, warps);
  float* dst = splits > 1 ? static_cast<float*>(scratch)
                          : static_cast<float*>(out);
  fgtd_multi_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(bg), static_cast<const float*>(vals),
      static_cast<const float*>(x_t), static_cast<const float*>(d_t),
      static_cast<const float*>(alphas), static_cast<const float*>(bsum),
      bsum_per_row, static_cast<const unsigned char*>(fold), l2_reg, w_mult,
      l2_in_f, dst, C, k, P, R, p_per_split);
  if (splits > 1)
    sum_splits(static_cast<const float*>(scratch), static_cast<float*>(out),
               (long long)2 * C * R, splits, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace poismf

// x_t, d_t: [k, R] f32; alphas: [C, R] f32 (C <= 8); bsum: [k] f32
// (bsum_per_row = 0) or [k, R] f32 (1); fold: [R] bool or null (every
// row); out: [2, C, R] f32 (f, gtd); scratch: [splits, 2, C, R] f32 when
// splits > 1.
extern "C" int poismf_fgtd_multi(const void* bg, int bg_bf16,
                                 const void* vals, const void* x_t,
                                 const void* d_t, const void* alphas,
                                 const void* bsum, int bsum_per_row,
                                 const void* fold, float l2_reg,
                                 float w_mult, int l2_in_f, void* out,
                                 void* scratch, int C, int k, int P, int R,
                                 int warps, int splits, void* stream) {
  using namespace poismf;
  if (C < 1 || C > MAX_C || warps < 1 || warps > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bg_bf16
          ? launch_fgtd_multi<__nv_bfloat16>(
                bg, vals, x_t, d_t, alphas, bsum, bsum_per_row, fold, l2_reg,
                w_mult, l2_in_f, out, scratch, C, k, P, R, warps, splits, s)
          : launch_fgtd_multi<float>(bg, vals, x_t, d_t, alphas, bsum,
                                     bsum_per_row, fold, l2_reg, w_mult,
                                     l2_in_f, out, scratch, C, k, P, R, warps,
                                     splits, s);
  return static_cast<int>(err);
}
