// fg: the CG solver's fused f / gradient evaluation of one ELL bucket, and
// f: the same objective without the gradient (line-search trials).
//
// fg replaces poismf_tpu/ops/pallas_kernels.py fg_bucket (def :216,
// pallas_call :238, body _fg_kernel :188-210); f, the GRAD = false
// instance of the same kernel, replaces f_bucket (def :320, pallas_call
// :324, body _f_kernel :304-316).  Per row r and slot p:
//   pred = sum_k bg[k,p,r] * a[k,r]
//   nll  = -sum_p x * log(pred)                   (UNfloored log)
//   grad = -sum_p (x / max(pred, eps)) * bg        [k, R]   (fg only)
// and, when px is not null (fg only), writes the raw prediction plane
// px = pred that seeds the ray line search.  Unlike fgh the log is not
// floored: a non-positive prediction at a positive count gives +inf or NaN
// in nll, which is how the line search rejects a trial.  The gradient
// weights keep the floor, so grad stays finite there.  Slots with x <= 0
// (padding) contribute nothing, by selection, never by a multiply; f skips
// them before the dot, fg only after it, since it writes px for every slot.
//
// Bound by bytes: it streams bg once (k * itemsize bytes a slot) plus
// vals, and writes px (4 bytes a slot) when asked; ~4 flops per plane
// element for fg, 2 for f.  Same design as fgh.cu (a lane per row for
// coalesced [P, R] reads, the second sweep over k re-reading the slot from
// L1, warps and splits over P added in a fixed order) with one [k, rows]
// accumulator in shared memory per warp instead of two, and no w2 plane;
// f keeps only its per-warp log sums there.

#include "common.cuh"

namespace poismf {
namespace {

template <typename T, bool GRAD>
__global__ void __launch_bounds__(TILE_R * MAX_WARPS)
fg_kernel(const T* __restrict__ bg, const float* __restrict__ vals,
          const float* __restrict__ a_t, float* __restrict__ out,
          float* __restrict__ px, int k, int P, int R, int p_per_split) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int W = blockDim.y;
  const int r = blockIdx.x * TILE_R + lane;
  const int split = blockIdx.y;
  const bool row_ok = r < R;

  float* a_s = smem;                   // [k][32]
  float* n_s = a_s + k * TILE_R;       // [W][32]
  float* g_s = n_s + W * TILE_R;       // [W][k][32], fg only
  float* g_w = g_s + wp * k * TILE_R;

  for (int kk = wp; kk < k; kk += W)
    a_s[kk * TILE_R + lane] = row_ok ? a_t[(size_t)kk * R + r] : 0.f;
  if constexpr (GRAD) {
    for (int kk = 0; kk < k; ++kk) g_w[kk * TILE_R + lane] = 0.f;
  }
  __syncthreads();

  float logsum = 0.f;
  if (row_ok) {
    const size_t plane = (size_t)P * R;
    const int p0 = split * p_per_split;
    const int p1 = min(P, p0 + p_per_split);
    for (int p = p0 + wp; p < p1; p += W) {
      const size_t off = (size_t)p * R + r;
      const float x = vals[off];
      if (!GRAD && !(x > 0.f)) continue;
      const T* col = bg + off;
      float pred = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < k; ++kk)
        pred += to_f32(col[kk * plane]) * a_s[kk * TILE_R + lane];
      if (GRAD && px != nullptr) px[off] = pred;
      if (!(x > 0.f)) continue;
      logsum += x * logf(pred);
      if constexpr (GRAD) {
        const float w = x / floor_eps(pred);
#pragma unroll 4
        for (int kk = 0; kk < k; ++kk)
          g_w[kk * TILE_R + lane] += (-w) * to_f32(col[kk * plane]);
      }
    }
  }
  n_s[wp * TILE_R + lane] = logsum;
  __syncthreads();
  if (!row_ok) return;

  // out is this split's [1 + k, R] block (nll row, then grad) for fg, its
  // [1, R] nll row for f
  float* o = out + (size_t)split * (GRAD ? 1 + k : 1) * R;
  if constexpr (GRAD) {
    for (int kk = wp; kk < k; kk += W) {
      float g = 0.f;
      for (int w = 0; w < W; ++w) g += g_s[(w * k + kk) * TILE_R + lane];
      o[(size_t)(1 + kk) * R + r] = g;
    }
  }
  if (wp == 0) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s += n_s[w * TILE_R + lane];
    o[r] = -s;
  }
}

template <typename T, bool GRAD>
cudaError_t launch_fg(const void* bg, const void* vals, const void* a_t,
                      void* out, void* px, void* scratch, int k, int P, int R,
                      int warps, int splits, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)k * TILE_R * (1 + (GRAD ? warps : 0)) +
                       warps * TILE_R);
  cudaError_t err = cudaFuncSetAttribute(
      fg_kernel<T, GRAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int p_per_split = (P + splits - 1) / splits;
  dim3 grid((R + TILE_R - 1) / TILE_R, splits);
  dim3 block(TILE_R, warps);
  float* dst = splits > 1 ? static_cast<float*>(scratch)
                          : static_cast<float*>(out);
  fg_kernel<T, GRAD><<<grid, block, smem, stream>>>(
      static_cast<const T*>(bg), static_cast<const float*>(vals),
      static_cast<const float*>(a_t), dst, static_cast<float*>(px), k, P, R,
      p_per_split);
  if (splits > 1)
    sum_splits(static_cast<const float*>(scratch), static_cast<float*>(out),
               (long long)(GRAD ? 1 + k : 1) * R, splits, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace poismf

// out: [1 + k, R] f32 (nll, grad); px: [P, R] f32 or null; scratch:
// [splits, 1 + k, R] f32 when splits > 1, else unused.
extern "C" int poismf_fg(const void* bg, int bg_bf16, const void* vals,
                         const void* a_t, void* out, void* px, void* scratch,
                         int k, int P, int R, int warps, int splits,
                         void* stream) {
  using namespace poismf;
  if (warps < 1 || warps > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bg_bf16 ? launch_fg<__nv_bfloat16, true>(bg, vals, a_t, out, px,
                                               scratch, k, P, R, warps,
                                               splits, s)
              : launch_fg<float, true>(bg, vals, a_t, out, px, scratch, k, P,
                                       R, warps, splits, s);
  return static_cast<int>(err);
}

// out: [R] f32 (nll); scratch: [splits, R] f32 when splits > 1.
extern "C" int poismf_f(const void* bg, int bg_bf16, const void* vals,
                        const void* a_t, void* out, void* scratch, int k,
                        int P, int R, int warps, int splits, void* stream) {
  using namespace poismf;
  if (warps < 1 || warps > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bg_bf16 ? launch_fg<__nv_bfloat16, false>(bg, vals, a_t, out, nullptr,
                                                scratch, k, P, R, warps,
                                                splits, s)
              : launch_fg<float, false>(bg, vals, a_t, out, nullptr, scratch,
                                        k, P, R, warps, splits, s);
  return static_cast<int>(err);
}
