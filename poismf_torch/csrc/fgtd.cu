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
// floor (a NaN passes through it, as jnp.maximum lets it).  Slots with
// x <= 0 (padding) are skipped before the dot, by selection.
//
// Bound by bytes: one read of bg (k * itemsize bytes a slot) plus vals,
// and the 4-byte bd plane in the hoisted variant; 2 (4 fused) flops per
// plane element.  Design: a lane per row (coalesced [P, R] reads), the
// trial and direction rows in shared memory, the per-row sums in
// registers, warps and splits over P added in a fixed order.

#include "common.cuh"

namespace poismf {
namespace {

template <typename T, bool FUSED>
__global__ void __launch_bounds__(TILE_R * MAX_WARPS)
fgtd_kernel(const T* __restrict__ bg, const float* __restrict__ vals,
            const float* __restrict__ a_t, const float* __restrict__ dir,
            float* __restrict__ out, int k, int P, int R, int p_per_split) {
  extern __shared__ float smem[];
  __shared__ float red[MAX_WARPS][2][TILE_R];
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int W = blockDim.y;
  const int r = blockIdx.x * TILE_R + lane;
  const int split = blockIdx.y;
  const bool row_ok = r < R;

  float* a_s = smem;              // [k][32]
  float* d_s = a_s + k * TILE_R;  // [k][32], fused only: dir is d_t [k, R]
  for (int kk = wp; kk < k; kk += W) {
    a_s[kk * TILE_R + lane] = row_ok ? a_t[(size_t)kk * R + r] : 0.f;
    if constexpr (FUSED)
      d_s[kk * TILE_R + lane] = row_ok ? dir[(size_t)kk * R + r] : 0.f;
  }
  __syncthreads();

  float logsum = 0.f, gud = 0.f;
  if (row_ok) {
    const size_t plane = (size_t)P * R;
    const int p0 = split * p_per_split;
    const int p1 = min(P, p0 + p_per_split);
    for (int p = p0 + wp; p < p1; p += W) {
      const size_t off = (size_t)p * R + r;
      const float x = vals[off];
      if (!(x > 0.f)) continue;
      const T* col = bg + off;
      // the bd plane is read before the dot, beside vals
      float pred = 0.f, bd = FUSED ? 0.f : dir[off];
      if constexpr (FUSED) {
#pragma unroll 4
        for (int kk = 0; kk < k; ++kk) {
          const float b = to_f32(col[kk * plane]);
          pred += b * a_s[kk * TILE_R + lane];
          bd += b * d_s[kk * TILE_R + lane];
        }
      } else {
#pragma unroll 4
        for (int kk = 0; kk < k; ++kk)
          pred += to_f32(col[kk * plane]) * a_s[kk * TILE_R + lane];
      }
      logsum += x * logf(pred);
      gud += (x * bd) / floor_eps(pred);
    }
  }
  red[wp][0][lane] = logsum;
  red[wp][1][lane] = gud;
  __syncthreads();
  if (!row_ok || wp != 0) return;

  // out is this split's [2, R] block: the nll row, then the gud row
  float n = 0.f, g = 0.f;
  for (int w = 0; w < W; ++w) {
    n += red[w][0][lane];
    g += red[w][1][lane];
  }
  float* o = out + (size_t)split * 2 * R;
  o[r] = -n;
  o[R + r] = g;
}

template <typename T, bool FUSED>
cudaError_t launch_fgtd(const void* bg, const void* vals, const void* a_t,
                        const void* dir, void* out, void* scratch, int k,
                        int P, int R, int warps, int splits,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)k * TILE_R * (FUSED ? 2 : 1);
  cudaError_t err = cudaFuncSetAttribute(
      fgtd_kernel<T, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int p_per_split = (P + splits - 1) / splits;
  dim3 grid((R + TILE_R - 1) / TILE_R, splits);
  dim3 block(TILE_R, warps);
  float* dst = splits > 1 ? static_cast<float*>(scratch)
                          : static_cast<float*>(out);
  fgtd_kernel<T, FUSED><<<grid, block, smem, stream>>>(
      static_cast<const T*>(bg), static_cast<const float*>(vals),
      static_cast<const float*>(a_t), static_cast<const float*>(dir), dst, k,
      P, R, p_per_split);
  if (splits > 1)
    sum_splits(static_cast<const float*>(scratch), static_cast<float*>(out),
               (long long)2 * R, splits, stream);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_fgtd(int fused, const void* bg, const void* vals,
                          const void* a_t, const void* dir, void* out,
                          void* scratch, int k, int P, int R, int warps,
                          int splits, cudaStream_t stream) {
  return fused ? launch_fgtd<T, true>(bg, vals, a_t, dir, out, scratch, k, P,
                                      R, warps, splits, stream)
               : launch_fgtd<T, false>(bg, vals, a_t, dir, out, scratch, k,
                                       P, R, warps, splits, stream);
}

}  // namespace
}  // namespace poismf

// dir: d_t [k, R] f32 when fused, else the bd plane [P, R] f32; out:
// [2, R] f32 (nll, gud); scratch: [splits, 2, R] f32 when splits > 1.
extern "C" int poismf_fgtd(const void* bg, int bg_bf16, const void* vals,
                           const void* a_t, const void* dir, int fused,
                           void* out, void* scratch, int k, int P, int R,
                           int warps, int splits, void* stream) {
  using namespace poismf;
  if (warps < 1 || warps > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bg_bf16 ? dispatch_fgtd<__nv_bfloat16>(fused, bg, vals, a_t, dir, out,
                                             scratch, k, P, R, warps, splits,
                                             s)
              : dispatch_fgtd<float>(fused, bg, vals, a_t, dir, out, scratch,
                                     k, P, R, warps, splits, s);
  return static_cast<int>(err);
}
