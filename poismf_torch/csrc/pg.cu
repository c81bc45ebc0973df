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
// k=10 in bf16) plus vals; ~4 flops per plane element.  Same design as
// fg.cu without the nll row and the px plane: a lane per row (coalesced
// [P, R] reads), the second sweep over k re-reading the slot from L1, one
// [k, rows] accumulator per warp in shared memory (10 floats a row at
// the pg configuration's k=10), warps and splits over P added in a fixed
// order.

#include "common.cuh"

namespace poismf {
namespace {

template <typename T>
__global__ void __launch_bounds__(128)
pg_kernel(const T* __restrict__ bg, const float* __restrict__ vals,
          const float* __restrict__ a_t, float* __restrict__ out, int k,
          int P, int R, int p_per_split) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int W = blockDim.y;
  const int r = blockIdx.x * TILE_R + lane;
  const int split = blockIdx.y;
  const bool row_ok = r < R;

  float* a_s = smem;                   // [k][32]
  float* g_s = a_s + k * TILE_R;       // [W][k][32]
  float* g_w = g_s + wp * k * TILE_R;

  for (int kk = wp; kk < k; kk += W)
    a_s[kk * TILE_R + lane] = row_ok ? a_t[(size_t)kk * R + r] : 0.f;
  for (int kk = 0; kk < k; ++kk) g_w[kk * TILE_R + lane] = 0.f;
  __syncthreads();

  if (row_ok) {
    const size_t plane = (size_t)P * R;
    const int p0 = split * p_per_split;
    const int p1 = min(P, p0 + p_per_split);
    for (int p = p0 + wp; p < p1; p += W) {
      const size_t off = (size_t)p * R + r;
      const float x = vals[off];
      if (!(x > 0.f)) continue;
      const T* col = bg + off;
      float pred = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < k; ++kk)
        pred += to_f32(col[kk * plane]) * a_s[kk * TILE_R + lane];
      const float w = x / floor_eps(pred);
#pragma unroll 4
      for (int kk = 0; kk < k; ++kk)
        g_w[kk * TILE_R + lane] += w * to_f32(col[kk * plane]);
    }
  }
  __syncthreads();
  if (!row_ok) return;

  // out is this split's [k, R] block
  float* o = out + (size_t)split * k * R;
  for (int kk = wp; kk < k; kk += W) {
    float g = 0.f;
    for (int w = 0; w < W; ++w) g += g_s[(w * k + kk) * TILE_R + lane];
    o[(size_t)kk * R + r] = g;
  }
}

template <typename T>
cudaError_t launch_pg(const void* bg, const void* vals, const void* a_t,
                      void* out, void* scratch, int k, int P, int R,
                      int warps, int splits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)k * TILE_R * (1 + warps);
  cudaError_t err = cudaFuncSetAttribute(
      pg_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int p_per_split = (P + splits - 1) / splits;
  dim3 grid((R + TILE_R - 1) / TILE_R, splits);
  dim3 block(TILE_R, warps);
  float* dst = splits > 1 ? static_cast<float*>(scratch)
                          : static_cast<float*>(out);
  pg_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(bg), static_cast<const float*>(vals),
      static_cast<const float*>(a_t), dst, k, P, R, p_per_split);
  if (splits > 1)
    sum_splits(static_cast<const float*>(scratch), static_cast<float*>(out),
               (long long)k * R, splits, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace poismf

// out: [k, R] f32; scratch: [splits, k, R] f32 when splits > 1.
extern "C" int poismf_pg(const void* bg, int bg_bf16, const void* vals,
                         const void* a_t, void* out, void* scratch, int k,
                         int P, int R, int warps, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bg_bf16 ? poismf::launch_pg<__nv_bfloat16>(bg, vals, a_t, out, scratch,
                                                 k, P, R, warps, splits, s)
              : poismf::launch_pg<float>(bg, vals, a_t, out, scratch, k, P,
                                         R, warps, splits, s);
  return static_cast<int>(err);
}
