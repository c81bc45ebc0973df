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
// its arithmetic is ~6 flops per plane element.  Design for that: a lane
// owns one row, so the 32 lanes of a warp read 32 neighbouring values of
// each [P, R] slice (coalesced); the second sweep over k at the same slot
// re-reads the values the first sweep just brought into L1, so bg crosses
// HBM once.  The [k, rows] accumulators of grad and diag live in shared
// memory (k is a runtime value; per-thread arrays of 2k floats would
// spill), one copy per warp, added in a fixed order at the end.

#include "common.cuh"

namespace poismf {
namespace {

template <typename T>
__global__ void __launch_bounds__(128)
fgh_kernel(const T* __restrict__ bg, const float* __restrict__ vals,
           const float* __restrict__ a_t, float* __restrict__ out,
           float* __restrict__ w2, float* __restrict__ px, int k, int P,
           int R, int p_per_split, float w_mult) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int W = blockDim.y;
  const int r = blockIdx.x * TILE_R + lane;
  const int split = blockIdx.y;
  const bool row_ok = r < R;

  float* a_s = smem;                   // [k][32]
  float* g_s = a_s + k * TILE_R;       // [W][k][32]
  float* d_s = g_s + W * k * TILE_R;   // [W][k][32]
  float* n_s = d_s + W * k * TILE_R;   // [W][32]
  float* g_w = g_s + wp * k * TILE_R;
  float* d_w = d_s + wp * k * TILE_R;

  for (int kk = wp; kk < k; kk += W)
    a_s[kk * TILE_R + lane] = row_ok ? a_t[(size_t)kk * R + r] : 0.f;
  for (int kk = 0; kk < k; ++kk) {
    g_w[kk * TILE_R + lane] = 0.f;
    d_w[kk * TILE_R + lane] = 0.f;
  }
  __syncthreads();

  float logsum = 0.f;
  if (row_ok) {
    const size_t plane = (size_t)P * R;
    const int p0 = split * p_per_split;
    const int p1 = min(P, p0 + p_per_split);
    for (int p = p0 + wp; p < p1; p += W) {
      const size_t off = (size_t)p * R + r;
      const T* col = bg + off;
      float pred = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < k; ++kk)
        pred += to_f32(col[kk * plane]) * a_s[kk * TILE_R + lane];
      const float x = vals[off];
      const bool valid = x > 0.f;
      const float safe = floor_eps(pred);
      // one reciprocal shared by both weights, as the TPU kernel does
      const float recip = 1.f / safe;
      const float w = valid ? x * recip : 0.f;
      const float w2v = valid ? (w_mult * x) * (recip * recip) : 0.f;
      w2[off] = w2v;
      if (px != nullptr) px[off] = pred;
      if (valid) logsum += x * logf(safe);
      if (w != 0.f || w2v != 0.f) {
#pragma unroll 4
        for (int kk = 0; kk < k; ++kk) {
          const float b = to_f32(col[kk * plane]);
          g_w[kk * TILE_R + lane] += (-w) * b;
          d_w[kk * TILE_R + lane] += w2v * (b * b);
        }
      }
    }
  }
  n_s[wp * TILE_R + lane] = logsum;
  __syncthreads();
  if (!row_ok) return;

  // out is this split's [1 + 2k, R] block: nll row, then grad, then diag
  float* o = out + (size_t)split * (1 + 2 * k) * R;
  for (int kk = wp; kk < k; kk += W) {
    float g = 0.f, d = 0.f;
    for (int w = 0; w < W; ++w) {
      g += g_s[(w * k + kk) * TILE_R + lane];
      d += d_s[(w * k + kk) * TILE_R + lane];
    }
    o[(size_t)(1 + kk) * R + r] = g;
    o[(size_t)(1 + k + kk) * R + r] = d;
  }
  if (wp == 0) {
    float s = 0.f;
    for (int w = 0; w < W; ++w) s += n_s[w * TILE_R + lane];
    o[r] = -s;
  }
}

template <typename T>
cudaError_t launch_fgh(const void* bg, const void* vals, const void* a_t,
                       void* out, void* w2, void* px, void* scratch, int k,
                       int P, int R, int warps, int splits, float w_mult,
                       cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)k * TILE_R * (1 + 2 * warps) + warps * TILE_R);
  cudaError_t err = cudaFuncSetAttribute(
      fgh_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int p_per_split = (P + splits - 1) / splits;
  dim3 grid((R + TILE_R - 1) / TILE_R, splits);
  dim3 block(TILE_R, warps);
  float* dst = splits > 1 ? static_cast<float*>(scratch)
                          : static_cast<float*>(out);
  fgh_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(bg), static_cast<const float*>(vals),
      static_cast<const float*>(a_t), dst, static_cast<float*>(w2),
      static_cast<float*>(px), k, P, R, p_per_split, w_mult);
  if (splits > 1)
    sum_splits(static_cast<const float*>(scratch), static_cast<float*>(out),
               (long long)(1 + 2 * k) * R, splits, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace poismf

// out: [1 + 2k, R] f32 (nll, grad, diag); w2 / px: [P, R] f32 (px may be
// null); scratch: [splits, 1 + 2k, R] f32 when splits > 1, else unused.
extern "C" int poismf_fgh(const void* bg, int bg_bf16, const void* vals,
                          const void* a_t, void* out, void* w2, void* px,
                          void* scratch, int k, int P, int R, int warps,
                          int splits, float w_mult, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bg_bf16 ? poismf::launch_fgh<__nv_bfloat16>(bg, vals, a_t, out, w2, px,
                                                  scratch, k, P, R, warps,
                                                  splits, w_mult, s)
              : poismf::launch_fgh<float>(bg, vals, a_t, out, w2, px, scratch,
                                          k, P, R, warps, splits, w_mult, s);
  return static_cast<int>(err);
}
