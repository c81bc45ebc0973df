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
// element.  Same design as fgh.cu: a lane per row for coalesced [P, R]
// slices, the second sweep over k re-reads from L1, and the [k, rows]
// accumulators live in shared memory, one copy per warp, added in a fixed
// order.

#include "common.cuh"

namespace poismf {
namespace {

template <typename T>
__global__ void __launch_bounds__(128)
hvp_kernel(const T* __restrict__ bg, const float* __restrict__ w2,
           const float* __restrict__ v_t, float* __restrict__ out,
           float* __restrict__ bv, int k, int P, int R, int p_per_split) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int W = blockDim.y;
  const int r = blockIdx.x * TILE_R + lane;
  const int split = blockIdx.y;
  const bool row_ok = r < R;

  float* v_s = smem;                  // [k][32]
  float* o_s = v_s + k * TILE_R;      // [W][k][32]
  float* o_w = o_s + wp * k * TILE_R;

  for (int kk = wp; kk < k; kk += W)
    v_s[kk * TILE_R + lane] = row_ok ? v_t[(size_t)kk * R + r] : 0.f;
  for (int kk = 0; kk < k; ++kk) o_w[kk * TILE_R + lane] = 0.f;
  __syncthreads();

  if (row_ok) {
    const size_t plane = (size_t)P * R;
    const int p0 = split * p_per_split;
    const int p1 = min(P, p0 + p_per_split);
    for (int p = p0 + wp; p < p1; p += W) {
      const size_t off = (size_t)p * R + r;
      const T* col = bg + off;
      float dot = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < k; ++kk)
        dot += to_f32(col[kk * plane]) * v_s[kk * TILE_R + lane];
      if (bv != nullptr) bv[off] = dot;
      const float t = w2[off] * dot;
      // t == 0 (padding slots have w2 = 0) adds exactly nothing for the
      // finite planes; a NaN or inf t still goes through
      if (t != 0.f) {
#pragma unroll 4
        for (int kk = 0; kk < k; ++kk)
          o_w[kk * TILE_R + lane] += t * to_f32(col[kk * plane]);
      }
    }
  }
  __syncthreads();
  if (!row_ok) return;

  float* o = out + (size_t)split * k * R;
  for (int kk = wp; kk < k; kk += W) {
    float acc = 0.f;
    for (int w = 0; w < W; ++w) acc += o_s[(w * k + kk) * TILE_R + lane];
    o[(size_t)kk * R + r] = acc;
  }
}

template <typename T>
cudaError_t launch_hvp(const void* bg, const void* w2, const void* v_t,
                       void* out, void* bv, void* scratch, int k, int P,
                       int R, int warps, int splits, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)k * TILE_R * (1 + warps);
  cudaError_t err = cudaFuncSetAttribute(
      hvp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int p_per_split = (P + splits - 1) / splits;
  dim3 grid((R + TILE_R - 1) / TILE_R, splits);
  dim3 block(TILE_R, warps);
  float* dst = splits > 1 ? static_cast<float*>(scratch)
                          : static_cast<float*>(out);
  hvp_kernel<T><<<grid, block, smem, stream>>>(
      static_cast<const T*>(bg), static_cast<const float*>(w2),
      static_cast<const float*>(v_t), dst, static_cast<float*>(bv), k, P, R,
      p_per_split);
  if (splits > 1)
    sum_splits(static_cast<const float*>(scratch), static_cast<float*>(out),
               (long long)k * R, splits, stream);
  return cudaGetLastError();
}

}  // namespace
}  // namespace poismf

// out: [k, R] f32; bv: [P, R] f32 or null; scratch: [splits, k, R] f32
// when splits > 1, else unused.
extern "C" int poismf_hvp(const void* bg, int bg_bf16, const void* w2,
                          const void* v_t, void* out, void* bv, void* scratch,
                          int k, int P, int R, int warps, int splits,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bg_bf16 ? poismf::launch_hvp<__nv_bfloat16>(bg, w2, v_t, out, bv,
                                                  scratch, k, P, R, warps,
                                                  splits, s)
              : poismf::launch_hvp<float>(bg, w2, v_t, out, bv, scratch, k, P,
                                          R, warps, splits, s);
  return static_cast<int>(err);
}
