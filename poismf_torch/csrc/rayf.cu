// rayf_multi: the CG line search's multi-candidate round on the cached
// prediction planes of one ELL bucket (trial f only).
//
// Replaces poismf_tpu/ops/pallas_kernels.py rayf_multi_bucket (def :723,
// pallas_call :732, body _rayf_multi_kernel :700-719).  For each of C
// candidate steps alpha_c[r] and every slot p of row r:
//   pred  = px + alpha_c * pd
//   nll_c = -sum_p x * log(pred)                  (UNfloored log)
// A non-positive trial prediction at a positive count gives +inf or NaN
// in nll_c: that is how the line search rejects the step.  Slots with
// x <= 0 (padding) contribute nothing, by selection, never by a multiply.
//
// Bound by bytes: three f32 [P, R] planes (px, pd, vals; 12 bytes a slot)
// and no k axis, ~4 flops and one log per slot and candidate.  It is
// raygtd.cu without the g.d output: a lane per row (coalesced [P, R]
// reads), all C candidates folded into the one pass over the planes with
// their sums in registers (C <= 8), warps split P and are added in a
// fixed order through shared memory, splits in a fixed second pass.

#include "common.cuh"

namespace poismf {
namespace {

__global__ void __launch_bounds__(TILE_R * MAX_WARPS)
rayf_kernel(const float* __restrict__ px, const float* __restrict__ pd,
            const float* __restrict__ vals, const float* __restrict__ alphas,
            float* __restrict__ out, int C, int P, int R, int p_per_split) {
  __shared__ float red[MAX_WARPS][MAX_C][TILE_R];
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int W = blockDim.y;
  const int r = blockIdx.x * TILE_R + lane;
  const int split = blockIdx.y;
  const bool row_ok = r < R;

  float a[MAX_C], logsum[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    a[c] = (row_ok && c < C) ? alphas[(size_t)c * R + r] : 0.f;
    logsum[c] = 0.f;
  }
  if (row_ok) {
    const int p0 = split * p_per_split;
    const int p1 = min(P, p0 + p_per_split);
    for (int p = p0 + wp; p < p1; p += W) {
      const size_t off = (size_t)p * R + r;
      const float x = vals[off];
      if (!(x > 0.f)) continue;
      const float pxv = px[off];
      const float pdv = pd[off];
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < C) logsum[c] += x * logf(pxv + a[c] * pdv);
    }
  }
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) red[wp][c][lane] = logsum[c];
  __syncthreads();
  if (!row_ok) return;

  // out is this split's [C, R] block
  float* o = out + (size_t)split * C * R;
  for (int c = wp; c < C; c += W) {
    float n = 0.f;
    for (int w = 0; w < W; ++w) n += red[w][c][lane];
    o[(size_t)c * R + r] = -n;
  }
}

}  // namespace
}  // namespace poismf

// px, pd, vals: [P, R] f32; alphas: [C, R] f32 (C <= 8); out: [C, R] f32;
// scratch: [splits, C, R] f32 when splits > 1.
extern "C" int poismf_rayf(const void* px, const void* pd, const void* vals,
                           const void* alphas, void* out, void* scratch,
                           int C, int P, int R, int warps, int splits,
                           void* stream) {
  using namespace poismf;
  if (C < 1 || C > MAX_C || warps < 1 || warps > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p_per_split = (P + splits - 1) / splits;
  dim3 grid((R + TILE_R - 1) / TILE_R, splits);
  dim3 block(TILE_R, warps);
  float* dst = splits > 1 ? static_cast<float*>(scratch)
                          : static_cast<float*>(out);
  rayf_kernel<<<grid, block, 0, s>>>(
      static_cast<const float*>(px), static_cast<const float*>(pd),
      static_cast<const float*>(vals), static_cast<const float*>(alphas), dst,
      C, P, R, p_per_split);
  if (splits > 1)
    sum_splits(static_cast<const float*>(scratch), static_cast<float*>(out),
               (long long)C * R, splits, s);
  return static_cast<int>(cudaGetLastError());
}
