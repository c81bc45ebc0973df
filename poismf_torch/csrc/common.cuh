// Shared helpers of the planar-ELL kernels (fgh.cu, hvp.cu, raygtd.cu,
// fg.cu, pg.cu, fgtd.cu, fgtd_multi.cu).
//
// Layout, per ELL bucket: planes are [k, P, R] (bf16 or f32) and [P, R]
// (f32), with R (the bucket's rows) the innermost, contiguous axis.  fgh,
// hvp, fg and pg stage tiles of the planes through shared memory
// (plane_sweep.cuh); raygtd (which also serves ray and rayf) gives a lane
// four rows and keeps several slots' loads in flight.  fgtd and fgtd_multi
// give a block a tile of 32 neighbouring rows (one per lane, so a warp's
// loads of one slot coalesce) and split the bucket's P slots
// across the block's warps (blockDim.y) and, for long buckets, across
// blocks (gridDim.y "splits").  Each warp sums its own slots; the block
// then adds its warps' sums in a fixed order, and a second pass adds the
// splits in a fixed order: no atomics, so every result is the same from
// run to run.
//
// Built with nvcc without --use_fast_math: logf, the IEEE division and the
// inf/NaN behaviour must be exact for the line search's rejection rule.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace poismf {

constexpr float PRED_EPS = 1e-30f;
constexpr int TILE_R = 32;  // rows per block: one per lane
constexpr int MAX_WARPS = 4;  // warps per block, splitting P
constexpr int MAX_C = 8;  // line-search candidates held in registers

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// max(pred, PRED_EPS) that keeps a NaN, like jnp.maximum / torch.clamp_min.
__device__ __forceinline__ float floor_eps(float pred) {
  return (pred != pred) ? pred : fmaxf(pred, PRED_EPS);
}

// out[i] = sum over s = 0..splits-1, in that order, of part[s * n + i].
static __global__ void sum_splits_kernel(const float* __restrict__ part,
                                         float* __restrict__ out, long long n,
                                         int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.f;
  for (int s = 0; s < splits; ++s) acc += part[(long long)s * n + i];
  out[i] = acc;
}

static inline void sum_splits(const float* part, float* out, long long n,
                              int splits, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sum_splits_kernel<<<(unsigned)blocks, threads, 0, stream>>>(part, out, n,
                                                              splits);
}

}  // namespace poismf
