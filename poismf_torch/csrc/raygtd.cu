// raygtd_multi: the TNCG line search's multi-candidate round on the cached
// prediction planes of one ELL bucket; ray: the same at one candidate;
// rayf_multi: the CG line search's round, the same without the g.d sums.
//
// Replaces poismf_tpu/ops/pallas_kernels.py raygtd_multi_bucket (def :783,
// pallas_call :796, body _raygtd_multi_kernel :753-779), at C = 1
// ray_bucket (def :653, pallas_call :662), and, as the instance without
// g.d, rayf_multi_bucket (def :723, pallas_call :732, body
// _rayf_multi_kernel :700-719).  For each of C candidate steps alpha_c[r]
// and every slot p of row r:
//   pred  = px + alpha_c * pd
//   nll_c = -sum_p x * log(pred)                  (UNfloored log)
//   gud_c =  sum_p x * pd / max(pred, eps)        (raygtd and ray only)
// A non-positive trial prediction at a positive count gives +inf or NaN
// in nll_c: that is how the line search rejects the step.  Slots with
// x <= 0 (padding) contribute nothing, by selection, never by a multiply
// (0 * inf would be NaN).
//
// What bounds it on Hopper: three f32 [P, R] planes (px, pd, vals; 12 bytes
// a slot) and no k axis, so bytes, until C grows: a log and an IEEE
// division per slot and candidate, built without --use_fast_math, are about
// 48 instructions, which at C = 4 take longer to issue than the planes take
// to arrive (PERF.md, the raygtd redesign); rayf has the log alone.
//
// Design:
// - A thread owns RAY_ROWS = 4 neighbouring rows: one 16-byte load per plane
//   and slot, a warp reading 512 contiguous bytes of each plane.  It walks
//   its share of P in rounds of U slots and issues every load of a round
//   (3 U loads of 16 bytes) before the first use, so a warp keeps U * 1.5 KB
//   in flight and an SM, at 16 resident warps and U = 4, 96 KB: several
//   times the ~20 KB that keep its share of 3.35 TB/s busy.  The loads do
//   not wait for the x > 0 test: px and pd are read at the padding too
//   (loading them only under the test was slower on every bucket tried).
// - C is a template parameter (1, 2, 4, 8; a C between is run by the next
//   one up with the spare candidates' steps at zero and their sums not
//   stored): the candidate loop has no predicate, and a thread carries only
//   its own NS * 4 * C sums and 4 * C steps in registers, NS = 2 sums a
//   candidate with g.d and 1 without (GUD, also a template parameter: the
//   instance without it has no division, no g.d sums and a [C, R] output).
// - The trial prediction is rounded as PyTorch rounds px + (alpha pd), the
//   product first, never as a fused multiply-add: a trial lands on zero, or
//   on either side of it, exactly where the plain version's does.
// - The block's warps (blockDim.y, 1..8) take interleaved slots and are
//   added in a fixed order through shared memory; a block of one warp
//   stores its registers directly.  Buckets with too few rows to fill the
//   card also split P across blocks (gridDim.y), each split writing its
//   partial sums, added in a fixed order by sum_splits.  No atomics: two
//   launches give bitwise-equal outputs.  (Having the last block of a row
//   tile add the splits, to save the second launch, took as long or
//   longer on the card: PERF.md.)

#include "common.cuh"

// Measurement variants, built only by scripts/torch_ray_probe.py: 1 keeps
// the loads and replaces each slot's terms by one add per value (what the
// copies alone cost), 2 keeps the terms and replaces the loads by values
// made in registers (what the arithmetic alone costs), 3 takes the log and
// the division from the card's approximate units (__logf, __fdividef: what
// the exact logf and IEEE division cost).
#ifndef POISMF_RAY_VARIANT
#define POISMF_RAY_VARIANT 0
#endif

namespace poismf {
namespace {

constexpr int RAY_ROWS = 4;               // rows a thread owns
constexpr int RAY_TILE = 32 * RAY_ROWS;   // rows a warp and a block cover
constexpr int RAY_MAX_WARPS = 8;          // warps a block splits P over

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Slots in flight per thread and round: fewer at C = 8, whose sums alone
// take 64-96 registers.
template <int C>
struct RayUnroll {
  static constexpr int U = C > 4 ? 2 : 4;
};

template <int C, bool GUD>
__global__ void __launch_bounds__(32 * RAY_MAX_WARPS, C > 4 ? 1 : 2)
ray_kernel(const float* __restrict__ px, const float* __restrict__ pd,
           const float* __restrict__ vals, const float* __restrict__ alphas,
           float* __restrict__ out, int nc, int P, int R, int p_per_split) {
  constexpr int U = RayUnroll<C>::U;
  constexpr int NS = GUD ? 2 : 1;  // sums a candidate: nll (and g.d)
  extern __shared__ float4 red[];  // [W][NS C][32], blocks of W > 1 warps
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int W = blockDim.y;
  const int r = (blockIdx.x * 32 + lane) * RAY_ROWS;  // R % 4 == 0
  const int split = blockIdx.y;
  const bool row_ok = r < R;

  float a[C][RAY_ROWS], logsum[C][RAY_ROWS];
  [[maybe_unused]] float gud[GUD ? C : 1][RAY_ROWS];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int j = 0; j < RAY_ROWS; ++j) {
      a[c][j] = (row_ok && c < nc) ? alphas[(size_t)c * R + r + j] : 0.f;
      logsum[c][j] = 0.f;
      if constexpr (GUD) gud[c][j] = 0.f;
    }

  if (row_ok) {
    const int p0 = split * p_per_split;
    const int p1 = min(P, p0 + p_per_split);
    for (int pb = p0 + wp; pb < p1; pb += W * U) {
      // every load of the round before any use; a slot past the split's
      // end reads nothing and counts as padding
      float4 xv[U], pv[U], dv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = pb + u * W;
        const size_t off = (size_t)p * R + r;
        if (POISMF_RAY_VARIANT == 2) {
          const float t = 1.f + 1e-3f * (float)(p & 7);
          const float x = p < p1 ? t : 0.f;
          xv[u] = make_float4(x, x, x, x);
          pv[u] = dv[u] = make_float4(t, 0.5f * t, 2.f * t, t);
        } else if (p < p1) {
          xv[u] = ld4(vals + off);
          pv[u] = ld4(px + off);
          dv[u] = ld4(pd + off);
        } else {
          xv[u] = pv[u] = dv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float xs[RAY_ROWS] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
        const float ps[RAY_ROWS] = {pv[u].x, pv[u].y, pv[u].z, pv[u].w};
        const float ds[RAY_ROWS] = {dv[u].x, dv[u].y, dv[u].z, dv[u].w};
#pragma unroll
        for (int j = 0; j < RAY_ROWS; ++j) {
          const float x = xs[j];
          if (POISMF_RAY_VARIANT == 1) {
            logsum[0][j] += x + ps[j] + ds[j];
            continue;
          }
          if (!(x > 0.f)) continue;
          [[maybe_unused]] const float xd = x * ds[j];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            // rounded as PyTorch rounds px + (alpha pd), without a fused
            // multiply-add: a trial prediction lands on zero, or on
            // either side of it, exactly where the plain version's does
            const float pred = __fadd_rn(ps[j], __fmul_rn(a[c][j], ds[j]));
            if (POISMF_RAY_VARIANT == 3) {
              logsum[c][j] += x * __logf(pred);
              if constexpr (GUD)
                gud[c][j] += __fdividef(xd, floor_eps(pred));
              continue;
            }
            logsum[c][j] += x * logf(pred);
            if constexpr (GUD) gud[c][j] += xd / floor_eps(pred);
          }
        }
      }
    }
  }

  // dst is this split's [NS, nc, R] block: nll rows, then gud rows
  float* dst = out + (size_t)split * NS * nc * R;
  if (W == 1) {
    if (row_ok) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c >= nc) break;
        st4(dst + (size_t)c * R + r, -logsum[c][0], -logsum[c][1],
            -logsum[c][2], -logsum[c][3]);
        if constexpr (GUD)
          st4(dst + (size_t)(nc + c) * R + r, gud[c][0], gud[c][1],
              gud[c][2], gud[c][3]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      red[(wp * NS * C + c) * 32 + lane] = make_float4(
          logsum[c][0], logsum[c][1], logsum[c][2], logsum[c][3]);
      if constexpr (GUD)
        red[(wp * NS * C + C + c) * 32 + lane] =
            make_float4(gud[c][0], gud[c][1], gud[c][2], gud[c][3]);
    }
    __syncthreads();
    // sum m (nll of candidate m, or gud of candidate m - C) is added over
    // the warps in their order by warp m mod W
    for (int m = wp; m < NS * C && row_ok; m += W) {
      const int c = m < C ? m : m - C;
      if (c >= nc) continue;
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 0; w < W; ++w) {
        const float4 t = red[(w * NS * C + m) * 32 + lane];
        s.x += t.x;
        s.y += t.y;
        s.z += t.z;
        s.w += t.w;
      }
      const float sg = m < C ? -1.f : 1.f;
      st4(dst + (size_t)(m < C ? c : nc + c) * R + r, sg * s.x, sg * s.y,
          sg * s.z, sg * s.w);
    }
  }
}

template <int C, bool GUD>
cudaError_t launch_ray(const float* px, const float* pd, const float* vals,
                       const float* alphas, float* dst, int nc, int P, int R,
                       int warps, int p_per_split, int splits,
                       cudaStream_t stream) {
  const size_t smem =
      warps > 1 ? sizeof(float4) * warps * (GUD ? 2 : 1) * C * 32 : 0;
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  dim3 grid((R + RAY_TILE - 1) / RAY_TILE, splits);
  dim3 block(32, warps);
  ray_kernel<C, GUD><<<grid, block, smem, stream>>>(px, pd, vals, alphas,
                                                    dst, nc, P, R,
                                                    p_per_split);
  return cudaGetLastError();
}

// One round at C candidates, with (GUD) or without the g.d sums: the
// instance for the next template C up, then the splits added in order.
template <bool GUD>
int launch_round(const void* px, const void* pd, const void* vals,
                 const void* alphas, void* out, void* scratch, int C, int P,
                 int R, int warps, int p_per_split, void* stream) {
  if (C < 1 || C > MAX_C || warps < 1 || warps > RAY_MAX_WARPS ||
      p_per_split < 1 || R % RAY_ROWS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = (P + p_per_split - 1) / p_per_split;
  const float* x = static_cast<const float*>(px);
  const float* d = static_cast<const float*>(pd);
  const float* v = static_cast<const float*>(vals);
  const float* a = static_cast<const float*>(alphas);
  float* dst = static_cast<float*>(splits > 1 ? scratch : out);
  cudaError_t err;
  if (C == 1)
    err = launch_ray<1, GUD>(x, d, v, a, dst, C, P, R, warps, p_per_split,
                             splits, s);
  else if (C == 2)
    err = launch_ray<2, GUD>(x, d, v, a, dst, C, P, R, warps, p_per_split,
                             splits, s);
  else if (C <= 4)
    err = launch_ray<4, GUD>(x, d, v, a, dst, C, P, R, warps, p_per_split,
                             splits, s);
  else
    err = launch_ray<8, GUD>(x, d, v, a, dst, C, P, R, warps, p_per_split,
                             splits, s);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  sum_splits(static_cast<const float*>(scratch), static_cast<float*>(out),
             (long long)(GUD ? 2 : 1) * C * R, splits, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace poismf

// px, pd, vals: [P, R] f32, 16-byte aligned, R a multiple of 4; alphas:
// [C, R] f32 (C <= 8); out: [2, C, R] f32 (nll, gud); scratch: [splits, 2,
// C, R] f32 when P is split, else unused.  warps, p_per_split: the launch
// plan (kernels/_lib.ray_plan).
extern "C" int poismf_raygtd(const void* px, const void* pd, const void* vals,
                             const void* alphas, void* out, void* scratch,
                             int C, int P, int R, int warps, int p_per_split,
                             void* stream) {
  return poismf::launch_round<true>(px, pd, vals, alphas, out, scratch, C, P,
                                    R, warps, p_per_split, stream);
}

// As poismf_raygtd without the g.d sums: out [C, R] f32 (nll); scratch
// [splits, C, R] f32 when P is split.
extern "C" int poismf_rayf(const void* px, const void* pd, const void* vals,
                           const void* alphas, void* out, void* scratch,
                           int C, int P, int R, int warps, int p_per_split,
                           void* stream) {
  return poismf::launch_round<false>(px, pd, vals, alphas, out, scratch, C,
                                     P, R, warps, p_per_split, stream);
}
