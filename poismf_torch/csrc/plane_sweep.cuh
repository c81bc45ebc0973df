// plane_sweep: the shared body of fgh.cu, hvp.cu, fg.cu and pg.cu, "a
// k-deep dot per slot, then weighted sums over P" for one planar-ELL
// bucket.
//
// Per row r and slot p of a bucket (bg [k, P, R], R contiguous):
//   dot[p, r]   = sum_k bg[k,p,r] * rows_in[k,r]           (pass 1)
//   weights     = Op::weights(dot, slot_in[p, r])           (per slot)
//   acc[m][k,r] = sum_p Op::accumulate(weights, bg[k,p,r])  (pass 2)
// fgh.cu instantiates it with two weights (x / pred, w_mult x / pred^2),
// two sums (gradient, Hessian diagonal) and a log sum; hvp.cu with one
// weight (w2 <B, v>) and one sum; fg.cu with one weight, one sum (the
// gradient) and a log sum, and, as f, with the log sum alone: an Op with
// NACC = 0 has no pass 2, no slot weights and a single k chunk of blocks;
// pg.cu with one weight (x / pred) and one sum, as fg without the log.
//
// What bounds it on Hopper: bytes.  Each bg element is read once from HBM
// and feeds 2 flops in pass 1 and 2-3 in pass 2, far below the H100's ~20
// f32 flops per byte; no tensor core applies (each row pairs bg with its
// own vector, so nothing in bg is reused across rows).  At the largest
// item-side bucket (P=2048 x 3,840, k=50, bf16) the plane is 786 MB, which
// 3.35 TB/s moves in 0.235 ms.
//
// Design:
// - A block owns 64 rows (128 contiguous bytes of each [P, R] slice in
//   bf16) and walks its split's share of P in tiles of PT slots (1, 2, 4
//   or 8, a template parameter).  One thread issues, per tile, one Tensor
//   Memory Accelerator copy of the [k, PT, 64] box of bg per k chunk and
//   one of the [PT, 64] box of the slot plane (vals or w2) into a ring of
//   2-4 stages in shared memory, completing on the stage's mbarrier.  The
//   copies cost the other threads nothing, and tile i + stages - 1 is in
//   flight while tile i is summed.  The wrapper sizes a stage at up to
//   32 KB of bg (PT = 4 at k=50 in bf16, 2 in f32) and takes 3 stages: a
//   block keeps two stages, about 58 KB, in flight, two blocks an SM about
//   115 KB, several times the ~20 KB an SM needs to keep its share of 3.35
//   TB/s busy at ~700 ns of latency.  Rows past R or k and slots past P
//   arrive as zeros (the copies' out-of-bounds fill), so nothing is masked.
//   Per-thread 16-byte cp.async copies, tried first, spent the computing
//   threads' issue slots and kept the copies from overlapping the sums
//   (PERF.md, the fgh / hvp redesign).
// - Both sweeps over k read the staged tile, so bg crosses HBM once, by
//   construction.  The slot plane arrives with the tile, before the dot
//   needs it.
// - Pass 1: thread (g, r) of the block's 64 x KG threads (KG = 1..8 k
//   groups, KG = 7 at k=50) sums its KPT = 8 rows of the dot of each slot
//   against its row's factor values, held in registers; the KG partial dots
//   are added in a fixed order by the thread that owns the slot's weights.
// - Pass 2: the same thread owns row r and its 8 values of k, and keeps
//   their sums over P in registers: every (k, row) sum has exactly one
//   owner, so there is no shared-memory read-modify-write per plane element
//   and nothing to reduce across warps at the end.  The thread's rows are
//   neighbours in the tile, read at offsets fixed when the kernel is
//   compiled.  k is a runtime value: up to 64 (KG * KPT) is one chunk; a
//   larger k is cut into chunks of 64 across blockIdx.x, each block doing
//   the whole dot and its own chunk's sums (bg is then read once per chunk,
//   the blocks sharing it through L2).  Shared memory bounds k at 384 in
//   bf16 and 256 in f32 (the wrapper raises beyond).
// - Long buckets split P across blocks (gridDim.z); each split writes its
//   own partial sums and sum_splits adds them in a fixed order.  No
//   atomics: two launches give bitwise-equal outputs.
//
// Built without --use_fast_math: logf, the IEEE division and the inf/NaN
// behaviour must match the plain versions.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace poismf {

// A block covers SWEEP_TR rows, one a thread in each of its k groups; a
// thread keeps the sums of SWEEP_KPT values of k (its k group's share of
// the block's k chunk) in registers.
constexpr int SWEEP_TR = 64;     // rows per block, threads per k group
constexpr int SWEEP_KPT = 8;     // k values of a thread's register sums
constexpr int SWEEP_MAX_KG = 8;  // k groups a block may have

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrive once, expecting `bytes` of tensor copies to complete this phase.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One box of a 3-D ([k, P, R]) or 2-D ([P, R]) tensor map into shared
// memory, coordinates innermost (row) first; elements outside the tensor
// are filled with zeros.  Completion is counted on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int r, int p, int kk,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(r), "r"(p), "r"(kk), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int r, int p,
                                            unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(map), "r"(r), "r"(p), "r"(smem_addr(bar))
      : "memory");
}

// Tile rows: the bucket's k rows, padded to S = kchunks * KG * KPT (the
// padding zero-filled by the copies).  Thread group g sums rows
// c * KG * KPT + g * KPT + j, j < KPT, of chunk c: neighbouring rows, read
// at offsets known when the kernel is compiled.
__host__ __device__ inline int sweep_kchunks(int k, int kg) {
  return (k + kg * SWEEP_KPT - 1) / (kg * SWEEP_KPT);
}

__host__ __device__ inline int sweep_rows(int k, int kg) {
  return sweep_kchunks(k, kg) * kg * SWEEP_KPT;
}

// Dynamic shared memory of one block: an mbarrier a stage (32 bytes for
// up to 4 stages), the [S, TR] factor block (only when k spans several
// chunks), the [KG, PT, TR] partial dots, the [NW, PT, TR] slot weights,
// the [KG, TR] log sums, then, from a 128-byte boundary (up to 128 bytes
// of padding), `stages` stages of an [S, PT, TR] bg tile and a [PT, TR]
// slot tile.
template <typename T>
__host__ __device__ inline size_t sweep_stage_bytes(int k, int kg, int pt) {
  return (size_t)sweep_rows(k, kg) * pt * SWEEP_TR * sizeof(T) +
         (size_t)pt * SWEEP_TR * sizeof(float);
}

template <typename T, int NW>
__host__ __device__ inline size_t sweep_smem_bytes(int k, int kg, int pt,
                                                   int stages) {
  const size_t a_rows = sweep_kchunks(k, kg) > 1 ? sweep_rows(k, kg) : 0;
  return 32 +
         sizeof(float) * SWEEP_TR *
             (a_rows + (size_t)kg * pt + (size_t)NW * pt + kg) +
         128 + stages * sweep_stage_bytes<T>(k, kg, pt);
}

template <typename T, typename Op, int PT>
__global__ void __launch_bounds__(SWEEP_TR* SWEEP_MAX_KG)
plane_sweep_kernel(const __grid_constant__ CUtensorMap bg_map,
                   const __grid_constant__ CUtensorMap slot_map,
                   const float* __restrict__ rows_in, float* __restrict__ out,
                   Op op, int k, int P, int R, int p_per_split, int stages) {
  constexpr int KPT = SWEEP_KPT;
  constexpr int TR = SWEEP_TR;
  constexpr int NW = Op::NW;
  constexpr bool PASS2 = Op::NACC > 0;  // else the per-slot terms alone
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int nthreads = blockDim.x;
  const int KG = nthreads / TR;
  const int tid = threadIdx.x;
  const int g = tid / TR;
  const int rl = tid % TR;
  const int kc = blockIdx.x;  // k chunk of the register sums
  const int r0 = blockIdx.y * TR;
  const int r = r0 + rl;
  const int split = blockIdx.z;
  const bool row_ok = r < R;
  const int kchunk = KG * KPT;
  const int kchunks = (k + kchunk - 1) / kchunk;
  const int S = kchunks * kchunk;
  const int k_own = kc * kchunk + g * KPT;  // first of the thread's k rows
  const int p0 = split * p_per_split;
  const int p1 = min(P, p0 + p_per_split);
  const int ntiles = (p1 - p0 + PT - 1) / PT;

  auto* bars = reinterpret_cast<unsigned long long*>(smem_raw);  // [stages]
  float* a_s = reinterpret_cast<float*>(smem_raw + 32);  // [S][TR] or none
  float* red = a_s + (kchunks > 1 ? (size_t)S * TR : 0);  // [KG][PT][TR]
  float* wt = red + KG * PT * TR;                         // [NW][PT][TR]
  float* nsum = wt + NW * PT * TR;                        // [KG][TR]
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<size_t>(nsum + KG * TR) + 127) / 128 * 128);
  const int bg_bytes = S * PT * TR * sizeof(T);
  const int stage_bytes = bg_bytes + PT * TR * sizeof(float);

  // Tile i into stage i % stages, by one thread: one box of the bg plane
  // per k chunk ([chunk rows, PT slots, TR rows]) and one of the slot
  // plane; rows past k or R and slots past P arrive as zeros
  const CUtensorMap* bg_m = &bg_map;
  const CUtensorMap* slot_m = &slot_map;
  auto load_tile = [&](int i) {
    unsigned char* st = ring + (i % stages) * stage_bytes;
    unsigned long long* bar = bars + i % stages;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, stage_bytes);
    const int pa = p0 + i * PT;
    for (int c = 0; c < kchunks; ++c)
      tma_load_3d(st + c * kchunk * PT * TR * sizeof(T), bg_m, r0, pa,
                  c * kchunk, bar);
    tma_load_2d(st + bg_bytes, slot_m, r0, pa, bar);
  };

  if (tid < stages) mbar_init(bars + tid);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();
  if (tid == 0) {
    for (int i = 0; i < stages - 1 && i < ntiles; ++i) load_tile(i);
  }
  // this thread's k rows of its row's factor vector in registers (zero
  // past k); the whole block in shared memory when the other k chunks'
  // dots need it too
  float a_r[KPT];
#pragma unroll
  for (int j = 0; j < KPT; ++j)
    a_r[j] = (k_own + j < k && row_ok) ? rows_in[(size_t)(k_own + j) * R + r]
                                       : 0.f;
  if (kchunks > 1) {
    for (int m = g; m < S; m += KG)
      a_s[m * TR + rl] =
          (m < k && row_ok) ? rows_in[(size_t)m * R + r] : 0.f;
  }

  float acc[PASS2 ? Op::NACC : 1][KPT];
  if constexpr (PASS2) {
#pragma unroll
    for (int m = 0; m < Op::NACC; ++m)
#pragma unroll
      for (int j = 0; j < KPT; ++j) acc[m][j] = 0.f;
  }
  float logsum = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    // every thread is done with tile i - 1, whose stage the next copy
    // reuses (and a_s is complete); then tile i has landed
    __syncthreads();
    if (tid == 0 && i + stages - 1 < ntiles) load_tile(i + stages - 1);
    mbar_wait(bars + i % stages, (i / stages) & 1);

    const int pa = p0 + i * PT;
    const int np = min(PT, p1 - pa);
    const unsigned char* st = ring + (i % stages) * stage_bytes;
    // element (row k_own + j, slot pp) of the thread's column
    const T* bt = reinterpret_cast<const T*>(st) + k_own * PT * TR + rl;
    const float* sl = reinterpret_cast<const float*>(st + bg_bytes) + rl;

    // pass 1: this thread's share of each slot's dot, its own k rows
    // (factor values in registers) first, then the other chunks'
#pragma unroll
    for (int pp = 0; pp < PT; ++pp) {
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        d += to_f32(bt[(j * PT + pp) * TR]) * a_r[j];
      for (int c = 0; c < kchunks; ++c) {
        if (c == kc) continue;
        const int off = (c - kc) * kchunk * PT * TR;
        const float* a_c = a_s + (c * kchunk + g * KPT) * TR + rl;
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          d += to_f32(bt[off + (j * PT + pp) * TR]) * a_c[j * TR];
      }
      red[(g * PT + pp) * TR + rl] = d;
    }
    __syncthreads();
    // the slot weights: slots pp = g mod KG of the thread's row, partial
    // dots added in a fixed order; the first k chunk's blocks write the
    // planes.  Slots of the box past this split's share weigh nothing.
    for (int pp = g; pp < PT; pp += KG) {
      if (pp < np) {
        float d = 0.f;
        for (int u = 0; u < KG; ++u) d += red[(u * PT + pp) * TR + rl];
        op.weights(d, sl[pp * TR], (size_t)(pa + pp) * R + r,
                   row_ok && kc == 0, wt + pp * TR + rl, PT * TR, logsum);
      } else if constexpr (PASS2) {
#pragma unroll
        for (int m = 0; m < NW; ++m) wt[(m * PT + pp) * TR + rl] = 0.f;
      }
    }
    if constexpr (PASS2) {
      __syncthreads();
      // pass 2: the register sums over this tile's slots; a slot whose
      // weights are all zero (padding) is skipped
#pragma unroll
      for (int pp = 0; pp < PT; ++pp) {
        float w[NW];
#pragma unroll
        for (int m = 0; m < NW; ++m) w[m] = wt[(m * PT + pp) * TR + rl];
        if (Op::skip(w)) continue;
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          Op::accumulate(acc, j, to_f32(bt[(j * PT + pp) * TR]), w);
      }
    }
  }

  if constexpr (Op::LOGSUM) nsum[g * TR + rl] = logsum;
  __syncthreads();
  if (!row_ok) return;
  float* o = out + (size_t)split * Op::out_rows(k) * R;
  if (Op::LOGSUM && kc == 0 && g == 0) {
    float s = 0.f;
    for (int u = 0; u < KG; ++u) s += nsum[u * TR + rl];
    o[r] = -s;
  }
  if constexpr (PASS2) {
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      if (k_own + j < k) Op::store(o, acc, j, k_own + j, k, R, r);
  }
}

// The tensor maps of a launch: bg as [k, P, R] (bf16 or f32) in boxes of
// [kchunk, pt, TR], the slot plane as [P, R] f32 in boxes of [pt, TR].
inline cudaError_t encode_maps(const void* bg, bool bf16, const void* slots,
                               int k, int P, int R, int kchunk, int pt,
                               CUtensorMap* bg_map, CUtensorMap* slot_map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const size_t it = bf16 ? 2 : 4;
  const cuuint64_t dims3[3] = {(cuuint64_t)R, (cuuint64_t)P, (cuuint64_t)k};
  const cuuint64_t strides3[2] = {R * it, (cuuint64_t)P * R * it};
  const cuuint32_t box3[3] = {(cuuint32_t)SWEEP_TR, (cuuint32_t)pt,
                              (cuuint32_t)kchunk};
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult res = encode(
      bg_map,
      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      3, const_cast<void*>(bg), dims3, strides3, box3, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  const cuuint64_t dims2[2] = {(cuuint64_t)R, (cuuint64_t)P};
  const cuuint64_t strides2[1] = {R * 4};
  const cuuint32_t box2[2] = {(cuuint32_t)SWEEP_TR, (cuuint32_t)pt};
  res = encode(slot_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
               const_cast<void*>(slots), dims2, strides2, box2, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The kernel for a slot tile of pt slots (1, 2, 4 or 8), or null.
template <typename T, typename Op>
auto sweep_kernel_for(int pt) -> decltype(&plane_sweep_kernel<T, Op, 1>) {
  switch (pt) {
    case 1: return plane_sweep_kernel<T, Op, 1>;
    case 2: return plane_sweep_kernel<T, Op, 2>;
    case 4: return plane_sweep_kernel<T, Op, 4>;
    case 8: return plane_sweep_kernel<T, Op, 8>;
    default: return nullptr;
  }
}

template <typename T, typename Op>
cudaError_t sweep_prepare(int k, int kg, int pt, int stages, size_t* smem,
                          decltype(&plane_sweep_kernel<T, Op, 1>)* kern) {
  *kern = sweep_kernel_for<T, Op>(pt);
  if (*kern == nullptr || kg < 1 || kg > SWEEP_MAX_KG || stages < 2 ||
      stages > 4)
    return cudaErrorInvalidValue;
  *smem = sweep_smem_bytes<T, Op::NW>(k, kg, pt, stages);
  cudaError_t err = cudaFuncSetAttribute(
      *kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(*kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

// Blocks of the kernel that fit on one SM at this shape (0 when its
// shared memory exceeds what a block may use), and that shared memory.
template <typename T, typename Op>
cudaError_t sweep_occupancy(int k, int kg, int pt, int stages, int* smem,
                            int* blocks) {
  *blocks = 0;
  *smem = (int)sweep_smem_bytes<T, Op::NW>(k, kg, pt, stages);
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess || *smem > limit) return err;
  size_t bytes = 0;
  decltype(&plane_sweep_kernel<T, Op, 1>) kern = nullptr;
  err = sweep_prepare<T, Op>(k, kg, pt, stages, &bytes, &kern);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kern, kg * SWEEP_TR, bytes);
  return err;
}

// One launch: grid (k chunks, row tiles, splits) of kg * 64 threads (one
// k chunk of blocks does every chunk's dot when the Op has no pass 2); a
// bucket cut into splits > 1 sums into `scratch` [splits, out_rows, R]
// and adds the splits into `out` [out_rows, R] in a fixed order.
template <typename T, typename Op>
cudaError_t launch_sweep(const void* bg, const void* slot_in,
                         const void* rows_in, void* out, void* scratch,
                         const Op& op, int k, int P, int R, int kg, int pt,
                         int stages, int p_per_split, cudaStream_t stream) {
  if (p_per_split < 1 || R % 8 != 0) return cudaErrorInvalidValue;
  size_t smem = 0;
  decltype(&plane_sweep_kernel<T, Op, 1>) kern = nullptr;
  cudaError_t err = sweep_prepare<T, Op>(k, kg, pt, stages, &smem, &kern);
  if (err != cudaSuccess) return err;
  CUtensorMap bg_map, slot_map;
  err = encode_maps(bg, sizeof(T) == 2, slot_in, k, P, R, kg * SWEEP_KPT, pt,
                    &bg_map, &slot_map);
  if (err != cudaSuccess) return err;
  const int splits = (P + p_per_split - 1) / p_per_split;
  dim3 grid(Op::NACC > 0 ? sweep_kchunks(k, kg) : 1,
            (R + SWEEP_TR - 1) / SWEEP_TR, splits);
  float* dst = static_cast<float*>(splits > 1 ? scratch : out);
  kern<<<grid, kg * SWEEP_TR, smem, stream>>>(
      bg_map, slot_map, static_cast<const float*>(rows_in), dst, op, k, P, R,
      p_per_split, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  sum_splits(static_cast<const float*>(scratch), static_cast<float*>(out),
             (long long)Op::out_rows(k) * R, splits, stream);
  return cudaGetLastError();
}

// launch_sweep and sweep_occupancy with the plane's type chosen at run time
// (bg_bf16 != 0: bfloat16, else float32), as the C entry points take it.
template <typename Op>
int launch_sweep_as(const void* bg, int bg_bf16, const void* slot_in,
                    const void* rows_in, void* out, void* scratch,
                    const Op& op, int k, int P, int R, int kg, int pt,
                    int stages, int p_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bg_bf16 ? launch_sweep<__nv_bfloat16>(bg, slot_in, rows_in, out, scratch,
                                            op, k, P, R, kg, pt, stages,
                                            p_per_split, s)
              : launch_sweep<float>(bg, slot_in, rows_in, out, scratch, op, k,
                                    P, R, kg, pt, stages, p_per_split, s);
  return static_cast<int>(err);
}

template <typename Op>
int sweep_occupancy_as(int bg_bf16, int k, int kg, int pt, int stages,
                       int* smem, int* blocks) {
  cudaError_t err =
      bg_bf16 ? sweep_occupancy<__nv_bfloat16, Op>(k, kg, pt, stages, smem,
                                                   blocks)
              : sweep_occupancy<float, Op>(k, kg, pt, stages, smem, blocks);
  return static_cast<int>(err);
}

}  // namespace poismf
