// assemble: the per-slot sums of ops/ell.py _assemble in one launch, in
// place on the [n_rows, D] output whose covered rows hold the buckets' row
// outputs: every group of Assembly's plan summed in its fixed order and
// written to its target slot, the rows that add into another slot zeroed
// once read, and the other rows that must read zero (dropped rows no group
// reads, the zero tail) zeroed.  The plain route, which CPU tensors take,
// is ops/ell.py _assemble_plain: a gather, masked_fill_, segment_reduce
// and an index write.
//
// Replaces no TPU kernel: the JAX package's _assemble
// (poismf_tpu/ops/ell.py:568) is a plain .at[].add that XLA lowers.  On the
// card torch.segment_reduce gave each (group, column) one thread that loads
// the group's rows one after another, so a compact sub-ELL's zero-tail
// group (every fill row of every bucket: 114,640 rows on the Last.FM-shaped
// user side) cost ~a memory latency a row.
//
// The contract: each target's value is -0.0 + v_0 + v_1 + ... over
// order[offsets[g] : offsets[g + 1]], added strictly left to right, each
// add rounded on its own (__fadd_rn / __dadd_rn: no contraction, no
// reassociation, no atomics), so the output is bit for bit the plain
// route's, in float32 and float64.  The first read of a group is its own
// slot or, where the target is not a row written in place, the zero tail's
// last slot, which reads +0.0 at that point of the plain route: the kernel
// takes it as that constant and never reads that slot, so the zero-tail
// group may write it while other groups "read" it.  assembly() checks on
// the host that no other read aliases a write: a row adds into one group
// only, and a row that is a target is read by its own group alone.
//
// What bounds it on Hopper:
// - A long group (at least LONG_GROUP_ROWS reads) is bound by its chain of
//   dependent adds, not by bytes: 114,640 float32 adds at ~4 cycles each
//   are ~0.23 ms at 1.98 GHz (36,812 on the item side: ~0.07 ms), while
//   its 114,640 x 50 x 4 B = 23 MB take ~7 us at 3.35 TB/s.  A block per
//   (group, LONG_COLS columns): its three producer warps stream the rows
//   flat[order[j], c0 : c0 + LONG_COLS] with cp.async into a ring of
//   STAGES tiles in shared memory, each thread its own rows of a tile,
//   their slots loaded two tiles ahead (a slot's load and then its row's
//   are two trips to memory, which the add chain must not wait on); one
//   thread a column of the consumer warp adds each tile's rows in order,
//   its next UNROLL values loaded (16 bytes at a time, a stage holding its
//   columns apart) before it adds the current ones; the warps hand the
//   ring's stages over through named barriers, the producers before they
//   wait for a stage to refill.  Each producer zeroes the add rows it
//   copied once their copies have landed.  On an H100 at 700 W the
//   114,640-row zero tail took 0.338 ms at D = 1 (68% of the chain's
//   floor), 0.397 ms at D = 4 and 1.249 ms at D = 50 (18.5%), where the
//   producers' 4-byte copies of rows 200 bytes apart each take a sector
//   of their own; lanes over whole row segments measured slower (their
//   smaller tiles and longer loops).
// - A short group (a long row's primary and its chunks: a few dozen rows)
//   is bound by the latency of its loads: a warp a group, lanes over the
//   columns, SHORT_UNROLL rows' loads in flight ahead of each lane's chain.
// - The zeroing of the remaining rows is a few hundred rows: a grid-stride
//   loop over Assembly.zero_rows, or, on a layout with no group, over the
//   rows the drop mask marks and the zero tail.
// Blocks: the long groups' first (they set the launch's length), then the
// short groups', then the zeroing.

#include <cuda_runtime.h>

namespace poismf {
namespace {

// A block: the consumer warp and 3 producer warps.  An SM deals a block's
// warps to its four schedulers in turn, so the producers issue from the
// other three and take none of the consumer's issue slots.
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PRODUCERS = THREADS - 32;
constexpr int LONG_COLS = 8;        // columns a long-group block sums
constexpr int STAGES = 4;           // ring stages of a long-group block
constexpr int LAG = STAGES - 1;     // tiles a producer keeps in flight
constexpr int STAGE_BYTES = 10240;  // a stage's values, its padding aside
constexpr int PAD_BYTES = 16;       // after each column of a stage
constexpr int MAX_RPT = 4;          // rows a producer copies a tile
constexpr int MAX_TR = MAX_RPT * PRODUCERS;
constexpr int UNROLL = 32;          // a consumer lane's values ahead
constexpr int SHORT_UNROLL = 16;    // a short-group lane's loads ahead
constexpr int MAX_ZERO_BLOCKS = 1024;
constexpr int STAGE_ALLOC = STAGE_BYTES + LONG_COLS * PAD_BYTES;
constexpr int SMEM_BYTES = STAGES * (STAGE_ALLOC + MAX_TR * 4);

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
// The 16 bytes of values a consumer lane loads at once, added in order.
__device__ __forceinline__ float add_rn(float acc, float4 v) {
  return add_rn(add_rn(add_rn(add_rn(acc, v.x), v.y), v.z), v.w);
}
__device__ __forceinline__ double add_rn(double acc, double2 v) {
  return add_rn(add_rn(acc, v.x), v.y);
}
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; };
template <> struct Vec<double> { using type = double2; };

// Named barriers: 1..STAGES mark a stage full, STAGES+1..2*STAGES empty.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(THREADS) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(s),
               "l"(gmem), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Steps commit a group each: before step t's, tile t - LAG's is the
// newest but LAG - 1.
__device__ __forceinline__ void cp_async_wait_done() {
  asm volatile("cp.async.wait_group %0;" ::"n"(LAG - 1) : "memory");
}

template <typename T>
struct Args {
  T* flat;                        // [n_rows, D]
  const long long* targets;       // [groups]
  const long long* order;         // [reads]
  const long long* offsets;       // [groups + 1]
  const long long* long_groups;   // [n_long]
  const long long* short_groups;  // [n_short]
  const long long* zero_rows;     // [n_zero] (with groups)
  const bool* drop;               // [covered], or null (without groups)
  long long n_rows, covered, n_zero;
  int D, n_long, n_short, col_tiles, long_blocks, short_blocks;
};

// A long group's tiling: block b sums columns c0 .. c0 + W - 1 of group
// g's n reads (from order[start]), in tiles of TR = RPT * PRODUCERS rows;
// producer thread p copies rows p, p + PRODUCERS, ... of each tile.  A
// stage holds a tile column by column, each column PAD_BYTES past the
// last, so that the consumer's 16-byte loads of eight columns fall in
// distinct banks.
template <typename T>
struct LongTile {
  long long start, n, target, ntiles;
  int zero_slot, c0, W, RPT, TR, ld, p;
  T* data;    // [STAGES][STAGE_ALLOC / sizeof(T)]: column c at c * ld
  int* sidx;  // [STAGES][MAX_TR]: the slot each row of a tile read
};

// The slots of tile t's rows that producer L.p copies (the zero tail's
// past the group's end), loaded two tiles ahead of their copies.
template <typename T>
__device__ __forceinline__ void load_slots(const Args<T>& a,
                                           const LongTile<T>& L, long long t,
                                           int (&slot)[MAX_RPT]) {
#pragma unroll
  for (int k = 0; k < MAX_RPT; ++k) {
    const long long j = t * L.TR + L.p + k * PRODUCERS;
    slot[k] = (k < L.RPT && t < L.ntiles && j < L.n)
                  ? static_cast<int>(a.order[L.start + j])
                  : L.zero_slot;
  }
}

// Producer step t: first hand tile t - LAG over, once its copies have
// landed, and zero the add rows it read (the target and the zero tail
// excepted); then copy tile t into its stage (slots from load_slots).  The
// hand-over comes first so that the consumer never waits on a stage the
// producers are still waiting to refill.  One copy group a step.
template <typename T>
__device__ __forceinline__ void produce(const Args<T>& a,
                                       const LongTile<T>& L, long long t,
                                       const int (&slot)[MAX_RPT]) {
  if (t >= L.ntiles + LAG) return;
  const long long d = t - LAG;
  if (d >= 0) {
    cp_async_wait_done();
    const int s = static_cast<int>(d % STAGES);
    bar_arrive(1 + s);
    const long long rows = min((long long)L.TR, L.n - d * L.TR);
#pragma unroll
    for (int k = 0; k < MAX_RPT; ++k) {
      const int r = L.p + k * PRODUCERS;
      if (k >= L.RPT || r >= rows) continue;
      const long long i = L.sidx[s * MAX_TR + r];  // this thread's
      if (i == L.zero_slot || i == L.target) continue;
      for (int c = 0; c < L.W; ++c) a.flat[i * a.D + L.c0 + c] = T(0);
    }
  }
  if (t < L.ntiles) {
    const int s = static_cast<int>(t % STAGES);
    if (t >= STAGES) bar_sync(1 + STAGES + s);
    const long long rows = min((long long)L.TR, L.n - t * L.TR);
    T* st = L.data + s * (STAGE_ALLOC / sizeof(T));
#pragma unroll
    for (int k = 0; k < MAX_RPT; ++k) {
      const int r = L.p + k * PRODUCERS;
      if (k >= L.RPT || r >= rows) continue;
      L.sidx[s * MAX_TR + r] = slot[k];
      const T* src = a.flat + static_cast<long long>(slot[k]) * a.D + L.c0;
      for (int c = 0; c < L.W; ++c) {
        if (slot[k] == L.zero_slot) {
          st[c * L.ld + r] = T(0);  // the zero tail: +0.0, never read
        } else {
          cp_async<sizeof(T)>(st + c * L.ld + r, src + c);
        }
      }
    }
  }
  cp_async_commit();
}

// The consumer lane's column of a tile: rows values at q (16-byte
// aligned), added in order, the next UNROLL values loaded before the
// current ones are added.
template <typename T>
__device__ __forceinline__ T add_column(T acc, const T* q, int rows) {
  using V = typename Vec<T>::type;
  constexpr int VE = sizeof(V) / sizeof(T);
  constexpr int NV = UNROLL / VE;
  int r = 0;
  if (rows >= UNROLL) {
    V v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) v[i] = reinterpret_cast<const V*>(q)[i];
    for (; r + 2 * UNROLL <= rows; r += UNROLL) {
      V w[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i)
        w[i] = reinterpret_cast<const V*>(q + r + UNROLL)[i];
#pragma unroll
      for (int i = 0; i < NV; ++i) acc = add_rn(acc, v[i]);
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = w[i];
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) acc = add_rn(acc, v[i]);
    r += UNROLL;
  }
  for (; r < rows; ++r) acc = add_rn(acc, q[r]);
  return acc;
}

// A long group: block b of the long range.
template <typename T>
__device__ void long_group(const Args<T>& a, int b, unsigned char* smem) {
  constexpr int STAGE_ELEMS = STAGE_BYTES / sizeof(T);
  LongTile<T> L;
  const long long g = a.long_groups[b / a.col_tiles];
  L.c0 = (b % a.col_tiles) * LONG_COLS;
  L.W = min(LONG_COLS, a.D - L.c0);
  L.RPT = min(MAX_RPT, STAGE_ELEMS / (L.W * PRODUCERS));
  L.TR = L.RPT * PRODUCERS;
  L.ld = L.TR + PAD_BYTES / static_cast<int>(sizeof(T));
  L.start = a.offsets[g];
  L.n = a.offsets[g + 1] - L.start;
  L.target = a.targets[g];
  L.ntiles = (L.n + L.TR - 1) / L.TR;
  L.zero_slot = static_cast<int>(a.n_rows - 1);
  L.p = static_cast<int>(threadIdx.x) - 32;
  L.data = reinterpret_cast<T*>(smem);
  L.sidx = reinterpret_cast<int*>(smem + STAGES * STAGE_ALLOC);
  const int lane = threadIdx.x % 32;
  if (threadIdx.x < 32) {
    T acc = T(-0.0);
    for (long long t = 0; t < L.ntiles; ++t) {
      const int s = static_cast<int>(t % STAGES);
      bar_sync(1 + s);
      const int rows = static_cast<int>(min((long long)L.TR, L.n - t * L.TR));
      if (lane < L.W)
        acc = add_column(acc, L.data + s * (STAGE_ALLOC / sizeof(T))
                                  + lane * L.ld, rows);
      if (t + STAGES < L.ntiles) bar_arrive(1 + STAGES + s);
    }
    if (lane < L.W) a.flat[L.target * a.D + L.c0 + lane] = acc;
    return;
  }
  // two tiles' slots in registers ahead of their copies, in turns
  int s0[MAX_RPT], s1[MAX_RPT];
  load_slots(a, L, 0, s0);
  load_slots(a, L, 1, s1);
  for (long long t = 0; t < L.ntiles + LAG; t += 2) {
    produce(a, L, t, s0);
    load_slots(a, L, t + 2, s0);
    produce(a, L, t + 1, s1);
    load_slots(a, L, t + 3, s1);
  }
}

// A short group: one warp, lanes over the columns.
template <typename T>
__device__ void short_group(const Args<T>& a, long long g, int lane) {
  const long long start = a.offsets[g], end = a.offsets[g + 1];
  const long long target = a.targets[g];
  const long long zero_slot = a.n_rows - 1;
  const int D = a.D;
  for (int c = lane; c < D; c += 32) {
    T acc = T(-0.0);
    for (long long j = start; j < end; j += SHORT_UNROLL) {
      long long idx[SHORT_UNROLL];
      T v[SHORT_UNROLL];
#pragma unroll
      for (int u = 0; u < SHORT_UNROLL; ++u)
        idx[u] = j + u < end ? a.order[j + u] : zero_slot;
#pragma unroll
      for (int u = 0; u < SHORT_UNROLL; ++u)
        v[u] = idx[u] != zero_slot ? a.flat[idx[u] * D + c] : T(0);
#pragma unroll
      for (int u = 0; u < SHORT_UNROLL; ++u)
        if (j + u < end) acc = add_rn(acc, v[u]);
      // the add rows read, zeroed (a row adds into this group alone)
#pragma unroll
      for (int u = 0; u < SHORT_UNROLL; ++u)
        if (idx[u] != zero_slot && idx[u] != target)
          a.flat[idx[u] * D + c] = T(0);
    }
    a.flat[target * D + c] = acc;
  }
}

// The rows no group reads or writes that must read zero.
template <typename T>
__device__ void zero_rest(const Args<T>& a, long long b, long long blocks) {
  const long long stride = blocks * THREADS;
  const long long D = a.D;
  if (a.targets != nullptr) {
    for (long long e = b * THREADS + threadIdx.x; e < a.n_zero * D;
         e += stride)
      a.flat[a.zero_rows[e / D] * D + e % D] = T(0);
    return;
  }
  const long long lo = a.drop != nullptr ? 0 : a.covered;
  for (long long r = lo + b * THREADS + threadIdx.x; r < a.n_rows;
       r += stride)
    if (r >= a.covered || a.drop[r])
      for (long long c = 0; c < D; ++c) a.flat[r * D + c] = T(0);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) assemble_kernel(Args<T> a) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  long long b = blockIdx.x;
  if (b < a.long_blocks) {
    long_group(a, static_cast<int>(b), smem);
    return;
  }
  b -= a.long_blocks;
  if (b < a.short_blocks) {
    const long long i = b * WARPS + threadIdx.x / 32;
    if (i < a.n_short) short_group(a, a.short_groups[i], threadIdx.x % 32);
    return;
  }
  b -= a.short_blocks;
  zero_rest(a, b,
            static_cast<long long>(gridDim.x) - a.long_blocks - a.short_blocks);
}

template <typename T>
int launch(void* flat, const void* targets, const void* order,
           const void* offsets, const void* long_groups, int n_long,
           const void* short_groups, int n_short, const void* zero_rows,
           long long n_zero, const void* drop, long long n_rows,
           long long covered, int D, cudaStream_t stream) {
  Args<T> a;
  a.flat = static_cast<T*>(flat);
  a.targets = static_cast<const long long*>(targets);
  a.order = static_cast<const long long*>(order);
  a.offsets = static_cast<const long long*>(offsets);
  a.long_groups = static_cast<const long long*>(long_groups);
  a.short_groups = static_cast<const long long*>(short_groups);
  a.zero_rows = static_cast<const long long*>(zero_rows);
  a.drop = static_cast<const bool*>(drop);
  a.n_rows = n_rows;
  a.covered = covered;
  a.n_zero = n_zero;
  a.D = D;
  a.n_long = n_long;
  a.n_short = n_short;
  a.col_tiles = (D + LONG_COLS - 1) / LONG_COLS;
  a.long_blocks = n_long * a.col_tiles;
  a.short_blocks = (n_short + WARPS - 1) / WARPS;
  long long zero_blocks;
  if (targets != nullptr) {
    zero_blocks = (n_zero * D + THREADS - 1) / THREADS;
  } else {
    const long long lo = drop != nullptr ? 0 : covered;
    zero_blocks = (n_rows - lo + THREADS - 1) / THREADS;
  }
  if (zero_blocks > MAX_ZERO_BLOCKS) zero_blocks = MAX_ZERO_BLOCKS;
  const long long blocks = a.long_blocks + a.short_blocks + zero_blocks;
  if (blocks == 0) return 0;
  assemble_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace poismf

// flat: [n_rows, D] float32 (is_double 0) or float64 (1), its rows
// [0, covered) the buckets' row outputs, overwritten with the assembled
// values; targets, order, offsets, long_groups, short_groups and zero_rows:
// int64, Assembly's (targets and order null when there is no group;
// zero_rows null then too, and drop, [covered] bool or null, marks the
// rows to zero besides the tail).  All contiguous, on the stream's device.
extern "C" int poismf_assemble(void* flat, int is_double, const void* targets,
                               const void* order, const void* offsets,
                               const void* long_groups, int n_long,
                               const void* short_groups, int n_short,
                               const void* zero_rows, long long n_zero,
                               const void* drop, long long n_rows,
                               long long covered, int D, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return poismf::launch<double>(flat, targets, order, offsets, long_groups,
                                  n_long, short_groups, n_short, zero_rows,
                                  n_zero, drop, n_rows, covered, D, s);
  return poismf::launch<float>(flat, targets, order, offsets, long_groups,
                               n_long, short_groups, n_short, zero_rows,
                               n_zero, drop, n_rows, covered, D, s);
}
