// ls_round: one round of the TNCG ray line search for every row in one
// launch: fold the round's C trials into each row's search, then form the
// next round's C candidate steps.  The plain route, which the solver keeps
// for CPU and float64 state, is poismf_torch/solvers/tncg.py _ls_fold
// followed by _ls_candidates.
//
// Replaces no TPU kernel: the JAX package runs the round as one XLA-fused
// loop body (poismf_tpu/solvers/tncg.py), which eager PyTorch runs as ~415
// small launches a round at C = 4, each over a few [R] vectors.
//
// What bounds it on Hopper: nothing on the card.  A row reads its state
// (13 floats, 2 flags, nfeval), the C trials' steps, f and g.d and four
// fixed floats, and writes back the state and the next C steps: ~200
// bytes at C = 4, ~70 MB and ~21 us at 3.35 TB/s on the 356,864 rows of
// the Last.FM-shaped user side.  What it saves is the host's time to
// launch the plain route's ops, which set the pace of a tncg fit.
//
// Design:
// - One thread a row: the row's state read once into registers, the C
//   trials folded in processing order, the state written back in place,
//   then the next round's candidates written over the round's.
// - The arithmetic is PyTorch's elementwise ops, op by op, so every state
//   vector and candidate is bitwise the plain route's on the card: each
//   multiply, add, subtract and divide rounded on its own (__fmul_rn and
//   the like: the build keeps --fmad=true, and a fused multiply-add rounds
//   once where two PyTorch ops round twice), the left-to-right association
//   of each expression as written in tncg.py, Python's scalars rounded to
//   float32 from their double value (as PyTorch rounds a scalar operand),
//   torch.minimum / maximum / clamp_min with their NaN rules, and a
//   correctly rounded sqrt and division.
// - Candidates-only mode (no trials) forms round 1's candidates from the
//   initial state and leaves the state as it is.
// - A block ORs its rows' "still searching" (__syncthreads_or) and one
//   thread ORs it into the round's flag: the same flag in any order.

#include <math_constants.h>

#include "common.cuh"

namespace poismf {
namespace {

// The state's float rows, in the order of kernels/ls_round.STATE_FLOATS.
enum Field {
  ALPHA, LO, HI, F_LO, G_LO, F_HI, G_HI, A_NEW, F_NEW, A_BEST, F_BEST,
  RELTOL, ABSTOL, N_FIELDS
};

// tncg.py's Python scalars as PyTorch hands them to a float32 op: the
// double's value rounded to float32.
constexpr float RMU = static_cast<float>(1e-4);            // LS_RMU
constexpr float ETA = static_cast<float>(0.25);            // TNC_ETA
constexpr float TENTH = static_cast<float>(0.1);
constexpr float TINY = static_cast<float>(1e-30);
constexpr float NEAR_SPE = static_cast<float>(1.0 - 1e-6);
constexpr float EXTRAP = 4.0f;                              // LS_EXTRAP

constexpr int THREADS = 256;

struct Args {
  float* state;           // [N_FIELDS, R]
  unsigned char* flags;   // [2, R]: found, searching
  int* nfeval;            // [R]
  float* cands;           // [C, R]: in, the round's steps; out, the next's
  const float* f_c;       // [C, R] trial f, or null (candidates only)
  const float* gu_c;      // [C, R] trial g.d
  const float* f;         // [R] f at the search's start
  const float* dginit;    // [R] g.d at the start
  const float* spe;       // [R] step to the nearest bound
  const float* tnytol;    // [R] getptc's tiny tolerance
  int* more;              // set to 1 when a row still searches
  int C;
  long long R;
  int maxupd;
  float ftol;
};

// torch.minimum / torch.maximum: a NaN operand, the first one first, is
// the result.
__device__ __forceinline__ float t_minimum(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float t_maximum(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.clamp_min(v, scalar): NaN stays NaN.
__device__ __forceinline__ float t_clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// _ls_fold for row r: the C trials in processing order, then getptc's
// collapse test and the ladder's move; s holds the row's state.
__device__ __forceinline__ void fold(const Args& a, long long r,
                                     float (&s)[N_FIELDS], bool& found,
                                     bool& searching, int& nfe) {
  const long long R = a.R;
  const float f = a.f[r], dg = a.dginit[r], spe = a.spe[r];
  float lo = s[LO], hi = s[HI], f_lo = s[F_LO], g_lo = s[G_LO];
  float f_hi = s[F_HI], g_hi = s[G_HI];
  float a_best = s[A_BEST], f_best = s[F_BEST];
  float a_acc = 0.f, f_acc = CUDART_INF_F;
  bool acc = false;
  const bool searching0 = searching;
  const bool has_hi0 = isfinite(hi);
  const float curv_lo_at = __fmul_rn(dg, ETA);    // TNC_ETA * dginit
  const float curv_hi_at = __fmul_rn(dg, -ETA);   // -TNC_ETA * dginit
  const float newcon_at = __fmul_rn(spe, NEAR_SPE);
  for (int c = 0; c < a.C; ++c) {
    const float a_c = a.cands[c * R + r];
    const float f_t = a.f_c[c * R + r], gu_t = a.gu_c[c * R + r];
    const bool usable = searching0 && !acc && a_c > lo && a_c < hi
                        && nfe < a.maxupd;
    nfe += usable;
    const bool suff = isfinite(f_t)
        && f_t <= __fadd_rn(f, __fmul_rn(__fmul_rn(a_c, RMU), dg));
    const bool curv_lo = gu_t >= curv_lo_at;
    const bool curv_hi = gu_t <= curv_hi_at;
    const bool wolfe = usable && suff && curv_lo && curv_hi;
    const bool newcon = usable && suff && a_c >= newcon_at && !curv_lo;
    const bool ok =
        (a.C > 1 ? wolfe && (!has_hi0 || c == 0) : wolfe) || newcon;
    if (ok && !acc) {
      a_acc = a_c;
      f_acc = f_t;
    }
    acc = acc || ok;
    if (usable && isfinite(f_t) && f_t < f_best) {
      a_best = a_c;
      f_best = f_t;
    }
    if (usable && !ok && (!suff || !curv_hi)) {
      hi = a_c;
      f_hi = f_t;
      g_hi = gu_t;
    }
    if (usable && !ok && suff && !curv_lo && curv_hi) {
      lo = a_c;
      f_lo = f_t;
      g_lo = gu_t;
    }
  }
  searching = searching0 && !acc && nfe < a.maxupd;
  const bool has_hi = isfinite(hi);
  const float reltol = s[RELTOL], abstol = s[ABSTOL];
  const float tol = __fadd_rn(__fmul_rn(reltol, lo), abstol);
  const bool collapse = has_hi && __fsub_rn(hi, lo) <= __fmul_rn(tol, 2.0f);
  const bool improved = f_best < f;
  const float fw_gap =
      isfinite(f_hi) ? fabsf(__fsub_rn(f, f_hi)) : CUDART_INF_F;
  const bool dead_ok = collapse && improved;
  const bool shrinkable = collapse && !improved;
  bool dead_fail = shrinkable && fw_gap <= a.ftol;
  bool cont = shrinkable && !dead_fail;
  const bool too_tiny = __fmul_rn(tol, TENTH) < a.tnytol[r];
  dead_fail = dead_fail || (cont && too_tiny);
  cont = cont && !too_tiny;
  searching = searching && !(dead_ok || dead_fail);
  if (searching && !has_hi) {
    float extrap = 1.0f;  // LS_EXTRAP ** C, exact
    for (int c = 0; c < a.C; ++c) extrap = __fmul_rn(extrap, EXTRAP);
    s[ALPHA] = t_minimum(__fmul_rn(s[ALPHA], extrap), spe);
  }
  s[LO] = lo;
  s[HI] = hi;
  s[F_LO] = f_lo;
  s[G_LO] = g_lo;
  s[F_HI] = f_hi;
  s[G_HI] = g_hi;
  found = found || acc;
  if (acc) {
    s[A_NEW] = a_acc;
    s[F_NEW] = f_acc;
  }
  s[A_BEST] = a_best;
  s[F_BEST] = f_best;
  if (cont) {
    s[RELTOL] = __fmul_rn(reltol, TENTH);
    s[ABSTOL] = __fmul_rn(abstol, TENTH);
  }
}

// _ls_candidates for row r from its state s, written to cands[c, r].
__device__ __forceinline__ void candidates(const Args& a, long long r,
                                           const float (&s)[N_FIELDS]) {
  const long long R = a.R;
  const int C = a.C;
  float* out = a.cands + r;
  const float lo = s[LO], hi = s[HI];
  if (!isfinite(hi)) {
    // the extrapolation ladder, clamped at spe (C = 1: its one rung,
    // with no multiply)
    const float spe = a.spe[r];
    if (C == 1) {
      out[0] = t_minimum(s[ALPHA], spe);
      return;
    }
    float rung = 1.0f;  // LS_EXTRAP ** c, exact
    for (int c = 0; c < C; ++c) {
      out[c * R] = t_minimum(__fmul_rn(s[ALPHA], rung), spe);
      rung = __fmul_rn(rung, EXTRAP);
    }
    return;
  }
  const float f_lo = s[F_LO], g_lo = s[G_LO], f_hi = s[F_HI], g_hi = s[G_HI];
  const float span = __fsub_rn(hi, lo);
  if (C > 1 && !isfinite(f_hi) && __fmul_rn(hi, 0.25f) > lo) {
    // poisoned upper end: a descending geometric ladder from hi
    float q = 1.0f;  // 0.25 ** (c + 1), exact
    for (int c = 0; c < C; ++c) {
      q = __fmul_rn(q, 0.25f);
      out[c * R] = __fmul_rn(hi, q);
    }
    return;
  }
  // the safeguarded cubic through both ends, bisection where undefined
  const float d1 = __fadd_rn(
      __fadd_rn(g_lo, g_hi),
      __fdiv_rn(__fmul_rn(__fsub_rn(f_lo, f_hi), 3.0f),
                t_clamp_min(span, TINY)));
  const float rad = __fsub_rn(__fmul_rn(d1, d1), __fmul_rn(g_lo, g_hi));
  const float d2 = __fsqrt_rn(t_clamp_min(rad, 0.0f));
  const float denom = __fadd_rn(__fsub_rn(g_hi, g_lo), __fmul_rn(d2, 2.0f));
  const float a_cubic = __fsub_rn(
      hi, __fdiv_rn(__fmul_rn(span, __fsub_rn(__fadd_rn(g_hi, d2), d1)),
                    denom));
  const bool cubic_ok = isfinite(f_hi) && rad >= 0.0f
                        && fabsf(denom) > TINY && isfinite(a_cubic);
  out[0] = cubic_ok
      ? t_minimum(t_maximum(a_cubic, __fadd_rn(lo, __fmul_rn(span, TENTH))),
                  __fsub_rn(hi, __fmul_rn(span, TENTH)))
      : __fmul_rn(__fadd_rn(lo, hi), 0.5f);
  // even subdivisions lo + span * ((c) / C), the fraction a double
  // rounded to float32 as PyTorch rounds a Python scalar
  for (int c = 1; c < C; ++c) {
    const float frac = __double2float_rn(__ddiv_rn(c, C));
    out[c * R] = __fadd_rn(lo, __fmul_rn(span, frac));
  }
}

__global__ void __launch_bounds__(THREADS) ls_round_kernel(Args a) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  int still = 0;
  if (r < a.R) {
    const long long R = a.R;
    float s[N_FIELDS];
#pragma unroll
    for (int i = 0; i < N_FIELDS; ++i) s[i] = a.state[i * R + r];
    bool searching = a.flags[R + r] != 0;
    if (a.f_c != nullptr) {
      bool found = a.flags[r] != 0;
      int nfe = a.nfeval[r];
      fold(a, r, s, found, searching, nfe);
#pragma unroll
      for (int i = 0; i < N_FIELDS; ++i) a.state[i * R + r] = s[i];
      a.flags[r] = found;
      a.flags[R + r] = searching;
      a.nfeval[r] = nfe;
    }
    candidates(a, r, s);
    still = searching;
  }
  if (__syncthreads_or(still) && threadIdx.x == 0) atomicOr(a.more, 1);
}

}  // namespace
}  // namespace poismf

// state: [13, R] f32 (kernels/ls_round.STATE_FLOATS); flags: [2, R] bool
// (found, searching); nfeval: [R] int32; cands: [C, R] f32, the round's
// steps, overwritten with the next round's; f_c, gu_c: [C, R] f32 trial f
// and g.d at cands, or both null to form candidates from the state alone;
// f, dginit, spe, tnytol: [R] f32; more: one int32, set to 1 when a row
// still searches after the round (left as it is otherwise).  All
// contiguous, on the stream's device.
extern "C" int poismf_ls_round(void* state, void* flags, void* nfeval,
                               void* cands, const void* f_c, const void* gu_c,
                               const void* f, const void* dginit,
                               const void* spe, const void* tnytol,
                               void* more, int C, long long R, int maxupd,
                               float ftol, void* stream) {
  if (R == 0) return 0;
  poismf::Args a;
  a.state = static_cast<float*>(state);
  a.flags = static_cast<unsigned char*>(flags);
  a.nfeval = static_cast<int*>(nfeval);
  a.cands = static_cast<float*>(cands);
  a.f_c = static_cast<const float*>(f_c);
  a.gu_c = static_cast<const float*>(gu_c);
  a.f = static_cast<const float*>(f);
  a.dginit = static_cast<const float*>(dginit);
  a.spe = static_cast<const float*>(spe);
  a.tnytol = static_cast<const float*>(tnytol);
  a.more = static_cast<int*>(more);
  a.C = C;
  a.R = R;
  a.maxupd = maxupd;
  a.ftol = ftol;
  const long long blocks = (R + poismf::THREADS - 1) / poismf::THREADS;
  poismf::ls_round_kernel<<<(unsigned)blocks, poismf::THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
