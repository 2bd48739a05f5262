// The pair recursion shared by kernels B1 (pair_estep_fused.cu) and B3
// (pair_bwd_fwd.cu): for one (base HMM i, reduced HMM j) pair, given the
// expected emission matrix ell[b][r], the tau-1 backward steps, the
// termination ll_elbo = sum_b prior_b lse_b, and the forward pass that
// accumulates nu_1, sum_xi and sum_t_nu.  It replaces `_recursion` of the
// TPU kernels (vbhem_tpu/ops/pair_estep_pallas.py); the plain PyTorch
// version is `pair_bwd_fwd` in vbhem_tpu_torch/ops/pair_estep.py.
//
// The two kernels differ only in where ell comes from: B1 computes it in
// registers from the base moments and the reduced NIW posterior, B3 loads
// it from memory.  Both run one thread per pair and call this function
// with the pair's base parameters and ell in registers and the reduced
// model j staged once per block in shared memory (`Reduced`).
//
// What bounds it on this card: not bytes, and not the special functions
// alone.  A step takes Sb*Sr exps and Sr*Sb logs but, at Sb = Sr = 3, about
// 380 instructions (SASS of the float32 body), most of them FMAs, and each
// thread's steps form one serial chain; so instruction issue and the
// chains' latency, which the pairs in flight per SM hide, set the time
// (PERF.md: 20-27% of the special-function bound).  The design:
//   * the scaled step.  With A[rp][rc] = exp(log_a[rp][rc] - amax[rp])
//     staged once per block and w[c][rc] = exp(z[c][rc] - m_c) for
//     z = ell + carry, m_c = max_rc z, a backward step forms
//       lse[rp][c] = m_c + amax[rp] + log S[rp][c],
//       S[rp][c]   = sum_rc A[rp][rc] w[c][rc],
//     so it takes Sb*Sr exps and Sr*Sb logs; the rest is FMAs.  In float32
//     the exps, logs and reciprocals are the hardware's approximations
//     (ex2, lg2, rcp); in float64 the correctly rounded functions;
//   * the carry is rebased at every step: the part of LL_new[b][rp] that
//     is constant in rp, sum_c trans[b][c] (m_c + shift[c]), is kept apart
//     in registers, so the carry stays near the spread of one step and the
//     exps read numbers near the spread of ell, not near the carry's
//     magnitude, which grows with tau;
//   * the per-step state the forward pass needs, w [Sb, Sr], is kept, not
//     the carry: the forward pass forms
//       Theta[rp][c][rc] = A[rp][rc] w[c][rc] / S[rp][c]
//     with S recomputed by FMAs and one reciprocal each, and no exp;
//   * an underflow guard.  Where S[rp][c] falls below under_floor (every rc
//     with a non-negligible w has A ~ 0: a -1e30 masked state or a -inf
//     log_a entry at the argmax of z, with a spread of z of tens of nats
//     or more), S has lost the sum the log domain keeps, so that column c
//     is computed in the log domain instead (a branch, rarely taken), and
//     its state is stored as log w - 1 (< 0, where w >= 0), so the forward
//     pass knows to rebuild that column's Theta with exps.  No log(0)
//     reaches the sum_c trans * lse, where a zero row of a ragged base
//     HMM's trans would turn it into NaN.  What a guarded step adds to
//     sum_xi gathers in registers in the exact bodies (kGuardRegs) and
//     elsewhere goes straight to the pair's own sum_xi output (zeroed
//     when a guarded step first adds to it), so it takes no registers;
//   * where the state lives is the design, chosen by the wrapper
//     (ops/pair_estep_cuda.py: design) from the shape:
//       kResident     all tau-1 steps in dynamic shared memory, where a
//                     block holds them at enough pairs per SM;
//       kCheckpointed in shared memory, segments of `seg` steps (about
//                     sqrt(tau)): the backward pass keeps the carry at
//                     each segment's start and leaves the last segment's
//                     w in place; the forward pass recomputes each earlier
//                     segment's w from its carry before it runs that
//                     segment, so it takes one more backward pass of exps
//                     and (seg + tau/seg) steps' room instead of tau's
//                     (the padded grid at tau = 50: 13 slots, not 49).
//                     float32 only: in float64 the correctly rounded exps
//                     and logs of a recomputed segment beside the forward
//                     pass's sums spill at (2, 5) (ptxas: 308 B), and the
//                     float64 launches (the rescoring, DIC) are small
//                     enough that the scratch's traffic costs little;
//       kScratch      all steps in a device-memory scratch
//                     [tau-1, Sb*Sr, L*Kr, Kb], where no block holds even
//                     the segments (and the wide body's only design).
//     Shared memory is laid out value-major, [slot][Sb*Sr][thread], so a
//     warp's stores and loads fall on consecutive words;
//   * every loop runs over a compile-time extent where the body has one,
//     so it unrolls and the arrays stay in registers (VB_FOR).  The exact
//     bodies (the main paths' (Sb, Sr) = (3, 3), (3, 2), (2, 2)) know
//     their counts.  The padded grid's body (Sb, Sr) = (2, 5) runs each
//     block at the states its reduced model uses (kTrim, live_states):
//     the grid pads every cell to Smax = 5 and masks the states past its
//     S with -1e30, so no pair ever enters them, the plain version gives
//     exact zeros there, and the body skips them and writes those zeros.
//     In float32 it holds one instantiation per live count, 1 to 5
//     (pair_recursion_live), so a cell of S states runs S-state loops
//     with no guard (42% less time than guarded loops over 5 at the
//     grid's launch: PERF.md section 6); in float64 (the rescoring and
//     the hyp gradient's check, where the time matters little) one,
//     guarded.  A body per padded shape was chosen over one generic body
//     sized by caps of 2/4/8: a cap of 8 (the next above 5) holds 8x8
//     sums, which do not fit the registers.  Every other shape in
//     Sb, Sr <= 8 runs the generic body with runtime counts, its arrays
//     in local memory;
//   * registers: the exact float32 bodies are held to 5 blocks of 128
//     threads per SM (102 registers: `__launch_bounds__`; measured 5%
//     faster than 4 blocks on an H100, 6 spill: PERF.md section 6); the
//     (2, 5) float32 body, whose sums [Sr][Sr] and [Sr][Sb], state and
//     emission matrix take about 110 values, to 2 (255 registers; it
//     uses about 200); float64 bodies take what they need (255), the
//     (2, 5) one with kLean and kSumsOut.  ptxas's report of each
//     (ops/_build.py: ptxas_report) shows no stack frame and no spills for
//     the (2, 5) bodies in every design they are built in.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace vbhem_pair {

constexpr int kMaxS = 8;
constexpr int kMaxThreads = 128;
constexpr int kMaxSmem = 232448;   // shared memory one block may use

// The least blocks of kMaxThreads an SM must hold, which caps the
// registers ptxas may give a thread (`__launch_bounds__`): in float32 5,
// and 2 for the padded grid's body (kTrim, 255 registers: at 3 its
// instantiations per live count spilled); float64 bodies take what they
// need.
template <typename T, bool kTrim>
constexpr int kMinBlocks = sizeof(T) == 4 ? (kTrim ? 2 : 5) : 1;

// where the per-step state lives (ops/pair_estep_cuda.py: DESIGNS)
constexpr int kResident = 0;
constexpr int kScratch = 1;
constexpr int kCheckpointed = 2;

extern __shared__ __align__(16) unsigned char pair_smem[];

// A loop of v over [0, n), n <= M: where the body has a compile-time extent
// M it unrolls over M with a guard (which folds away where n is M, known at
// compile time), so arrays indexed by v stay in registers; M = 0 (the
// generic body) leaves a loop over the runtime n.  Nest it with braces.
#define VB_FOR(v, M, n)                                        \
  _Pragma("unroll") for (int v = 0; v < ((M) > 0 ? (M) : (n)); ++v) \
    if ((M) == 0 || v < (n))

// Accurate special functions, for what runs once per block.
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }

// The recursion's special functions: in float32 the hardware's
// approximations, a multiply and one SFU instruction each, flushing
// subnormal results to zero (the intrinsics __expf, __logf and __fdividef
// spend three or four more instructions each keeping them); in float64
// the correctly rounded ones.
__device__ __forceinline__ float rexp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}
__device__ __forceinline__ double rexp(double x) { return exp(x); }
__device__ __forceinline__ float rlog(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y * 0.6931471805599453f;
}
__device__ __forceinline__ double rlog(double x) { return log(x); }
__device__ __forceinline__ float rrcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ double rrcp(double x) { return 1.0 / x; }

__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }
// the finite-max guard of the JAX package's logsumexp: a non-finite max
// shifts by 0, so an all -inf row gives -inf rather than NaN, and a -inf
// entry of log_pi or log_a (the log of a zero probability) drops out
__device__ __forceinline__ float finite_or_zero(float x) {
  return fabsf(x) < CUDART_INF_F ? x : 0.0f;
}
__device__ __forceinline__ double finite_or_zero(double x) {
  return fabs(x) < CUDART_INF ? x : 0.0;
}
template <typename T>
__device__ __forceinline__ T neg_inf();
template <>
__device__ __forceinline__ float neg_inf<float>() { return -CUDART_INF_F; }
template <>
__device__ __forceinline__ double neg_inf<double>() { return -CUDART_INF; }

// The underflow guard's floor on S = sum_rc A w (A <= 1, w <= 1, the
// largest w is 1).  Above it the terms an exp flushed to zero (each below
// the type's smallest normal) change S by less than 2^-59 of itself.
template <typename T>
__device__ __forceinline__ T under_floor();
template <>
__device__ __forceinline__ float under_floor<float>() { return 0x1p-64f; }
template <>
__device__ __forceinline__ double under_floor<double>() { return 0x1p-512; }

// Array extent for a state count: the compile-time count of a specialized
// instantiation, else the largest count the kernels take.
template <int S_>
struct Cap {
  static constexpr int value = S_ > 0 ? S_ : kMaxS;
};

// Reduced model j as a block stages it in shared memory.
template <typename T, int SR_>
struct Reduced {
  static constexpr int M = Cap<SR_>::value;
  T log_pi[M];
  T log_a[M * M];
  T a[M * M];   // exp(log_a[rp][rc] - amax[rp]), each row's largest 1
  T amax[M];    // finite-or-zero max of row rp of log_a
};

// Stage reduced model j (log_pi [L*Kr, Sr], log_a [L*Kr, Sr, Sr]); the
// caller synchronizes the block afterwards.
template <typename T, int SR_>
__device__ __forceinline__ void stage_reduced(Reduced<T, SR_>& red,
                                              const T* __restrict__ log_pi,
                                              const T* __restrict__ log_a,
                                              int j, int sr) {
  for (int q = threadIdx.x; q < sr; q += blockDim.x) {
    red.log_pi[q] = log_pi[static_cast<size_t>(j) * sr + q];
    const T* row = log_a + (static_cast<size_t>(j) * sr + q) * sr;
    T mx = neg_inf<T>();
    for (int rc = 0; rc < sr; ++rc) mx = dmax(mx, row[rc]);
    mx = finite_or_zero(mx);
    red.amax[q] = mx;
    for (int rc = 0; rc < sr; ++rc) {
      red.log_a[q * sr + rc] = row[rc];
      red.a[q * sr + rc] = dexp(row[rc] - mx);
    }
  }
}

// The states of staged reduced model j that a pair can enter: all sr but
// the trailing ones whose log_pi and every log_a into them are at most
// -1e29 (the padded grid masks a cell's unused states with -1e30), so
// that every exp over them is exactly 0.  All sr where every state is so
// masked.  Uniform across the block.
template <typename T, int SR_>
__device__ __forceinline__ int live_states(const Reduced<T, SR_>& red,
                                           int sr) {
  const T masked = static_cast<T>(-1e29);
  int n = sr;
  while (n > 0) {
    bool out = red.log_pi[n - 1] <= masked;
    for (int rp = 0; rp < sr; ++rp)
      out = out && red.log_a[rp * sr + n - 1] <= masked;
    if (!out) break;
    --n;
  }
  return n > 0 ? n : sr;
}

// This thread's state: slot 0 of the design's storage and the distance
// between two consecutive values (a block's threads in shared memory, the
// L*Kr*Kb pairs in the scratch).
template <typename T, int kDesign>
__device__ __forceinline__ T* state_base(T* scratch, size_t pix,
                                         size_t plane, size_t& stride) {
  if constexpr (kDesign == kScratch) {
    stride = plane;
    return scratch + pix;
  } else {
    stride = blockDim.x;
    return reinterpret_cast<T*>(pair_smem) + threadIdx.x;
  }
}

// The slots a pair's state takes in the checkpointed design: a segment of
// seg steps' w, the carry at the start of segments 1 .. nseg-2 (the first
// starts from 0, the last stays in place after the backward pass), and,
// where a segment is recomputed, the emission matrix ell it reads (last).
__host__ __device__ __forceinline__ int checkpointed_slots(int tau,
                                                           int seg) {
  const int ns = tau - 1;
  if (ns <= 0 || seg < 1) return 0;
  const int len = seg < ns ? seg : ns;
  const int nseg = (ns + len - 1) / len;
  return len + (nseg > 2 ? nseg - 2 : 0) + (nseg > 1 ? 1 : 0);
}

// One backward step: from the rebased carry llo [Sb, Sr] and its shifts
// sh [Sb] to the next, storing w (or, in a guarded column, log w - 1) at
// `slot`.  sb, sr: the states it runs (NR_ the compile-time extent of the
// loops over sr, SR_ the arrays'); ld: Sr of the staged reduced model and
// of the state's layout.
template <typename T, int SB_, int SR_, int NR_>
__device__ __forceinline__ void backward_step(
    const T (&ell)[Cap<SB_>::value][Cap<SR_>::value],
    const T (&tr)[Cap<SB_>::value][Cap<SB_>::value],
    T (&llo)[Cap<SB_>::value][Cap<SR_>::value], T (&sh)[Cap<SB_>::value],
    const Reduced<T, SR_>& red, T* __restrict__ slot, size_t stride, int sb,
    int sr, int ld) {
  constexpr int MSB = Cap<SB_>::value;
  constexpr int MSR = Cap<SR_>::value;
  // The generic instantiation keeps z = ell + llo for the guard instead of
  // forming it again there.  Forming it again, nvcc 12.9 (build 36037853)
  // at -O3 gave the guard's x[] the local-memory slot of B1's ell[][],
  // still live (both at offset 0 of the float32 generic body's frame), so
  // the guard's stores overwrote ell's first row (PERF.md section 6;
  // tools/guard_repro.py builds both and writes their PTX).
  constexpr bool kKeepZ = SB_ == 0 || SR_ == 0;
  T w[MSB][MSR];
  T zs[kKeepZ ? MSB : 1][kKeepZ ? MSR : 1];
  T mc[MSB];
  auto z_of = [&](int c, int rc) -> T {
    if constexpr (kKeepZ) {
      return zs[c][rc];
    } else {
      return ell[c][rc] + llo[c][rc];
    }
  };
  VB_FOR(c, SB_, sb) {
    T mx = neg_inf<T>();
    VB_FOR(rc, NR_, sr) {
      w[c][rc] = ell[c][rc] + llo[c][rc];
      if constexpr (kKeepZ) zs[c][rc] = w[c][rc];
      mx = dmax(mx, w[c][rc]);
    }
    mx = finite_or_zero(mx);
    mc[c] = mx;
    VB_FOR(rc, NR_, sr) {
      w[c][rc] = rexp(w[c][rc] - mx);
      slot[(c * ld + rc) * stride] = w[c][rc];
    }
  }
  // lse[rp][c] = m_c + amax[rp] + log sum_rc A[rp][rc] w[c][rc]
  T lse[MSR][MSB];
  T smin = static_cast<T>(1);   // any start above the floor
  VB_FOR(rp, NR_, sr) {
    VB_FOR(c, SB_, sb) {
      T s = 0;
      VB_FOR(rc, NR_, sr) { s += red.a[rp * ld + rc] * w[c][rc]; }
      smin = s < smin ? s : smin;
      lse[rp][c] = s;
    }
  }
  // lse less its part m_c, which is constant in rp
  VB_FOR(rp, NR_, sr) {
    VB_FOR(c, SB_, sb) { lse[rp][c] = red.amax[rp] + rlog(lse[rp][c]); }
  }
  if (smin < under_floor<T>()) {   // the guard, rarely taken
    VB_FOR(c, SB_, sb) {
      bool low = false;
      VB_FOR(rp, NR_, sr) {
        T s = 0;
        VB_FOR(rc, NR_, sr) { s += red.a[rp * ld + rc] * w[c][rc]; }
        low = low || s < under_floor<T>();
      }
      if (!low) continue;
      // column c in the log domain
      VB_FOR(rp, NR_, sr) {
        T x[MSR];
        T mx = neg_inf<T>();
        VB_FOR(rc, NR_, sr) {
          x[rc] = red.log_a[rp * ld + rc] + z_of(c, rc);
          mx = dmax(mx, x[rc]);
        }
        mx = finite_or_zero(mx);
        T s = 0;
        VB_FOR(rc, NR_, sr) { s += rexp(x[rc] - mx); }
        lse[rp][c] = (rlog(s) + mx) - mc[c];
      }
      VB_FOR(rc, NR_, sr) {
        slot[(c * ld + rc) * stride] =
            (z_of(c, rc) - mc[c]) - static_cast<T>(1);
      }
    }
  }
  // LL_new[b][rp] = sum_c trans[b][c] (lse[rp][c] + m_c + sh[c]): the
  // carry keeps sum_c trans[b][c] lse[rp][c], the shift the rest
  T base[MSB];
  VB_FOR(c, SB_, sb) { base[c] = mc[c] + sh[c]; }
  VB_FOR(b, SB_, sb) {
    VB_FOR(rp, NR_, sr) {
      T acc = 0;
      VB_FOR(c, SB_, sb) { acc += tr[b][c] * lse[rp][c]; }
      llo[b][rp] = acc;
    }
    T shift = 0;
    VB_FOR(c, SB_, sb) { shift += tr[b][c] * base[c]; }
    sh[b] = shift;
  }
}

// One stored step as the forward pass reads it: w [Sb, Sr] and, for every
// (rp, c), 1 / S[rp][c]; `logged` where a guarded column holds log w - 1
// instead (its S and reciprocals then mean nothing).
template <typename T, int SB_, int SR_>
struct Step {
  T w[Cap<SB_>::value][Cap<SR_>::value];
  T inv[Cap<SR_>::value][Cap<SB_>::value];
  bool logged;
};

template <typename T, int SB_, int SR_, int NR_>
__device__ __forceinline__ void load_step(Step<T, SB_, SR_>& st,
                                          const Reduced<T, SR_>& red,
                                          const T* __restrict__ slot,
                                          size_t stride, int sb, int sr,
                                          int ld) {
  T wmin = static_cast<T>(0);
  VB_FOR(c, SB_, sb) {
    VB_FOR(rc, NR_, sr) { st.w[c][rc] = slot[(c * ld + rc) * stride]; }
    wmin = st.w[c][0] < wmin ? st.w[c][0] : wmin;
  }
  st.logged = wmin < static_cast<T>(0);
  VB_FOR(rp, NR_, sr) {
    VB_FOR(c, SB_, sb) {
      T s = 0;
      VB_FOR(rc, NR_, sr) { s += red.a[rp * ld + rc] * st.w[c][rc]; }
      st.inv[rp][c] = rrcp(s);
    }
  }
}

// Bodies whose sum_xi gathers in the pair's own output at every step (in
// device memory) instead of in hsum, in registers: the float64 bodies of
// 10 or more state values a step, whose correctly rounded exps and logs
// leave no room for hsum's Sr*Sr values.
template <typename T, int SB_, int SR_>
constexpr bool kSumsOut = sizeof(T) == 8 && SB_ * SR_ >= 10;

// Bodies whose guarded steps gather what they add to sum_xi in
// registers: the exact bodies (Sb * Sr <= 9), which have room for it.
template <typename T, int SB_, int SR_>
constexpr bool kGuardRegs = SB_ > 0 && SR_ > 0 && SB_ * SR_ < 10;

// What guarded steps add to sum_xi: with kGuardRegs in v [Sr][Sr], else
// in the pair's own sum_xi output, value [rp][rc] at p[(rp * ld + rc) * s],
// zeroed when a guarded step first adds to it (`used`).
template <typename T, int SB_, int SR_>
struct GuardSum {
  static constexpr int M = kGuardRegs<T, SB_, SR_> ? SR_ : 1;
  T* p;
  size_t s;
  bool used;
  T v[M][M];
};

// One forward step on a stored step: xi[rp][c][rc] = foo[rp][c]
// Theta[rp][c][rc] with foo = nu trans, summed into the next nu and into
// sum_xi: in the common case as hsum[rp][rc] (its A applied once, after
// the last step), in a guarded step column by column into `gs`.
template <typename T, int SB_, int SR_, int NR_>
__device__ __forceinline__ void forward_step(
    const T (&tr)[Cap<SB_>::value][Cap<SB_>::value],
    T (&nu)[Cap<SR_>::value][Cap<SB_>::value],
    T (&stn)[Cap<SR_>::value][Cap<SB_>::value],
    T (&hsum)[Cap<SR_>::value][Cap<SR_>::value], GuardSum<T, SB_, SR_>& gs,
    const Reduced<T, SR_>& red, const Step<T, SB_, SR_>& st, int sb, int sr,
    int ld) {
  constexpr int MSB = Cap<SB_>::value;
  constexpr int MSR = Cap<SR_>::value;
  T foo[MSR][MSB];
  VB_FOR(rp, NR_, sr) {
    VB_FOR(c, SB_, sb) {
      T f = 0;
      VB_FOR(b, SB_, sb) { f += nu[rp][b] * tr[b][c]; }
      foo[rp][c] = f;
    }
  }
  // Theta = A w / S: with g = foo / S, the next nu is
  // nn[rc][c] = w[c][rc] sum_rp g[rp][c] A[rp][rc], and sum_xi gains
  // A[rp][rc] h[rp][rc] with h[rp][rc] = sum_c g[rp][c] w[c][rc].  Formed
  // whether or not the step is guarded, without a branch, so these FMAs
  // interleave with the next step's loads; a guarded step keeps hsum and
  // forms nn again below.  Bodies with kSumsOut, short of registers, form
  // them only in unguarded steps, g in place of foo.
  T nn[MSR][MSB];
  if constexpr (kSumsOut<T, SB_, SR_>) {
    if (!st.logged) {
      VB_FOR(rp, NR_, sr) {
        VB_FOR(c, SB_, sb) { foo[rp][c] *= st.inv[rp][c]; }
      }
      VB_FOR(c, SB_, sb) {
        VB_FOR(rc, NR_, sr) {
          T t = 0;
          VB_FOR(rp, NR_, sr) { t += foo[rp][c] * red.a[rp * ld + rc]; }
          nn[rc][c] = st.w[c][rc] * t;
        }
      }
      VB_FOR(rp, NR_, sr) {
        VB_FOR(rc, NR_, sr) {
          T acc = 0;
          VB_FOR(c, SB_, sb) { acc += foo[rp][c] * st.w[c][rc]; }
          gs.p[(rp * ld + rc) * gs.s] += red.a[rp * ld + rc] * acc;
        }
      }
    }
  } else {
    T g[MSR][MSB];
    VB_FOR(rp, NR_, sr) {
      VB_FOR(c, SB_, sb) { g[rp][c] = foo[rp][c] * st.inv[rp][c]; }
    }
    VB_FOR(c, SB_, sb) {
      VB_FOR(rc, NR_, sr) {
        T t = 0;
        VB_FOR(rp, NR_, sr) { t += g[rp][c] * red.a[rp * ld + rc]; }
        nn[rc][c] = st.w[c][rc] * t;
      }
    }
    VB_FOR(rp, NR_, sr) {
      VB_FOR(rc, NR_, sr) {
        T acc = hsum[rp][rc];
        VB_FOR(c, SB_, sb) { acc += g[rp][c] * st.w[c][rc]; }
        hsum[rp][rc] = st.logged ? hsum[rp][rc] : acc;
      }
    }
  }
  if (st.logged) {   // a guarded column: this step column by column
    if (!kGuardRegs<T, SB_, SR_> && !gs.used) {
      VB_FOR(rp, NR_, sr) {
        VB_FOR(rc, NR_, sr) { gs.p[(rp * ld + rc) * gs.s] = 0; }
      }
      gs.used = true;
    }
    VB_FOR(c, SB_, sb) {
      VB_FOR(rc, NR_, sr) { nn[rc][c] = 0; }
      VB_FOR(rp, NR_, sr) {
        T x[MSR];
        T s = 0;
        if (st.w[c][0] < static_cast<T>(0)) {   // w holds log w - 1
          T mx = neg_inf<T>();
          VB_FOR(rc, NR_, sr) {
            x[rc] = red.log_a[rp * ld + rc] + st.w[c][rc];
            mx = dmax(mx, x[rc]);
          }
          mx = finite_or_zero(mx);
          VB_FOR(rc, NR_, sr) {
            x[rc] = rexp(x[rc] - mx);
            s += x[rc];
          }
        } else {
          VB_FOR(rc, NR_, sr) {
            x[rc] = red.a[rp * ld + rc] * st.w[c][rc];
            s += x[rc];
          }
        }
        const T f = foo[rp][c] / s;
        VB_FOR(rc, NR_, sr) {
          const T xi = f * x[rc];
          if constexpr (kGuardRegs<T, SB_, SR_>) {
            gs.v[rp][rc] += xi;
          } else {
            gs.p[(rp * ld + rc) * gs.s] += xi;
          }
          nn[rc][c] += xi;
        }
      }
    }
  }
  VB_FOR(r, NR_, sr) {
    VB_FOR(b, SB_, sb) {
      nu[r][b] = nn[r][b];
      stn[r][b] += nn[r][b];
    }
  }
}

// Backward pass, termination and forward pass of pair (j, i).  SB_ / SR_
// are the compile-time extents of a specialized instantiation (its loops
// unroll), or 0 for the generic one; NR_ the extent of its loops over the
// states it runs (SR_, or a live count below it: pair_recursion_live).
//   pr [Sb], tr [Sb][Sb], ell [Sb][Sr]: this pair's base HMM and emission
//     matrix, in registers;
//   red: reduced model j, in shared memory;
//   st, stride: this pair's state (state_base); kCheckpointed keeps
//     segments of `seg` steps and their carries, the other designs all
//     tau-1 steps;
//   sb, sr: the states the recursion runs (sr below ld where the trailing
//     reduced states are masked, live_states); ld: Sr of the staged model,
//     the state and the outputs, which hold exact zeros at states sr..ld-1;
//   outputs ll [lkr, kb], nu1 [lkr, Sr, kb], sxi [lkr, Sr, Sr, kb],
//     stn [lkr, Sr, Sb, kb].
template <typename T, int SB_, int SR_, int kDesign, int NR_ = SR_>
__device__ __forceinline__ void pair_recursion(
    const T (&pr)[Cap<SB_>::value],
    const T (&tr)[Cap<SB_>::value][Cap<SB_>::value],
    const T (&ell)[Cap<SB_>::value][Cap<SR_>::value],
    const Reduced<T, SR_>& red, T* __restrict__ st, size_t stride,
    T* __restrict__ ll_out, T* __restrict__ nu1_out, T* __restrict__ sxi_out,
    T* __restrict__ stn_out, int j, int i, int kb, int sb, int sr, int ld,
    int tau, int seg) {
  constexpr int MSB = Cap<SB_>::value;
  constexpr int MSR = Cap<SR_>::value;
  constexpr bool kCk = kDesign == kCheckpointed;
  // float64 bodies of 10 or more state values a step (the padded grid's
  // (2, 5)) hold about 60 values across steps in two registers each (nu,
  // sum_t_nu, the transitions and, but for kSumsOut, hsum) beside the
  // correctly rounded exps and logs, so they load each stored step as it
  // runs, not a step ahead, and read the staged reduced model (and,
  // recomputing a segment, ell) back from shared memory at every step, a
  // compiler barrier apart, instead of holding them in registers: some 30
  // loads a step.
  constexpr bool kLean = sizeof(T) == 8 && SB_ * SR_ >= 10;
  const size_t skb = static_cast<size_t>(kb);
  const size_t pix = static_cast<size_t>(j) * skb + i;  // in [LKr, Kb]
  const size_t slot_len = static_cast<size_t>(sb * ld) * stride;
  const int ns = tau - 1;
  // steps per segment and segments: the designs that keep every step
  // have one segment of ns steps, known here, so their loops below index
  // the steps as the recursion had before segments
  const int len = kCk ? seg : ns;
  const int nseg = ns <= 0 ? 0 : kCk ? (ns + len - 1) / len : 1;

  // ---- backward: carry LL_old [Sb, Sr] ----
  // LL_old[b][r] = llo[b][r] + sh[b]: llo sums logs of sums S near 1 and
  // the rows' log_a maxima, so it stays near the spread of one step
  // however long tau is; the shift sh[b] takes the part constant in r.
  // Every use of the carry but the termination's ll_elbo is a softmax
  // over r, where sh[b] cancels.  kCheckpointed: the segment's w at slots
  // 0 .. seg-1, the carry at the start of segment s (1 <= s <= nseg-2) at
  // slot seg + s - 1.
  T llo[MSB][MSR];
  T sh[MSB];
  VB_FOR(b, SB_, sb) {
    sh[b] = 0;
    VB_FOR(r, NR_, sr) { llo[b][r] = 0; }
  }
  {
    int off = 0, s = 0;
    for (int k = 0; k < ns; ++k) {
      if constexpr (kLean) asm volatile("" ::: "memory");
      if constexpr (kCk) {
        if (k == 0 && nseg > 1) {   // ell, for the recomputed segments
          T* es = st + (checkpointed_slots(tau, seg) - 1) * slot_len;
          VB_FOR(b, SB_, sb) {
            VB_FOR(r, NR_, sr) { es[(b * ld + r) * stride] = ell[b][r]; }
          }
        }
        if (off == 0 && s > 0 && s < nseg - 1) {
          T* ck = st + (seg + s - 1) * slot_len;
          VB_FOR(b, SB_, sb) {
            VB_FOR(r, NR_, sr) { ck[(b * ld + r) * stride] = llo[b][r]; }
          }
        }
      }
      backward_step<T, SB_, SR_, NR_>(ell, tr, llo, sh, red,
                                      st + (kCk ? off : k) * slot_len,
                                      stride, sb, sr, ld);
      if constexpr (kCk) {
        if (++off == len) {
          off = 0;
          ++s;
        }
      }
    }
  }

  // ---- terminate (t = 1) and start the forward pass ----
  T nu[MSR][MSB];
  VB_FOR(r, SR_, ld) {
    VB_FOR(b, SB_, sb) { nu[r][b] = 0; }
  }
  T ll = 0;
  VB_FOR(b, SB_, sb) {
    T x[MSR];
    T mx = neg_inf<T>();
    VB_FOR(r, NR_, sr) {
      x[r] = (red.log_pi[r] + ell[b][r]) + llo[b][r];
      mx = dmax(mx, x[r]);
    }
    mx = finite_or_zero(mx);
    T s = 0;
    VB_FOR(r, NR_, sr) {
      x[r] = rexp(x[r] - mx);
      s += x[r];
    }
    ll += pr[b] * ((rlog(s) + mx) + sh[b]);
    const T f = pr[b] * rrcp(s);
    VB_FOR(r, NR_, sr) { nu[r][b] = f * x[r]; }
  }
  ll_out[pix] = ll;

  // sums over every state of the layout: those past sr stay exact zeros
  T stn[MSR][MSB];
  T hsum[MSR][MSR];
  VB_FOR(r, SR_, ld) {
    T n1 = 0;
    VB_FOR(b, SB_, sb) {
      stn[r][b] = nu[r][b];
      n1 += nu[r][b];
    }
    VB_FOR(rc, SR_, ld) { hsum[r][rc] = 0; }
    nu1_out[static_cast<size_t>(j * ld + r) * skb + i] = n1;
  }
  GuardSum<T, SB_, SR_> gs{
      sxi_out + static_cast<size_t>(j) * ld * ld * skb + i, skb,
      kSumsOut<T, SB_, SR_>, {}};
  if constexpr (kSumsOut<T, SB_, SR_>) {
    VB_FOR(r, NR_, sr) {
      VB_FOR(rc, NR_, sr) { gs.p[(r * ld + rc) * gs.s] = 0; }
    }
  }

  // ---- forward: t = 2 .. tau, the backward steps in reverse ----
  for (int s = nseg - 1; s >= 0; --s) {
    const int n = kCk ? min(len, ns - s * len) : ns;
    if constexpr (kCk) {
      if (s < nseg - 1) {   // segment s's w again, from its carry
        T rl[MSB][MSR];
        T rsh[MSB];       // unused: the shifts matter only to ll_elbo
        VB_FOR(b, SB_, sb) {
          rsh[b] = 0;
          VB_FOR(r, NR_, sr) {
            rl[b][r] = s > 0 ? st[(seg + s - 1) * slot_len +
                                  (b * ld + r) * stride]
                             : static_cast<T>(0);
          }
        }
        // ell, read back: not held through the forward pass
        const T* es = st + (checkpointed_slots(tau, seg) - 1) * slot_len;
        for (int o = 0; o < n; ++o) {
          if constexpr (kLean) asm volatile("" ::: "memory");
          T re[MSB][MSR];
          VB_FOR(b, SB_, sb) {
            VB_FOR(r, NR_, sr) { re[b][r] = es[(b * ld + r) * stride]; }
          }
          backward_step<T, SB_, SR_, NR_>(re, tr, rl, rsh, red,
                                          st + o * slot_len, stride, sb, sr,
                                          ld);
        }
      }
    }
    if constexpr (kCk || kLean) {
      // each step loaded as it runs: no step ahead in registers, which
      // the recomputing segments and the float64 (2, 5) body lack
      for (int o = n - 1; o >= 0; --o) {
        if constexpr (kLean) asm volatile("" ::: "memory");
        Step<T, SB_, SR_> cur;
        load_step<T, SB_, SR_, NR_>(cur, red, st + o * slot_len, stride, sb,
                                    sr, ld);
        forward_step<T, SB_, SR_, NR_>(tr, nu, stn, hsum, gs, red, cur, sb,
                                       sr, ld);
      }
    } else {
      // each step's state is loaded, and its reciprocals formed, a step
      // ahead, beside the current step's chain
      Step<T, SB_, SR_> cur;
      load_step<T, SB_, SR_, NR_>(cur, red, st + (n - 1) * slot_len, stride,
                                  sb, sr, ld);
      for (int o = n - 1; o >= 0; --o) {
        Step<T, SB_, SR_> nxt;
        load_step<T, SB_, SR_, NR_>(
            nxt, red, st + (o > 0 ? o - 1 : 0) * slot_len, stride, sb, sr, ld);
        forward_step<T, SB_, SR_, NR_>(tr, nu, stn, hsum, gs, red, cur, sb,
                                       sr, ld);
        cur = nxt;
      }
    }
  }

  VB_FOR(r, SR_, ld) {
    VB_FOR(rc, SR_, ld) {
      T v = red.a[r * ld + rc] * hsum[r][rc];
      if constexpr (kGuardRegs<T, SB_, SR_>) {
        v += gs.v[r][rc];
      } else if (gs.used && r < sr && rc < sr) {
        v += gs.p[(r * ld + rc) * gs.s];
      }
      gs.p[(r * ld + rc) * gs.s] = v;
    }
    VB_FOR(b, SB_, sb) {
      stn_out[static_cast<size_t>((j * ld + r) * sb + b) * skb + i] = stn[r][b];
    }
  }
}

// pair_recursion at the live count sr of a body with compile-time extents
// (kTrim): one instantiation per count from 1 to SR_, each with its loops
// unrolled over exactly its states, so a lane's masked states cost no
// instruction; the block's count picks one (uniform across the block).
template <typename T, int SB_, int SR_, int kDesign, int NR_ = SR_>
__device__ __forceinline__ void pair_recursion_live(
    const T (&pr)[Cap<SB_>::value],
    const T (&tr)[Cap<SB_>::value][Cap<SB_>::value],
    const T (&ell)[Cap<SB_>::value][Cap<SR_>::value],
    const Reduced<T, SR_>& red, T* __restrict__ st, size_t stride,
    T* __restrict__ ll_out, T* __restrict__ nu1_out, T* __restrict__ sxi_out,
    T* __restrict__ stn_out, int j, int i, int kb, int sb, int sr, int ld,
    int tau, int seg) {
  if constexpr (NR_ > 1) {
    if (sr < NR_) {
      pair_recursion_live<T, SB_, SR_, kDesign, NR_ - 1>(
          pr, tr, ell, red, st, stride, ll_out, nu1_out, sxi_out, stn_out, j,
          i, kb, sb, sr, ld, tau, seg);
      return;
    }
  }
  pair_recursion<T, SB_, SR_, kDesign, NR_>(pr, tr, ell, red, st, stride,
                                            ll_out, nu1_out, sxi_out, stn_out,
                                            j, i, kb, sb, NR_, ld, tau, seg);
}

// ---------------------------------------------------------------------------
// The wide body: Sb or Sr above kMaxS
// ---------------------------------------------------------------------------
//
// The bodies above keep a pair's vectors in registers sized by kMaxS.  Past
// it, one generic body per kernel runs the same arithmetic, in the same
// order, on vectors that live in device memory: every step's w in the
// scratch [tau-1, Sb*Sr, L*Kr, Kb] of the scratch design, and the pair's
// working vectors (carry, shifts, lse, nu, sums) in a workspace that the
// wrapper appends to that scratch, [wide_work_values, L*Kr, Kb], value-major
// so a warp's accesses fall on consecutive words.  The reduced model is
// staged in dynamic shared memory, 2 Sr^2 + 2 Sr values (B1 adds its
// emission constants).  So the sizes it takes are those whose reduced model
// fits a block's shared memory and whose scratch fits the card's memory.
// It is written to be right, not fast: every value goes through memory.

// A strided view of a pair's vector: element q at p[q * s].
template <typename T>
struct Strided {
  T* p;
  size_t s;
  __device__ __forceinline__ T& operator[](int q) const {
    return p[static_cast<size_t>(q) * s];
  }
};

// Reduced model j in dynamic shared memory (pair_smem): log_pi [Sr],
// log_a [Sr, Sr], a [Sr, Sr], amax [Sr].
template <typename T>
struct WideReduced {
  T* log_pi;
  T* log_a;
  T* a;
  T* amax;
  __device__ __forceinline__ explicit WideReduced(T* base, int sr)
      : log_pi(base), log_a(base + sr), a(base + sr + sr * sr),
        amax(base + sr + 2 * sr * sr) {}
};

__host__ __device__ __forceinline__ int wide_reduced_values(int sr) {
  return 2 * sr * sr + 2 * sr;
}

// Stage reduced model j as stage_reduced does; the caller synchronizes.
template <typename T>
__device__ __forceinline__ void stage_reduced_wide(
    const WideReduced<T>& red, const T* __restrict__ log_pi,
    const T* __restrict__ log_a, int j, int sr) {
  for (int q = threadIdx.x; q < sr; q += blockDim.x) {
    red.log_pi[q] = log_pi[static_cast<size_t>(j) * sr + q];
    const T* row = log_a + (static_cast<size_t>(j) * sr + q) * sr;
    T mx = neg_inf<T>();
    for (int rc = 0; rc < sr; ++rc) mx = dmax(mx, row[rc]);
    mx = finite_or_zero(mx);
    red.amax[q] = mx;
    for (int rc = 0; rc < sr; ++rc) {
      red.log_a[q * sr + rc] = row[rc];
      red.a[q * sr + rc] = dexp(row[rc] - mx);
    }
  }
}

// A pair's working vectors in the workspace, [values, L*Kr, Kb]: their
// count is wide_work_values (ops/pair_estep_cuda.py: wide_work_values).
template <typename T>
struct WideWork {
  Strided<T> llo, sh, mc, lse, nu, stn, hsum, sxi, foo, nn, inv, x;
  __device__ __forceinline__ WideWork(T* ws, size_t plane, int sb, int sr) {
    size_t off = 0;
    auto take = [&](int n) {
      Strided<T> v{ws + off * plane, plane};
      off += static_cast<size_t>(n);
      return v;
    };
    llo = take(sb * sr);
    sh = take(sb);
    mc = take(sb);
    lse = take(sr * sb);
    nu = take(sr * sb);
    stn = take(sr * sb);
    hsum = take(sr * sr);
    sxi = take(sr * sr);
    foo = take(sr * sb);
    nn = take(sr * sb);
    inv = take(sr * sb);
    x = take(sr);
  }
};

__host__ __device__ __forceinline__ int wide_work_values(int sb, int sr) {
  return 7 * sb * sr + 2 * sr * sr + 2 * sb + sr;
}

// pair_recursion on the wide body: the same steps in the same order, with
// pr [Sb], tr [Sb][Sb] and ell [Sb][Sr] strided views, the reduced model in
// shared memory, the states at st (stride `stride`) and the working
// vectors in `w`.
template <typename T>
__device__ void pair_recursion_wide(
    Strided<const T> pr, Strided<const T> tr, Strided<const T> ell,
    const WideReduced<T>& red, T* __restrict__ st, size_t stride,
    const WideWork<T>& w, T* __restrict__ ll_out, T* __restrict__ nu1_out,
    T* __restrict__ sxi_out, T* __restrict__ stn_out, int j, int i, int kb,
    int sb, int sr, int tau) {
  const size_t skb = static_cast<size_t>(kb);
  const size_t pix = static_cast<size_t>(j) * skb + i;
  const size_t slot_len = static_cast<size_t>(sb * sr) * stride;
  const int ns = tau - 1;
  for (int b = 0; b < sb; ++b) {
    w.sh[b] = 0;
    for (int r = 0; r < sr; ++r) w.llo[b * sr + r] = 0;
  }

  // ---- backward (backward_step) ----
  for (int k = 0; k < ns; ++k) {
    T* slot = st + k * slot_len;
    for (int c = 0; c < sb; ++c) {
      T mx = neg_inf<T>();
      for (int rc = 0; rc < sr; ++rc) {
        const T z = ell[c * sr + rc] + w.llo[c * sr + rc];
        slot[(c * sr + rc) * stride] = z;
        mx = dmax(mx, z);
      }
      mx = finite_or_zero(mx);
      w.mc[c] = mx;
      for (int rc = 0; rc < sr; ++rc)
        slot[(c * sr + rc) * stride] = rexp(slot[(c * sr + rc) * stride] - mx);
    }
    T smin = static_cast<T>(1);
    for (int rp = 0; rp < sr; ++rp)
      for (int c = 0; c < sb; ++c) {
        T s = 0;
        for (int rc = 0; rc < sr; ++rc)
          s += red.a[rp * sr + rc] * slot[(c * sr + rc) * stride];
        smin = s < smin ? s : smin;
        w.lse[rp * sb + c] = s;
      }
    for (int rp = 0; rp < sr; ++rp)
      for (int c = 0; c < sb; ++c)
        w.lse[rp * sb + c] = red.amax[rp] + rlog(w.lse[rp * sb + c]);
    if (smin < under_floor<T>()) {   // the guard
      for (int c = 0; c < sb; ++c) {
        bool low = false;
        for (int rp = 0; rp < sr; ++rp) {
          T s = 0;
          for (int rc = 0; rc < sr; ++rc)
            s += red.a[rp * sr + rc] * slot[(c * sr + rc) * stride];
          low = low || s < under_floor<T>();
        }
        if (!low) continue;
        for (int rp = 0; rp < sr; ++rp) {
          T mx = neg_inf<T>();
          for (int rc = 0; rc < sr; ++rc) {
            w.x[rc] = red.log_a[rp * sr + rc] +
                      (ell[c * sr + rc] + w.llo[c * sr + rc]);
            mx = dmax(mx, w.x[rc]);
          }
          mx = finite_or_zero(mx);
          T s = 0;
          for (int rc = 0; rc < sr; ++rc) s += rexp(w.x[rc] - mx);
          w.lse[rp * sb + c] = (rlog(s) + mx) - w.mc[c];
        }
        for (int rc = 0; rc < sr; ++rc)
          slot[(c * sr + rc) * stride] =
              ((ell[c * sr + rc] + w.llo[c * sr + rc]) - w.mc[c]) -
              static_cast<T>(1);
      }
    }
    for (int c = 0; c < sb; ++c) w.mc[c] = w.mc[c] + w.sh[c];   // base
    for (int b = 0; b < sb; ++b) {
      for (int rp = 0; rp < sr; ++rp) {
        T acc = 0;
        for (int c = 0; c < sb; ++c) acc += tr[b * sb + c] * w.lse[rp * sb + c];
        w.llo[b * sr + rp] = acc;
      }
      T shift = 0;
      for (int c = 0; c < sb; ++c) shift += tr[b * sb + c] * w.mc[c];
      w.sh[b] = shift;
    }
  }

  // ---- terminate ----
  T ll = 0;
  for (int b = 0; b < sb; ++b) {
    T mx = neg_inf<T>();
    for (int r = 0; r < sr; ++r) {
      w.x[r] = (red.log_pi[r] + ell[b * sr + r]) + w.llo[b * sr + r];
      mx = dmax(mx, w.x[r]);
    }
    mx = finite_or_zero(mx);
    T s = 0;
    for (int r = 0; r < sr; ++r) {
      w.x[r] = rexp(w.x[r] - mx);
      s += w.x[r];
    }
    ll += pr[b] * ((rlog(s) + mx) + w.sh[b]);
    const T f = pr[b] * rrcp(s);
    for (int r = 0; r < sr; ++r) w.nu[r * sb + b] = f * w.x[r];
  }
  ll_out[pix] = ll;
  for (int r = 0; r < sr; ++r) {
    T n1 = 0;
    for (int b = 0; b < sb; ++b) {
      w.stn[r * sb + b] = w.nu[r * sb + b];
      n1 += w.nu[r * sb + b];
    }
    nu1_out[static_cast<size_t>(j * sr + r) * skb + i] = n1;
    for (int rc = 0; rc < sr; ++rc) {
      w.hsum[r * sr + rc] = 0;
      w.sxi[r * sr + rc] = 0;
    }
  }

  // ---- forward (load_step, forward_step) ----
  for (int o = ns - 1; o >= 0; --o) {
    const T* slot = st + o * slot_len;
    bool logged = false;
    for (int c = 0; c < sb; ++c)
      logged = logged || slot[(c * sr) * stride] < static_cast<T>(0);
    for (int rp = 0; rp < sr; ++rp)
      for (int c = 0; c < sb; ++c) {
        T s = 0;
        for (int rc = 0; rc < sr; ++rc)
          s += red.a[rp * sr + rc] * slot[(c * sr + rc) * stride];
        w.inv[rp * sb + c] = rrcp(s);
      }
    for (int rp = 0; rp < sr; ++rp)
      for (int c = 0; c < sb; ++c) {
        T f = 0;
        for (int b = 0; b < sb; ++b) f += w.nu[rp * sb + b] * tr[b * sb + c];
        w.foo[rp * sb + c] = f;
      }
    if (!logged) {
      for (int c = 0; c < sb; ++c)
        for (int rc = 0; rc < sr; ++rc) {
          T t = 0;
          for (int rp = 0; rp < sr; ++rp)
            t += (w.foo[rp * sb + c] * w.inv[rp * sb + c]) *
                 red.a[rp * sr + rc];
          w.nn[rc * sb + c] = slot[(c * sr + rc) * stride] * t;
        }
      for (int rp = 0; rp < sr; ++rp)
        for (int rc = 0; rc < sr; ++rc) {
          T acc = w.hsum[rp * sr + rc];
          for (int c = 0; c < sb; ++c)
            acc += (w.foo[rp * sb + c] * w.inv[rp * sb + c]) *
                   slot[(c * sr + rc) * stride];
          w.hsum[rp * sr + rc] = acc;
        }
    } else {   // a guarded column: this step column by column
      for (int c = 0; c < sb; ++c) {
        for (int rc = 0; rc < sr; ++rc) w.nn[rc * sb + c] = 0;
        const bool col_logged = slot[(c * sr) * stride] < static_cast<T>(0);
        for (int rp = 0; rp < sr; ++rp) {
          T s = 0;
          if (col_logged) {   // the state holds log w - 1
            T mx = neg_inf<T>();
            for (int rc = 0; rc < sr; ++rc) {
              w.x[rc] = red.log_a[rp * sr + rc] + slot[(c * sr + rc) * stride];
              mx = dmax(mx, w.x[rc]);
            }
            mx = finite_or_zero(mx);
            for (int rc = 0; rc < sr; ++rc) {
              w.x[rc] = rexp(w.x[rc] - mx);
              s += w.x[rc];
            }
          } else {
            for (int rc = 0; rc < sr; ++rc) {
              w.x[rc] = red.a[rp * sr + rc] * slot[(c * sr + rc) * stride];
              s += w.x[rc];
            }
          }
          const T f = w.foo[rp * sb + c] / s;
          for (int rc = 0; rc < sr; ++rc) {
            const T xi = f * w.x[rc];
            w.sxi[rp * sr + rc] += xi;
            w.nn[rc * sb + c] += xi;
          }
        }
      }
    }
    for (int r = 0; r < sr; ++r)
      for (int b = 0; b < sb; ++b) {
        w.nu[r * sb + b] = w.nn[r * sb + b];
        w.stn[r * sb + b] += w.nn[r * sb + b];
      }
  }

  for (int r = 0; r < sr; ++r) {
    for (int rc = 0; rc < sr; ++rc)
      sxi_out[static_cast<size_t>((j * sr + r) * sr + rc) * skb + i] =
          red.a[r * sr + rc] * w.hsum[r * sr + rc] + w.sxi[r * sr + rc];
    for (int b = 0; b < sb; ++b)
      stn_out[static_cast<size_t>((j * sr + r) * sb + b) * skb + i] =
          w.stn[r * sb + b];
  }
}

// Host side: the wide body's launch checks (the scratch design, a block
// of 32-128 threads, the shared memory it asks for within a block's), and
// the shared memory beyond 48 KB granted.
template <typename Kernel>
inline int prepare_wide_launch(Kernel kernel, int design, int threads,
                               size_t smem, bool has_scratch) {
  if (design != kScratch || !has_scratch || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Host side: lets a kernel of the resident or the checkpointed design take
// `smem` bytes of dynamic shared memory, with the SM's carveout all shared
// memory, so every block the wrapper's design counted on is resident.
// Returns the cudaError_t, or cudaErrorInvalidValue for a launch
// configuration the kernels do not take.
template <typename Kernel>
inline int prepare_launch(Kernel kernel, int design, int threads, int smem,
                          int seg, int sb, int sr, int tau, int itemsize,
                          bool has_scratch) {
  if (threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      smem < 0 || smem > kMaxSmem ||
      (design != kResident && design != kScratch &&
       design != kCheckpointed) ||
      (design == kCheckpointed && seg < 1) ||
      has_scratch != (design == kScratch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (design == kScratch)
    return smem == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  const int slots =
      design == kResident ? tau - 1 : checkpointed_slots(tau, seg);
  const long long need =
      static_cast<long long>(threads) * slots * sb * sr * itemsize;
  if (need > smem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return static_cast<int>(err);
}

}  // namespace vbhem_pair
