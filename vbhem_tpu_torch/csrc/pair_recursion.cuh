// The pair recursion shared by kernels B1 (pair_estep_fused.cu) and B3
// (pair_bwd_fwd.cu): for one (base HMM i, reduced HMM j) pair, given the
// expected emission matrix ell[b][r], the tau-1 backward steps with a
// log-sum-exp over the reduced state, the termination
// ll_elbo = sum_b prior_b lse_b, and the forward pass that accumulates
// nu_1, sum_xi and sum_t_nu.  It replaces `_recursion` of the TPU kernels
// (vbhem_tpu/ops/pair_estep_pallas.py); the plain PyTorch version is
// `pair_bwd_fwd` in vbhem_tpu_torch/ops/pair_estep.py.
//
// The two kernels differ only in where ell comes from: B1 computes it in
// registers from the base moments and the reduced NIW posterior, B3 loads
// it from memory.  Both run one thread per pair and call this function
// with the pair's base parameters and ell in registers and the reduced
// model's log_pi / log_a in shared memory.
//
// The backward carry is kept rebased per base state at every step (its
// shift kept apart in registers), so the softmaxes read numbers near
// their spread, not near the carry's magnitude, which grows with tau.
// The backward pass stores only its carry [Sb, Sr] per step (not Theta
// [Sr, Sb, Sr]) to a global scratch [tau-1, Sb*Sr, L*Kr, Kb]; the forward
// pass rebuilds Theta from it.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace vbhem_pair {

constexpr int kMaxS = 8;
constexpr int kThreads = 128;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }

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

// Array extent for a state count: the compile-time count of a specialized
// instantiation, else the largest count the kernels take.
template <int S_>
struct Cap {
  static constexpr int value = S_ > 0 ? S_ : kMaxS;
};

// Backward pass, termination and forward pass of pair (j, i).  SB_ / SR_
// are the compile-time state counts of a specialized instantiation (its
// loops unroll), or 0 for the generic one, which reads sb_rt / sr_rt.
//   pr [Sb], tr [Sb][Sb], ell [Sb][Sr]: this pair's base HMM and emission
//     matrix, in registers;
//   s_log_pi [Sr], s_log_a [Sr*Sr]: reduced model j, in shared memory;
//   carry: the scratch [tau-1, Sb*Sr, lkr, kb];
//   outputs ll [lkr, kb], nu1 [lkr, Sr, kb], sxi [lkr, Sr, Sr, kb],
//     stn [lkr, Sr, Sb, kb].
template <typename T, int SB_, int SR_>
__device__ __forceinline__ void pair_recursion(
    const T (&pr)[Cap<SB_>::value], const T (&tr)[Cap<SB_>::value][Cap<SB_>::value],
    const T (&ell)[Cap<SB_>::value][Cap<SR_>::value], const T* s_log_pi,
    const T* s_log_a, T* __restrict__ carry, T* __restrict__ ll_out,
    T* __restrict__ nu1_out, T* __restrict__ sxi_out, T* __restrict__ stn_out,
    int j, int i, int kb, int lkr, int sb_rt, int sr_rt, int tau) {
  constexpr int MSB = Cap<SB_>::value;
  constexpr int MSR = Cap<SR_>::value;
  const int sb = SB_ > 0 ? SB_ : sb_rt;
  const int sr = SR_ > 0 ? SR_ : sr_rt;
  const size_t skb = static_cast<size_t>(kb);
  const size_t plane = static_cast<size_t>(lkr) * skb;  // carry entry stride
  const size_t pix = static_cast<size_t>(j) * skb + i;  // this pair in [LKr, Kb]

  // ---- backward: carry LL_old [Sb, Sr] ----
  // LL_old[b][r] = llo[b][r] + sh[b], with max_r llo[b][r] = 0.  Every
  // use of the carry but the termination's ll_elbo is a softmax over r,
  // where sh[b] cancels, so only llo is stored.
  T llo[MSB][MSR];
  T sh[MSB];
#pragma unroll
  for (int b = 0; b < sb; ++b) {
    sh[b] = 0;
#pragma unroll
    for (int r = 0; r < sr; ++r) llo[b][r] = 0;
  }

  for (int k = 0; k < tau - 1; ++k) {
    T* cst = carry + static_cast<size_t>(k) * sb * sr * plane + pix;
#pragma unroll
    for (int b = 0; b < sb; ++b)
#pragma unroll
      for (int r = 0; r < sr; ++r) cst[(b * sr + r) * plane] = llo[b][r];

    // lse[rp][c] = logsumexp_rc(log_a[rp][rc] + (ell[c][rc] + llo[c][rc]))
    T lse[MSR][MSB];
#pragma unroll
    for (int rp = 0; rp < sr; ++rp) {
#pragma unroll
      for (int c = 0; c < sb; ++c) {
        T x[MSR];
        T mx = neg_inf<T>();
#pragma unroll
        for (int rc = 0; rc < sr; ++rc) {
          x[rc] = s_log_a[rp * sr + rc] + (ell[c][rc] + llo[c][rc]);
          mx = dmax(mx, x[rc]);
        }
        mx = finite_or_zero(mx);
        T s = 0;
#pragma unroll
        for (int rc = 0; rc < sr; ++rc) s += dexp(x[rc] - mx);
        lse[rp][c] = dlog(s) + mx;
      }
    }
    // LL_new[b][rp] = sum_c trans[b][c] (lse[rp][c] + sh[c]); rebased
    T sh_new[MSB];
#pragma unroll
    for (int b = 0; b < sb; ++b) {
      T shift = 0;
#pragma unroll
      for (int c = 0; c < sb; ++c) shift += tr[b][c] * sh[c];
      T m = neg_inf<T>();
#pragma unroll
      for (int rp = 0; rp < sr; ++rp) {
        T acc = 0;
#pragma unroll
        for (int c = 0; c < sb; ++c) acc += tr[b][c] * lse[rp][c];
        llo[b][rp] = acc;
        m = dmax(m, acc);
      }
      m = finite_or_zero(m);
#pragma unroll
      for (int rp = 0; rp < sr; ++rp) llo[b][rp] -= m;
      sh_new[b] = shift + m;
    }
#pragma unroll
    for (int b = 0; b < sb; ++b) sh[b] = sh_new[b];
  }

  // ---- terminate (t = 1) and start the forward pass ----
  T nu[MSR][MSB];
  T ll = 0;
#pragma unroll
  for (int b = 0; b < sb; ++b) {
    T x[MSR];
    T mx = neg_inf<T>();
#pragma unroll
    for (int r = 0; r < sr; ++r) {
      x[r] = (s_log_pi[r] + ell[b][r]) + llo[b][r];
      mx = dmax(mx, x[r]);
    }
    mx = finite_or_zero(mx);
    T s = 0;
#pragma unroll
    for (int r = 0; r < sr; ++r) s += dexp(x[r] - mx);
    const T lse1 = dlog(s) + mx;  // of the rebased carry
    ll += pr[b] * (lse1 + sh[b]);
#pragma unroll
    for (int r = 0; r < sr; ++r) nu[r][b] = pr[b] * dexp(x[r] - lse1);
  }
  ll_out[pix] = ll;

  T stn[MSR][MSB];
  T sxi[MSR][MSR];
#pragma unroll
  for (int r = 0; r < sr; ++r) {
    T n1 = 0;
#pragma unroll
    for (int b = 0; b < sb; ++b) {
      stn[r][b] = nu[r][b];
      n1 += nu[r][b];
    }
    nu1_out[static_cast<size_t>(j * sr + r) * skb + i] = n1;
#pragma unroll
    for (int rc = 0; rc < sr; ++rc) sxi[r][rc] = 0;
  }

  // ---- forward: t = 2 .. tau, Theta rebuilt from the stored carries ----
  for (int k = tau - 2; k >= 0; --k) {
    const T* cld = carry + static_cast<size_t>(k) * sb * sr * plane + pix;
    T lk[MSB][MSR];
#pragma unroll
    for (int b = 0; b < sb; ++b)
#pragma unroll
      for (int r = 0; r < sr; ++r) lk[b][r] = cld[(b * sr + r) * plane];

    T nn[MSR][MSB];
#pragma unroll
    for (int rc = 0; rc < sr; ++rc)
#pragma unroll
      for (int c = 0; c < sb; ++c) nn[rc][c] = 0;

#pragma unroll
    for (int rp = 0; rp < sr; ++rp) {
#pragma unroll
      for (int c = 0; c < sb; ++c) {
        // foo[rp][c] = sum_b nu[rp][b] trans[b][c]
        T foo = 0;
#pragma unroll
        for (int b = 0; b < sb; ++b) foo += nu[rp][b] * tr[b][c];
        // Theta_t[rp][c][:] = softmax_rc of the backward step's logits
        T x[MSR];
        T mx = neg_inf<T>();
#pragma unroll
        for (int rc = 0; rc < sr; ++rc) {
          x[rc] = s_log_a[rp * sr + rc] + (ell[c][rc] + lk[c][rc]);
          mx = dmax(mx, x[rc]);
        }
        mx = finite_or_zero(mx);
        T s = 0;
#pragma unroll
        for (int rc = 0; rc < sr; ++rc) {
          x[rc] = dexp(x[rc] - mx);
          s += x[rc];
        }
        const T scale = foo / s;
#pragma unroll
        for (int rc = 0; rc < sr; ++rc) {
          const T xi = scale * x[rc];
          sxi[rp][rc] += xi;
          nn[rc][c] += xi;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < sr; ++r)
#pragma unroll
      for (int b = 0; b < sb; ++b) {
        nu[r][b] = nn[r][b];
        stn[r][b] += nn[r][b];
      }
  }

#pragma unroll
  for (int r = 0; r < sr; ++r) {
#pragma unroll
    for (int rc = 0; rc < sr; ++rc)
      sxi_out[static_cast<size_t>((j * sr + r) * sr + rc) * skb + i] = sxi[r][rc];
#pragma unroll
    for (int b = 0; b < sb; ++b)
      stn_out[static_cast<size_t>((j * sr + r) * sb + b) * skb + i] = stn[r][b];
  }
}

}  // namespace vbhem_pair
