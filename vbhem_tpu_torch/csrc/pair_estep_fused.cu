// Fused VBHEM pair E-step for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_fused` (vbhem_tpu/ops/pair_estep_pallas.py,
// launched by `pair_bwd_fwd_fused_pallas`) and its shared `_recursion`.  For
// every (base HMM i, reduced HMM j) pair it computes the expected emission
// matrix E3logN[b, r] from the base moments and the reduced NIW posterior,
// then runs the recursion of pair_recursion.cuh (shared with kernel B3,
// pair_bwd_fwd.cu): tau-1 backward steps with a log-sum-exp over the
// reduced state, the termination ll_elbo = sum_b prior_b lse_b, and the
// forward pass that accumulates nu_1, sum_xi and sum_t_nu.  The plain
// PyTorch version is
// `vbhem_tpu_torch/ops/pair_estep.py` (expected_pair_ll_variational +
// pair_bwd_fwd).
//
// What bounds it on this card: not bytes (the base bank is a few MB and each
// pair reads ~40 values and writes ~1 + Sr + Sr^2 + Sr Sb), but the
// transcendentals of the log-sum-exps (per pair and step: Sr*Sb*Sr exp and
// Sr*Sb log) and the per-thread registers that hold one pair's state
// (prior, trans, E3logN, the backward carry, the forward accumulators).
// The design:
//   * one thread per (lane*Kr + j, i) pair, i fastest across a block of 128,
//     so every base-parameter load (laid out with Kb last) is coalesced;
//   * grid (ceil(Kb / 128), L*Kr): a block serves one reduced model, whose
//     parameters (a few hundred bytes) it stages once in shared memory;
//   * E3logN is computed in registers and never stored;
//   * the backward carry is rebased per base state at every step (its
//     shift kept apart in registers), so the softmaxes read numbers near
//     their spread, not near the carry's magnitude, which grows with tau;
//   * the backward pass stores only its carry LL_old [Sb, Sr] per step (not
//     Theta [Sr, Sb, Sr]) to a global scratch [tau-1, Sb*Sr, L*Kr, Kb]; the
//     forward pass rebuilds Theta from it.  That trades Sr*Sb*Sr exps per
//     step (doubling the function's own count) for 3x fewer scratch
//     bytes: itemsize * (tau-1) * Sb * Sr per pair, written once and read
//     back once; in f32 at tau=10, 21 MB at the bench shape (fits in the
//     50 MB L2) and 64 MB at the main-path cell (does not);
//   * the shapes the clustering paths launch, (Sb, Sr, D) = (3, 3, 2) and
//     (3, 2, 2) on the planted bank and (2, 2, 2) on a learned bank of
//     2-state HMMs, are compile-time specializations whose loops unroll
//     and whose arrays live in registers; every other shape in Sb, Sr <= 8,
//     D <= 4 runs a generic instantiation with runtime bounds.
// Templated on float and double; no tensor cores, TMA or tuning yet.

#include "pair_recursion.cuh"

namespace {

using namespace vbhem_pair;

constexpr int kMaxD = 4;

// Specialized instantiations pass SB_, SR_, D_ > 0 and the loops below get
// compile-time trip counts; the generic one passes 0 and reads the runtime
// sizes.  Array extents are the compile-time bound either way.
template <typename T, int SB_, int SR_, int D_>
__global__ void __launch_bounds__(kThreads)
pair_estep_fused_kernel(const T* __restrict__ prior,    // [Sb, Kb]
                        const T* __restrict__ trans,    // [Sb, Sb, Kb]
                        const T* __restrict__ mean,     // [Sb, D, Kb]
                        const T* __restrict__ cov,      // [Sb, D, D, Kb]
                        const T* __restrict__ log_pi,   // [LKr, Sr]
                        const T* __restrict__ log_a,    // [LKr, Sr, Sr]
                        const T* __restrict__ m_r,      // [LKr, Sr, D]
                        const T* __restrict__ w_r,      // [LKr, Sr, D, D]
                        const T* __restrict__ v_r,      // [LKr, Sr]
                        const T* __restrict__ lam_r,    // [LKr, Sr]
                        const T* __restrict__ loglam_r, // [LKr, Sr]
                        T* __restrict__ ll_out,         // [LKr, Kb]
                        T* __restrict__ nu1_out,        // [LKr, Sr, Kb]
                        T* __restrict__ sxi_out,        // [LKr, Sr, Sr, Kb]
                        T* __restrict__ stn_out,        // [LKr, Sr, Sb, Kb]
                        T* __restrict__ carry,          // [tau-1, Sb*Sr, LKr, Kb]
                        int kb, int lkr, int sb_rt, int sr_rt, int d_rt,
                        int tau) {
  constexpr int MSB = Cap<SB_>::value;
  constexpr int MSR = Cap<SR_>::value;
  constexpr int MD = D_ > 0 ? D_ : kMaxD;
  const int sb = SB_ > 0 ? SB_ : sb_rt;
  const int sr = SR_ > 0 ? SR_ : sr_rt;
  const int d = D_ > 0 ? D_ : d_rt;

  // ---- stage the reduced model j in shared memory ----
  __shared__ T s_log_pi[MSR];
  __shared__ T s_log_a[MSR * MSR];
  __shared__ T s_m[MSR * MD];
  __shared__ T s_w[MSR * MD * MD];
  __shared__ T s_v[MSR];
  __shared__ T s_c[MSR];  // D log 2pi - E log|Lambda| + D / lambda
  const int j = blockIdx.y;
  const T two_pi = static_cast<T>(6.283185307179586476925286766559);
  for (int q = threadIdx.x; q < sr; q += blockDim.x) {
    s_log_pi[q] = log_pi[j * sr + q];
    s_v[q] = v_r[j * sr + q];
    s_c[q] = (static_cast<T>(d) * dlog(two_pi) - loglam_r[j * sr + q]) +
             static_cast<T>(d) / lam_r[j * sr + q];
  }
  for (int q = threadIdx.x; q < sr * sr; q += blockDim.x)
    s_log_a[q] = log_a[(size_t)j * sr * sr + q];
  for (int q = threadIdx.x; q < sr * d; q += blockDim.x)
    s_m[q] = m_r[(size_t)j * sr * d + q];
  for (int q = threadIdx.x; q < sr * d * d; q += blockDim.x)
    s_w[q] = w_r[(size_t)j * sr * d * d + q];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kb) return;
  const size_t skb = static_cast<size_t>(kb);

  // ---- this thread's base HMM i ----
  T pr[MSB];
  T tr[MSB][MSB];
  T ell[MSB][MSR];
#pragma unroll
  for (int b = 0; b < sb; ++b) {
    pr[b] = prior[b * skb + i];
#pragma unroll
    for (int c = 0; c < sb; ++c) tr[b][c] = trans[(b * sb + c) * skb + i];
  }

  // ---- E3logN [Sb, Sr] in registers ----
#pragma unroll
  for (int b = 0; b < sb; ++b) {
    T mu[MD];
    T sg[MD][MD];
#pragma unroll
    for (int e = 0; e < d; ++e) {
      mu[e] = mean[(b * d + e) * skb + i];
#pragma unroll
      for (int f = 0; f < d; ++f) sg[e][f] = cov[((b * d + e) * d + f) * skb + i];
    }
#pragma unroll
    for (int r = 0; r < sr; ++r) {
      T trw = 0, quad = 0;
#pragma unroll
      for (int e = 0; e < d; ++e) {
        const T de = mu[e] - s_m[r * d + e];
#pragma unroll
        for (int f = 0; f < d; ++f) {
          const T w = s_w[(r * d + e) * d + f];
          trw += w * sg[f][e];
          quad += de * w * (mu[f] - s_m[r * d + f]);
        }
      }
      ell[b][r] = static_cast<T>(-0.5) * (s_c[r] + s_v[r] * (trw + quad));
    }
  }

  pair_recursion<T, SB_, SR_>(pr, tr, ell, s_log_pi, s_log_a, carry, ll_out,
                              nu1_out, sxi_out, stn_out, j, i, kb, lkr, sb_rt,
                              sr_rt, tau);
}

template <typename T>
int launch(const void* prior, const void* trans, const void* mean,
           const void* cov, const void* log_pi, const void* log_a,
           const void* m_r, const void* w_r, const void* v_r,
           const void* lam_r, const void* loglam_r, void* ll_out,
           void* nu1_out, void* sxi_out, void* stn_out, void* carry, int kb,
           int lkr, int sb, int sr, int d, int tau, void* stream) {
  const dim3 grid((kb + kThreads - 1) / kThreads, lkr);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VBHEM_ARGS                                                          \
  static_cast<const T*>(prior), static_cast<const T*>(trans),               \
      static_cast<const T*>(mean), static_cast<const T*>(cov),              \
      static_cast<const T*>(log_pi), static_cast<const T*>(log_a),          \
      static_cast<const T*>(m_r), static_cast<const T*>(w_r),               \
      static_cast<const T*>(v_r), static_cast<const T*>(lam_r),             \
      static_cast<const T*>(loglam_r), static_cast<T*>(ll_out),             \
      static_cast<T*>(nu1_out), static_cast<T*>(sxi_out),                   \
      static_cast<T*>(stn_out), static_cast<T*>(carry), kb, lkr, sb, sr, d, \
      tau
  if (sb == 3 && sr == 3 && d == 2)
    pair_estep_fused_kernel<T, 3, 3, 2><<<grid, block, 0, st>>>(VBHEM_ARGS);
  else if (sb == 3 && sr == 2 && d == 2)
    pair_estep_fused_kernel<T, 3, 2, 2><<<grid, block, 0, st>>>(VBHEM_ARGS);
  else if (sb == 2 && sr == 2 && d == 2)
    pair_estep_fused_kernel<T, 2, 2, 2><<<grid, block, 0, st>>>(VBHEM_ARGS);
  else
    pair_estep_fused_kernel<T, 0, 0, 0><<<grid, block, 0, st>>>(VBHEM_ARGS);
#undef VBHEM_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  The caller validates shapes, dtypes,
// contiguity and ranges (Sb, Sr in 1..8, D in 1..4, tau >= 1, L*Kr <= 65535)
// and allocates every output and the carry scratch.  Returns the
// cudaError_t of the launch (0 = launched).
extern "C" int vbhem_pair_estep_fused_f32(
    const void* prior, const void* trans, const void* mean, const void* cov,
    const void* log_pi, const void* log_a, const void* m_r, const void* w_r,
    const void* v_r, const void* lam_r, const void* loglam_r, void* ll_out,
    void* nu1_out, void* sxi_out, void* stn_out, void* carry, int kb, int lkr,
    int sb, int sr, int d, int tau, void* stream) {
  return launch<float>(prior, trans, mean, cov, log_pi, log_a, m_r, w_r, v_r,
                       lam_r, loglam_r, ll_out, nu1_out, sxi_out, stn_out,
                       carry, kb, lkr, sb, sr, d, tau, stream);
}

extern "C" int vbhem_pair_estep_fused_f64(
    const void* prior, const void* trans, const void* mean, const void* cov,
    const void* log_pi, const void* log_a, const void* m_r, const void* w_r,
    const void* v_r, const void* lam_r, const void* loglam_r, void* ll_out,
    void* nu1_out, void* sxi_out, void* stn_out, void* carry, int kb, int lkr,
    int sb, int sr, int d, int tau, void* stream) {
  return launch<double>(prior, trans, mean, cov, log_pi, log_a, m_r, w_r, v_r,
                        lam_r, loglam_r, ll_out, nu1_out, sxi_out, stn_out,
                        carry, kb, lkr, sb, sr, d, tau, stream);
}
