// Fused VBHEM pair E-step for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_fused` (vbhem_tpu/ops/pair_estep_pallas.py,
// launched by `pair_bwd_fwd_fused_pallas`) and its shared `_recursion`.  For
// every (base HMM i, reduced HMM j) pair it computes the expected emission
// matrix E3logN[b, r] from the base moments and the reduced NIW posterior,
// then runs the recursion of pair_recursion.cuh (shared with kernel B3,
// pair_bwd_fwd.cu): tau-1 scaled backward steps, the termination
// ll_elbo = sum_b prior_b lse_b, and the forward pass that accumulates
// nu_1, sum_xi and sum_t_nu.  The plain PyTorch version is
// `vbhem_tpu_torch/ops/pair_estep.py` (expected_pair_ll_variational +
// pair_bwd_fwd).
//
// What bounds it on this card: not bytes (the base bank is a few MB and each
// pair reads ~40 values and writes ~1 + Sr + Sr^2 + Sr Sb), but the
// recursion's instructions (per pair and step Sb*Sr exp, Sr*Sb log, Sr*Sb
// reciprocals and some 4 Sr^2 Sb FMAs; about 380 instructions at
// Sb = Sr = 3) and the latency of each thread's serial chain of steps,
// which the pairs in flight per SM hide.  The design:
//   * one thread per (lane*Kr + j, i) pair, i fastest across a block, so
//     every base-parameter load (laid out with Kb last) is coalesced;
//   * grid (ceil(Kb / threads), L*Kr): a block serves one reduced model,
//     whose parameters (a few hundred bytes) and exp(log_a) it stages once
//     in shared memory;
//   * E3logN is computed in registers and never stored;
//   * the recursion's per-step state stays on chip where the shape lets it
//     (pair_recursion.cuh): the wrapper (`ops/pair_estep_cuda.py:design`)
//     picks the block size and keeps every step in shared memory where a
//     block holds it at enough pairs per SM, else segments of steps and
//     their carries in shared memory (recomputing a segment's steps in the
//     forward pass), and a device-memory scratch only where neither fits;
//   * the shapes the clustering paths launch, (Sb, Sr, D) = (3, 3, 2) and
//     (3, 2, 2) on the planted bank and (2, 2, 2) on a learned bank of
//     2-state HMMs, are compile-time specializations whose loops unroll
//     and whose arrays live in registers; so is the padded grid's
//     (2, 5, 2) (the protocol's grid, Smax = 5, on a bank of 2-state
//     HMMs), which runs each block at its lane's unmasked states and
//     forms E3logN only for them; every other shape in Sb, Sr <= 8,
//     D <= 4 runs a generic instantiation with runtime bounds, and Sb or
//     Sr above 8 the wide body (pair_recursion.cuh: vectors in device
//     memory, the scratch design only).  D > 4 never reaches this kernel:
//     the wrapper forms E3logN in PyTorch and launches B3.
// Templated on float and double.

#include "pair_recursion.cuh"

namespace {

using namespace vbhem_pair;

constexpr int kMaxD = 4;

// Specialized instantiations pass SB_, SR_, D_ > 0 and the loops below get
// compile-time extents; the generic one passes 0 and reads the runtime
// sizes.  Array extents are the compile-time bound either way.  kTrim: the
// body runs each block at the reduced model's live states
// (pair_recursion.cuh: live_states) and writes zeros at the others.
template <typename T, int SB_, int SR_, int D_, int kDesign, bool kTrim>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks<T, kTrim>)
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
                        T* __restrict__ scratch,        // kScratch only:
                                                        // [tau-1, Sb*Sr, LKr, Kb]
                        int kb, int lkr, int sb_rt, int sr_rt, int d_rt,
                        int tau, int seg) {
  constexpr int MSB = Cap<SB_>::value;
  constexpr int MSR = Cap<SR_>::value;
  constexpr int MD = D_ > 0 ? D_ : kMaxD;
  const int sb = SB_ > 0 ? SB_ : sb_rt;
  const int ld = SR_ > 0 ? SR_ : sr_rt;   // Sr of the layouts
  const int d = D_ > 0 ? D_ : d_rt;

  // ---- stage the reduced model j in shared memory ----
  __shared__ Reduced<T, SR_> red;
  __shared__ T s_m[MSR * MD];
  __shared__ T s_w[MSR * MD * MD];
  __shared__ T s_v[MSR];
  __shared__ T s_c[MSR];  // D log 2pi - E log|Lambda| + D / lambda
  const int j = blockIdx.y;
  const T two_pi = static_cast<T>(6.283185307179586476925286766559);
  stage_reduced(red, log_pi, log_a, j, ld);
  for (int q = threadIdx.x; q < ld; q += blockDim.x) {
    s_v[q] = v_r[j * ld + q];
    s_c[q] = (static_cast<T>(d) * log(two_pi) - loglam_r[j * ld + q]) +
             static_cast<T>(d) / lam_r[j * ld + q];
  }
  for (int q = threadIdx.x; q < ld * d; q += blockDim.x)
    s_m[q] = m_r[(size_t)j * ld * d + q];
  for (int q = threadIdx.x; q < ld * d * d; q += blockDim.x)
    s_w[q] = w_r[(size_t)j * ld * d * d + q];
  __syncthreads();
  // the states this block runs
  const int sr = kTrim ? live_states(red, ld) : ld;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kb) return;
  const size_t skb = static_cast<size_t>(kb);

  // ---- this thread's base HMM i ----
  T pr[MSB];
  T tr[MSB][MSB];
  T ell[MSB][MSR];
  VB_FOR(b, SB_, sb) {
    pr[b] = prior[b * skb + i];
    VB_FOR(c, SB_, sb) { tr[b][c] = trans[(b * sb + c) * skb + i]; }
  }

  // ---- E3logN [Sb, Sr] in registers ----
  VB_FOR(b, SB_, sb) {
    T mu[MD];
    T sg[MD][MD];
    VB_FOR(e, D_, d) {
      mu[e] = mean[(b * d + e) * skb + i];
      VB_FOR(f, D_, d) { sg[e][f] = cov[((b * d + e) * d + f) * skb + i]; }
    }
    VB_FOR(r, SR_, sr) {
      T trw = 0, quad = 0;
      VB_FOR(e, D_, d) {
        const T de = mu[e] - s_m[r * d + e];
        VB_FOR(f, D_, d) {
          const T w = s_w[(r * d + e) * d + f];
          trw += w * sg[f][e];
          quad += de * w * (mu[f] - s_m[r * d + f]);
        }
      }
      ell[b][r] = static_cast<T>(-0.5) * (s_c[r] + s_v[r] * (trw + quad));
    }
  }

  size_t stride;
  T* st = state_base<T, kDesign>(scratch, static_cast<size_t>(j) * skb + i,
                                 static_cast<size_t>(lkr) * skb, stride);
  if constexpr (kTrim && sizeof(T) == 4) {
    pair_recursion_live<T, SB_, SR_, kDesign>(pr, tr, ell, red, st, stride,
                                              ll_out, nu1_out, sxi_out,
                                              stn_out, j, i, kb, sb, sr, ld,
                                              tau, seg);
  } else {
    pair_recursion<T, SB_, SR_, kDesign>(pr, tr, ell, red, st, stride,
                                         ll_out, nu1_out, sxi_out, stn_out, j,
                                         i, kb, sb, sr, ld, tau, seg);
  }
}

// The wide body (Sb or Sr above kMaxS, pair_recursion.cuh): the reduced
// model and its emission constants in dynamic shared memory; E3logN, the
// states and the working vectors in the scratch [tau-1, Sb*Sr, LKr, Kb] +
// [Sb*Sr + wide_work_values, LKr, Kb].  D <= kMaxD (the wrapper routes
// wider data to B3).
__host__ __device__ __forceinline__ int wide_fused_smem_values(int sr, int d) {
  return wide_reduced_values(sr) + sr * d + sr * d * d + 2 * sr;
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
pair_estep_fused_wide_kernel(
    const T* __restrict__ prior, const T* __restrict__ trans,
    const T* __restrict__ mean, const T* __restrict__ cov,
    const T* __restrict__ log_pi, const T* __restrict__ log_a,
    const T* __restrict__ m_r, const T* __restrict__ w_r,
    const T* __restrict__ v_r, const T* __restrict__ lam_r,
    const T* __restrict__ loglam_r, T* __restrict__ ll_out,
    T* __restrict__ nu1_out, T* __restrict__ sxi_out, T* __restrict__ stn_out,
    T* __restrict__ scratch, int kb, int lkr, int sb, int sr, int d, int tau) {
  T* smem = reinterpret_cast<T*>(pair_smem);
  const WideReduced<T> red(smem, sr);
  T* s_m = smem + wide_reduced_values(sr);
  T* s_w = s_m + sr * d;
  T* s_v = s_w + sr * d * d;
  T* s_c = s_v + sr;
  const int j = blockIdx.y;
  const T two_pi = static_cast<T>(6.283185307179586476925286766559);
  stage_reduced_wide(red, log_pi, log_a, j, sr);
  for (int q = threadIdx.x; q < sr; q += blockDim.x) {
    s_v[q] = v_r[static_cast<size_t>(j) * sr + q];
    s_c[q] = (static_cast<T>(d) * log(two_pi) -
              loglam_r[static_cast<size_t>(j) * sr + q]) +
             static_cast<T>(d) / lam_r[static_cast<size_t>(j) * sr + q];
  }
  for (int q = threadIdx.x; q < sr * d; q += blockDim.x)
    s_m[q] = m_r[static_cast<size_t>(j) * sr * d + q];
  for (int q = threadIdx.x; q < sr * d * d; q += blockDim.x)
    s_w[q] = w_r[static_cast<size_t>(j) * sr * d * d + q];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kb) return;
  const size_t skb = static_cast<size_t>(kb);
  const size_t plane = static_cast<size_t>(lkr) * skb;
  const size_t pix = static_cast<size_t>(j) * skb + i;
  T* work = scratch + static_cast<size_t>(tau - 1) * sb * sr * plane + pix;
  const Strided<T> ell{work, plane};

  // ---- E3logN [Sb, Sr], as the other bodies form it ----
  for (int b = 0; b < sb; ++b) {
    T mu[kMaxD];
    T sg[kMaxD][kMaxD];
    for (int e = 0; e < d; ++e) {
      mu[e] = mean[(static_cast<size_t>(b) * d + e) * skb + i];
      for (int f = 0; f < d; ++f)
        sg[e][f] = cov[((static_cast<size_t>(b) * d + e) * d + f) * skb + i];
    }
    for (int r = 0; r < sr; ++r) {
      T trw = 0, quad = 0;
      for (int e = 0; e < d; ++e) {
        const T de = mu[e] - s_m[r * d + e];
        for (int f = 0; f < d; ++f) {
          const T wv = s_w[(r * d + e) * d + f];
          trw += wv * sg[f][e];
          quad += de * wv * (mu[f] - s_m[r * d + f]);
        }
      }
      ell[b * sr + r] = static_cast<T>(-0.5) * (s_c[r] + s_v[r] * (trw + quad));
    }
  }

  const WideWork<T> w(work + static_cast<size_t>(sb) * sr * plane, plane, sb,
                      sr);
  pair_recursion_wide<T>(
      Strided<const T>{prior + i, skb}, Strided<const T>{trans + i, skb},
      Strided<const T>{work, plane}, red, scratch + pix, plane, w, ll_out,
      nu1_out, sxi_out, stn_out, j, i, kb, sb, sr, tau);
}

struct Args {
  const void *prior, *trans, *mean, *cov, *log_pi, *log_a, *m_r, *w_r, *v_r,
      *lam_r, *loglam_r;
  void *ll_out, *nu1_out, *sxi_out, *stn_out, *scratch;
  int kb, lkr, sb, sr, d, tau, design, threads, smem, seg;
  cudaStream_t stream;
};

template <typename T, int SB_, int SR_, int D_, int kDesign, bool kTrim>
int launch_one(const Args& a) {
  auto* kernel = pair_estep_fused_kernel<T, SB_, SR_, D_, kDesign, kTrim>;
  const int err = prepare_launch(kernel, a.design, a.threads, a.smem, a.seg,
                                 a.sb, a.sr, a.tau, sizeof(T),
                                 a.scratch != nullptr);
  if (err != 0) return err;
  const dim3 grid((a.kb + a.threads - 1) / a.threads, a.lkr);
  kernel<<<grid, a.threads, a.smem, a.stream>>>(
      static_cast<const T*>(a.prior), static_cast<const T*>(a.trans),
      static_cast<const T*>(a.mean), static_cast<const T*>(a.cov),
      static_cast<const T*>(a.log_pi), static_cast<const T*>(a.log_a),
      static_cast<const T*>(a.m_r), static_cast<const T*>(a.w_r),
      static_cast<const T*>(a.v_r), static_cast<const T*>(a.lam_r),
      static_cast<const T*>(a.loglam_r), static_cast<T*>(a.ll_out),
      static_cast<T*>(a.nu1_out), static_cast<T*>(a.sxi_out),
      static_cast<T*>(a.stn_out), static_cast<T*>(a.scratch), a.kb, a.lkr,
      a.sb, a.sr, a.d, a.tau, a.seg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int SB_, int SR_, int D_, bool kTrim = false>
int launch_shape(const Args& a) {
  switch (a.design) {
    case kResident: return launch_one<T, SB_, SR_, D_, kResident, kTrim>(a);
    case kScratch: return launch_one<T, SB_, SR_, D_, kScratch, kTrim>(a);
    case kCheckpointed:   // float32 only (pair_recursion.cuh)
      if constexpr (sizeof(T) == 4)
        return launch_one<T, SB_, SR_, D_, kCheckpointed, kTrim>(a);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_wide(const Args& a) {
  if (a.d < 1 || a.d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  auto* kernel = pair_estep_fused_wide_kernel<T>;
  const size_t smem = sizeof(T) * wide_fused_smem_values(a.sr, a.d);
  const int err = prepare_wide_launch(kernel, a.design, a.threads, smem,
                                      a.scratch != nullptr);
  if (err != 0) return err;
  const dim3 grid((a.kb + a.threads - 1) / a.threads, a.lkr);
  kernel<<<grid, a.threads, smem, a.stream>>>(
      static_cast<const T*>(a.prior), static_cast<const T*>(a.trans),
      static_cast<const T*>(a.mean), static_cast<const T*>(a.cov),
      static_cast<const T*>(a.log_pi), static_cast<const T*>(a.log_a),
      static_cast<const T*>(a.m_r), static_cast<const T*>(a.w_r),
      static_cast<const T*>(a.v_r), static_cast<const T*>(a.lam_r),
      static_cast<const T*>(a.loglam_r), static_cast<T*>(a.ll_out),
      static_cast<T*>(a.nu1_out), static_cast<T*>(a.sxi_out),
      static_cast<T*>(a.stn_out), static_cast<T*>(a.scratch), a.kb, a.lkr,
      a.sb, a.sr, a.d, a.tau);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a) {
  if (a.d < 1 || a.d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  if (a.sb > kMaxS || a.sr > kMaxS) return launch_wide<T>(a);
  if (a.sb == 3 && a.sr == 3 && a.d == 2) return launch_shape<T, 3, 3, 2>(a);
  if (a.sb == 3 && a.sr == 2 && a.d == 2) return launch_shape<T, 3, 2, 2>(a);
  if (a.sb == 2 && a.sr == 2 && a.d == 2) return launch_shape<T, 2, 2, 2>(a);
  if (a.sb == 2 && a.sr == 5 && a.d == 2)
    return launch_shape<T, 2, 5, 2, true>(a);
  return launch_shape<T, 0, 0, 0>(a);
}

}  // namespace

// Plain C interface for ctypes.  The caller validates shapes, dtypes,
// contiguity and ranges (Sb, Sr >= 1, D in 1..4, tau >= 1, L*Kr <= 65535;
// above Sb, Sr = 8 the scratch design, with E3logN and the wide body's
// workspace after the states),
// chooses the design (0 resident in shared memory, 1 device-memory
// scratch, 2 checkpointed segments of `seg` steps in shared memory), the
// block size `threads` (a multiple of 32 up to 128) and the dynamic shared
// memory `smem` in bytes, and allocates every output and, for design 1
// only, the scratch [tau-1, Sb*Sr, L*Kr, Kb] (else passes null).  Returns
// the cudaError_t of the launch (0 = launched; cudaErrorInvalidValue for a
// configuration the kernel does not take).
#define VBHEM_FUSED_ENTRY(NAME, T)                                            \
  extern "C" int NAME(                                                        \
      const void* prior, const void* trans, const void* mean,                 \
      const void* cov, const void* log_pi, const void* log_a,                 \
      const void* m_r, const void* w_r, const void* v_r, const void* lam_r,   \
      const void* loglam_r, void* ll_out, void* nu1_out, void* sxi_out,       \
      void* stn_out, void* scratch, int kb, int lkr, int sb, int sr, int d,   \
      int tau, int design, int threads, int smem, int seg, void* stream) {    \
    const Args a{prior, trans, mean, cov, log_pi, log_a, m_r, w_r, v_r,       \
                 lam_r, loglam_r, ll_out, nu1_out, sxi_out, stn_out, scratch, \
                 kb, lkr, sb, sr, d, tau, design, threads, smem, seg,         \
                 static_cast<cudaStream_t>(stream)};                          \
    return launch<T>(a);                                                      \
  }

VBHEM_FUSED_ENTRY(vbhem_pair_estep_fused_f32, float)
VBHEM_FUSED_ENTRY(vbhem_pair_estep_fused_f64, double)
