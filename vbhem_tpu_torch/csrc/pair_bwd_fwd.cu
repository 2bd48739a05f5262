// Pair recursion on a precomputed emission matrix, for NVIDIA Hopper
// (sm_90a): the E-step of VHEM and the deviance of DIC.
//
// Replaces the TPU kernel `_kernel` (vbhem_tpu/ops/pair_estep_pallas.py,
// launched by `pair_bwd_fwd_pallas`) on its shared `_recursion`.  For every
// (base HMM i, reduced HMM j) pair it reads the expected emission matrix
// ell[b, r] from memory and runs the recursion of pair_recursion.cuh, the
// one kernel B1 (pair_estep_fused.cu) runs after computing its ell in
// registers.  The plain PyTorch version is `pair_bwd_fwd` in
// vbhem_tpu_torch/ops/pair_estep.py.
//
// What bounds it on this card: at the VHEM path's shapes the inputs (ell,
// Sb*Sr values per pair) and outputs (1 + Sr + Sr^2 + Sr*Sb per pair) take
// less time to move than the recursion's instructions take to issue (per
// pair and step Sb*Sr exp, Sr*Sb log, Sr*Sb reciprocals and the FMAs
// around them), and each thread's serial chain of steps needs enough pairs
// in flight per SM to hide its latency.  The design is B1's:
//   * one thread per (lane*Kr + j, i) pair, i fastest across a block; ell
//     comes laid out [L*Kr, Sb, Sr, Kb], so its loads coalesce like the
//     base parameters' (the wrapper receives ell as a view of that buffer
//     from `expected_pair_ll_point` and copies nothing);
//   * grid (ceil(Kb / threads), L*Kr): a block stages its reduced model's
//     log_pi, log_a and exp(log_a) in shared memory;
//   * the per-step state of the recursion stays on chip, in shared memory,
//     wherever the wrapper finds a block holds it at enough pairs per SM:
//     every step, or segments of steps and their carries (recomputing a
//     segment's steps in the forward pass); it goes to a device-memory
//     scratch only where neither fits (pair_recursion.cuh);
//   * the VHEM path's bank has Sb=2 and its grid Sr in 1..3: (Sb, Sr) =
//     (2, 1), (2, 2), (2, 3) are compile-time specializations; so is
//     (2, 5), the float64 rescoring's largest cell and the padded grid's
//     shape, which runs each block at its reduced model's unmasked states;
//     every other shape in Sb, Sr <= 8 runs a generic instantiation, and
//     larger ones the wide body of pair_recursion.cuh (vectors in device
//     memory, the scratch design only).
// Templated on float and double.

#include "pair_recursion.cuh"

namespace {

using namespace vbhem_pair;

template <typename T, int SB_, int SR_, int kDesign, bool kTrim>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks<T, kTrim>)
pair_bwd_fwd_kernel(const T* __restrict__ ell_in,  // [LKr, Sb, Sr, Kb]
                    const T* __restrict__ prior,   // [Sb, Kb]
                    const T* __restrict__ trans,   // [Sb, Sb, Kb]
                    const T* __restrict__ log_pi,  // [LKr, Sr]
                    const T* __restrict__ log_a,   // [LKr, Sr, Sr]
                    T* __restrict__ ll_out,        // [LKr, Kb]
                    T* __restrict__ nu1_out,       // [LKr, Sr, Kb]
                    T* __restrict__ sxi_out,       // [LKr, Sr, Sr, Kb]
                    T* __restrict__ stn_out,       // [LKr, Sr, Sb, Kb]
                    T* __restrict__ scratch,       // kScratch only:
                                                   // [tau-1, Sb*Sr, LKr, Kb]
                    int kb, int lkr, int sb_rt, int sr_rt, int tau,
                    int seg) {
  constexpr int MSB = Cap<SB_>::value;
  constexpr int MSR = Cap<SR_>::value;
  const int sb = SB_ > 0 ? SB_ : sb_rt;
  const int ld = SR_ > 0 ? SR_ : sr_rt;   // Sr of the layouts

  __shared__ Reduced<T, SR_> red;
  const int j = blockIdx.y;
  stage_reduced(red, log_pi, log_a, j, ld);
  __syncthreads();
  // the states this block runs
  const int sr = kTrim ? live_states(red, ld) : ld;

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kb) return;
  const size_t skb = static_cast<size_t>(kb);

  T pr[MSB];
  T tr[MSB][MSB];
  T ell[MSB][MSR];
  VB_FOR(b, SB_, sb) {
    pr[b] = prior[b * skb + i];
    VB_FOR(c, SB_, sb) { tr[b][c] = trans[(b * sb + c) * skb + i]; }
    VB_FOR(r, SR_, sr) {
      ell[b][r] = ell_in[(static_cast<size_t>(j * sb + b) * ld + r) * skb + i];
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
// model in dynamic shared memory, the states and the working vectors in
// the scratch [tau-1, Sb*Sr, LKr, Kb] + [wide_work_values, LKr, Kb].
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
pair_bwd_fwd_wide_kernel(const T* __restrict__ ell_in, const T* __restrict__ prior,
                         const T* __restrict__ trans, const T* __restrict__ log_pi,
                         const T* __restrict__ log_a, T* __restrict__ ll_out,
                         T* __restrict__ nu1_out, T* __restrict__ sxi_out,
                         T* __restrict__ stn_out, T* __restrict__ scratch,
                         int kb, int lkr, int sb, int sr, int tau) {
  const WideReduced<T> red(reinterpret_cast<T*>(pair_smem), sr);
  const int j = blockIdx.y;
  stage_reduced_wide(red, log_pi, log_a, j, sr);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kb) return;
  const size_t skb = static_cast<size_t>(kb);
  const size_t plane = static_cast<size_t>(lkr) * skb;
  const size_t pix = static_cast<size_t>(j) * skb + i;
  T* st = scratch + pix;
  const WideWork<T> w(
      scratch + static_cast<size_t>(tau - 1) * sb * sr * plane + pix, plane,
      sb, sr);
  pair_recursion_wide<T>(
      Strided<const T>{prior + i, skb}, Strided<const T>{trans + i, skb},
      Strided<const T>{ell_in + static_cast<size_t>(j) * sb * sr * skb + i,
                       skb},
      red, st, plane, w, ll_out, nu1_out, sxi_out, stn_out, j, i, kb, sb, sr,
      tau);
}

struct Args {
  const void *ell, *prior, *trans, *log_pi, *log_a;
  void *ll_out, *nu1_out, *sxi_out, *stn_out, *scratch;
  int kb, lkr, sb, sr, tau, design, threads, smem, seg;
  cudaStream_t stream;
};

template <typename T, int SB_, int SR_, int kDesign, bool kTrim>
int launch_one(const Args& a) {
  auto* kernel = pair_bwd_fwd_kernel<T, SB_, SR_, kDesign, kTrim>;
  const int err = prepare_launch(kernel, a.design, a.threads, a.smem, a.seg,
                                 a.sb, a.sr, a.tau, sizeof(T),
                                 a.scratch != nullptr);
  if (err != 0) return err;
  const dim3 grid((a.kb + a.threads - 1) / a.threads, a.lkr);
  kernel<<<grid, a.threads, a.smem, a.stream>>>(
      static_cast<const T*>(a.ell), static_cast<const T*>(a.prior),
      static_cast<const T*>(a.trans), static_cast<const T*>(a.log_pi),
      static_cast<const T*>(a.log_a), static_cast<T*>(a.ll_out),
      static_cast<T*>(a.nu1_out), static_cast<T*>(a.sxi_out),
      static_cast<T*>(a.stn_out), static_cast<T*>(a.scratch), a.kb, a.lkr,
      a.sb, a.sr, a.tau, a.seg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int SB_, int SR_, bool kTrim = false>
int launch_shape(const Args& a) {
  switch (a.design) {
    case kResident: return launch_one<T, SB_, SR_, kResident, kTrim>(a);
    case kScratch: return launch_one<T, SB_, SR_, kScratch, kTrim>(a);
    case kCheckpointed:   // float32 only (pair_recursion.cuh)
      if constexpr (sizeof(T) == 4)
        return launch_one<T, SB_, SR_, kCheckpointed, kTrim>(a);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_wide(const Args& a) {
  auto* kernel = pair_bwd_fwd_wide_kernel<T>;
  const size_t smem = sizeof(T) * wide_reduced_values(a.sr);
  const int err = prepare_wide_launch(kernel, a.design, a.threads, smem,
                                      a.scratch != nullptr);
  if (err != 0) return err;
  const dim3 grid((a.kb + a.threads - 1) / a.threads, a.lkr);
  kernel<<<grid, a.threads, smem, a.stream>>>(
      static_cast<const T*>(a.ell), static_cast<const T*>(a.prior),
      static_cast<const T*>(a.trans), static_cast<const T*>(a.log_pi),
      static_cast<const T*>(a.log_a), static_cast<T*>(a.ll_out),
      static_cast<T*>(a.nu1_out), static_cast<T*>(a.sxi_out),
      static_cast<T*>(a.stn_out), static_cast<T*>(a.scratch), a.kb, a.lkr,
      a.sb, a.sr, a.tau);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a) {
  if (a.sb > kMaxS || a.sr > kMaxS) return launch_wide<T>(a);
  if (a.sb == 2 && a.sr == 1) return launch_shape<T, 2, 1>(a);
  if (a.sb == 2 && a.sr == 2) return launch_shape<T, 2, 2>(a);
  if (a.sb == 2 && a.sr == 3) return launch_shape<T, 2, 3>(a);
  if (a.sb == 2 && a.sr == 5) return launch_shape<T, 2, 5, true>(a);
  return launch_shape<T, 0, 0>(a);
}

}  // namespace

// Plain C interface for ctypes.  The caller validates shapes, dtypes,
// contiguity and ranges (Sb, Sr >= 1, tau >= 1, L*Kr <= 65535; above
// Sb, Sr = 8 the scratch design, with the wide body's workspace), lays
// ell out as [L*Kr, Sb, Sr, Kb] and the base bank with Kb last, chooses
// the design, block size, shared memory and segment length as for B1
// (vbhem_pair_estep_fused_*), and allocates every output and, for the
// scratch design only, the scratch.  Returns the cudaError_t of the launch
// (0 = launched).
#define VBHEM_BWD_FWD_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void* ell, const void* prior, const void* trans,  \
                      const void* log_pi, const void* log_a, void* ll_out,    \
                      void* nu1_out, void* sxi_out, void* stn_out,            \
                      void* scratch, int kb, int lkr, int sb, int sr,         \
                      int tau, int design, int threads, int smem, int seg,    \
                      void* stream) {                                         \
    const Args a{ell, prior, trans, log_pi, log_a, ll_out, nu1_out, sxi_out,  \
                 stn_out, scratch, kb, lkr, sb, sr, tau, design, threads,     \
                 smem, seg, static_cast<cudaStream_t>(stream)};               \
    return launch<T>(a);                                                      \
  }

VBHEM_BWD_FWD_ENTRY(vbhem_pair_bwd_fwd_f32, float)
VBHEM_BWD_FWD_ENTRY(vbhem_pair_bwd_fwd_f64, double)
