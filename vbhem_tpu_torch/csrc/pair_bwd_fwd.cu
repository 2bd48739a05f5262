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
// less time to move than the transcendentals of the log-sum-exps take to
// compute (per pair and step Sr*Sb*Sr exp and Sr*Sb log), so operations
// bound it, as they bound B1.  The design is B1's:
//   * one thread per (lane*Kr + j, i) pair, i fastest across a block of 128;
//     ell comes laid out [L*Kr, Sb, Sr, Kb], so its loads coalesce like the
//     base parameters' (the wrapper receives ell as a view of that buffer
//     from `expected_pair_ll_point` and copies nothing);
//   * grid (ceil(Kb / 128), L*Kr): a block stages its reduced model's
//     log_pi and log_a in shared memory;
//   * the backward carry goes to B1's global scratch [tau-1, Sb*Sr, L*Kr,
//     Kb] and the forward pass rebuilds Theta from it: itemsize * (tau-1) *
//     Sb * Sr per pair written and read back once, 106 MB each way in f32
//     at L=20, Kb=8192, Kr=3, Sb=2, Sr=3, tau=10 (more than L2 holds);
//   * the VHEM path's bank has Sb=2 and its grid Sr in 1..3: (Sb, Sr) =
//     (2, 1), (2, 2), (2, 3) are compile-time specializations; every other
//     shape in Sb, Sr <= 8 runs a generic instantiation.
// Templated on float and double; no tensor cores, TMA or tuning yet.

#include "pair_recursion.cuh"

namespace {

using namespace vbhem_pair;

template <typename T, int SB_, int SR_>
__global__ void __launch_bounds__(kThreads)
pair_bwd_fwd_kernel(const T* __restrict__ ell_in,  // [LKr, Sb, Sr, Kb]
                    const T* __restrict__ prior,   // [Sb, Kb]
                    const T* __restrict__ trans,   // [Sb, Sb, Kb]
                    const T* __restrict__ log_pi,  // [LKr, Sr]
                    const T* __restrict__ log_a,   // [LKr, Sr, Sr]
                    T* __restrict__ ll_out,        // [LKr, Kb]
                    T* __restrict__ nu1_out,       // [LKr, Sr, Kb]
                    T* __restrict__ sxi_out,       // [LKr, Sr, Sr, Kb]
                    T* __restrict__ stn_out,       // [LKr, Sr, Sb, Kb]
                    T* __restrict__ carry,         // [tau-1, Sb*Sr, LKr, Kb]
                    int kb, int lkr, int sb_rt, int sr_rt, int tau) {
  constexpr int MSB = Cap<SB_>::value;
  constexpr int MSR = Cap<SR_>::value;
  const int sb = SB_ > 0 ? SB_ : sb_rt;
  const int sr = SR_ > 0 ? SR_ : sr_rt;

  __shared__ T s_log_pi[MSR];
  __shared__ T s_log_a[MSR * MSR];
  const int j = blockIdx.y;
  for (int q = threadIdx.x; q < sr; q += blockDim.x)
    s_log_pi[q] = log_pi[j * sr + q];
  for (int q = threadIdx.x; q < sr * sr; q += blockDim.x)
    s_log_a[q] = log_a[(size_t)j * sr * sr + q];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kb) return;
  const size_t skb = static_cast<size_t>(kb);

  T pr[MSB];
  T tr[MSB][MSB];
  T ell[MSB][MSR];
#pragma unroll
  for (int b = 0; b < sb; ++b) {
    pr[b] = prior[b * skb + i];
#pragma unroll
    for (int c = 0; c < sb; ++c) tr[b][c] = trans[(b * sb + c) * skb + i];
#pragma unroll
    for (int r = 0; r < sr; ++r)
      ell[b][r] = ell_in[(static_cast<size_t>(j * sb + b) * sr + r) * skb + i];
  }

  pair_recursion<T, SB_, SR_>(pr, tr, ell, s_log_pi, s_log_a, carry, ll_out,
                              nu1_out, sxi_out, stn_out, j, i, kb, lkr, sb_rt,
                              sr_rt, tau);
}

template <typename T>
int launch(const void* ell, const void* prior, const void* trans,
           const void* log_pi, const void* log_a, void* ll_out, void* nu1_out,
           void* sxi_out, void* stn_out, void* carry, int kb, int lkr, int sb,
           int sr, int tau, void* stream) {
  const dim3 grid((kb + kThreads - 1) / kThreads, lkr);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VBHEM_ARGS                                                            \
  static_cast<const T*>(ell), static_cast<const T*>(prior),                   \
      static_cast<const T*>(trans), static_cast<const T*>(log_pi),            \
      static_cast<const T*>(log_a), static_cast<T*>(ll_out),                  \
      static_cast<T*>(nu1_out), static_cast<T*>(sxi_out),                     \
      static_cast<T*>(stn_out), static_cast<T*>(carry), kb, lkr, sb, sr, tau
  if (sb == 2 && sr == 1)
    pair_bwd_fwd_kernel<T, 2, 1><<<grid, block, 0, st>>>(VBHEM_ARGS);
  else if (sb == 2 && sr == 2)
    pair_bwd_fwd_kernel<T, 2, 2><<<grid, block, 0, st>>>(VBHEM_ARGS);
  else if (sb == 2 && sr == 3)
    pair_bwd_fwd_kernel<T, 2, 3><<<grid, block, 0, st>>>(VBHEM_ARGS);
  else
    pair_bwd_fwd_kernel<T, 0, 0><<<grid, block, 0, st>>>(VBHEM_ARGS);
#undef VBHEM_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  The caller validates shapes, dtypes,
// contiguity and ranges (Sb, Sr in 1..8, tau >= 1, L*Kr <= 65535), lays
// ell out as [L*Kr, Sb, Sr, Kb] and the base bank with Kb last, and
// allocates every output and the carry scratch.  Returns the cudaError_t
// of the launch (0 = launched).
extern "C" int vbhem_pair_bwd_fwd_f32(const void* ell, const void* prior,
                                      const void* trans, const void* log_pi,
                                      const void* log_a, void* ll_out,
                                      void* nu1_out, void* sxi_out,
                                      void* stn_out, void* carry, int kb,
                                      int lkr, int sb, int sr, int tau,
                                      void* stream) {
  return launch<float>(ell, prior, trans, log_pi, log_a, ll_out, nu1_out,
                       sxi_out, stn_out, carry, kb, lkr, sb, sr, tau, stream);
}

extern "C" int vbhem_pair_bwd_fwd_f64(const void* ell, const void* prior,
                                      const void* trans, const void* log_pi,
                                      const void* log_a, void* ll_out,
                                      void* nu1_out, void* sxi_out,
                                      void* stn_out, void* carry, int kb,
                                      int lkr, int sb, int sr, int tau,
                                      void* stream) {
  return launch<double>(ell, prior, trans, log_pi, log_a, ll_out, nu1_out,
                        sxi_out, stn_out, carry, kb, lkr, sb, sr, tau,
                        stream);
}
