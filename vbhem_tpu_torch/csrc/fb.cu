// The plain C interface of kernel B2 (the VBEM forward-backward, fb.cuh)
// for ctypes.  The kernels themselves are instantiated in fb_entry1_*.cu
// and fb_fused_*.cu.
//
// The caller validates shapes, dtypes, contiguity and ranges (K in 1..8,
// T >= 1, step 0 valid for every sequence, lanes divisible by mask_rep and
// x_rep), picks the design (`rows` = sequences per block of the resident
// design, 0 for the streamed one) and allocates every output.  The mask is
// int32 [Bm, N, mask_words(T)] of bits (bit j of word w for step 32 w + j,
// 16-byte aligned) for the resident design and uint8 [Bm, N, T] for the
// streamed one.  Returns the cudaError_t of the launch (0 = launched).
#include "fb.cuh"

using vbhem_fb::Args;

// Entry 1: the forward-backward of given emission scores log_rho.
extern "C" int vbhem_fb_f32(const void* log_rho, const void* mask,
                            const void* log_pz1, const void* log_trans,
                            void* rho_out, void* gamma, void* xi_out,
                            void* phi_out, long long n_seq, int n, int t_max,
                            int k, int mask_rep, int pz1_per_seq,
                            int trans_per_seq, int rows, void* stream) {
  return vbhem_fb::entry1_f32(
      Args{log_rho, nullptr, mask, log_pz1, log_trans, rho_out, gamma,
           xi_out, phi_out, n_seq, n, t_max, k, 0, mask_rep, 1, pz1_per_seq,
           trans_per_seq, rows, static_cast<cudaStream_t>(stream)});
}

extern "C" int vbhem_fb_f64(const void* log_rho, const void* mask,
                            const void* log_pz1, const void* log_trans,
                            void* rho_out, void* gamma, void* xi_out,
                            void* phi_out, long long n_seq, int n, int t_max,
                            int k, int mask_rep, int pz1_per_seq,
                            int trans_per_seq, int rows, void* stream) {
  return vbhem_fb::entry1_f64(
      Args{log_rho, nullptr, mask, log_pz1, log_trans, rho_out, gamma,
           xi_out, phi_out, n_seq, n, t_max, k, 0, mask_rep, 1, pz1_per_seq,
           trans_per_seq, rows, static_cast<cudaStream_t>(stream)});
}

// The fused E-step: emission scores formed from x [Bx*N, T, D] (D in 1..3)
// and the per-lane constants emis [B, K, 1 + D + D*D] = (c_k, m_k, P_k);
// resident design only (rows > 0).
extern "C" int vbhem_fb_fused_f32(const void* x, const void* emis,
                                  const void* mask, const void* log_pz1,
                                  const void* log_trans, void* rho_out,
                                  void* gamma, void* xi_out, void* phi_out,
                                  long long n_seq, int n, int t_max, int k,
                                  int d, int mask_rep, int x_rep,
                                  int pz1_per_seq, int trans_per_seq, int rows,
                                  void* stream) {
  return vbhem_fb::fused_f32(
      Args{x, emis, mask, log_pz1, log_trans, rho_out, gamma, xi_out,
           phi_out, n_seq, n, t_max, k, d, mask_rep, x_rep, pz1_per_seq,
           trans_per_seq, rows, static_cast<cudaStream_t>(stream)});
}

extern "C" int vbhem_fb_fused_f64(const void* x, const void* emis,
                                  const void* mask, const void* log_pz1,
                                  const void* log_trans, void* rho_out,
                                  void* gamma, void* xi_out, void* phi_out,
                                  long long n_seq, int n, int t_max, int k,
                                  int d, int mask_rep, int x_rep,
                                  int pz1_per_seq, int trans_per_seq, int rows,
                                  void* stream) {
  return vbhem_fb::fused_f64(
      Args{x, emis, mask, log_pz1, log_trans, rho_out, gamma, xi_out,
           phi_out, n_seq, n, t_max, k, d, mask_rep, x_rep, pz1_per_seq,
           trans_per_seq, rows, static_cast<cudaStream_t>(stream)});
}
