// Scaled forward-backward of the VBEM E-step for NVIDIA Hopper (sm_90a):
// kernel B2 of the port.
//
// Replaces the TPU kernel `_kernel` of vbhem_tpu/ops/fb_pallas.py (launched by
// `forward_backward_pallas`).  For every sequence of a padded batch it runs
// the scaled forward pass (per-step max shift of log_rho, normalizers c_t, a
// padded step carrying alpha through with c = 1), then the backward pass
// (beta reset to ones before a padded successor) that yields gamma [T, K],
// xi_sum [K, K] and phi_norm = sum_t log c_t + sum_t max_k log_rho.  The plain
// PyTorch version is `vbhem_tpu_torch/ops/fb.py:forward_backward`.
//
// What bounds it on this card: bytes.  Per sequence it reads T*K emission
// scores and T mask bytes and writes T*K responsibilities; the arithmetic is
// about T*(K + 1) transcendentals and 3*T*K^2 multiply-adds, far below the
// card's rates at K <= 8.  So the least time is the time to stream log_rho in
// and gamma out once.
//
// The design:
//   * one thread per sequence; K (1..8) is a template parameter, so the
//     state vectors, the transition scores and the xi accumulator live in
//     registers and every loop over states unrolls;
//   * the Pallas kernel keeps alpha and c in VMEM scratch.  Here alpha is
//     written into the gamma output during the forward pass and turned into
//     gamma in place during the backward pass; c_{t+1} is recomputed from
//     alpha_t in the backward pass.  So T needs no scratch at all and the
//     TPU's 8 MiB gate does not carry over;
//   * restart lanes: sequence s = b * N + n belongs to lane b.  Shared initial
//     and transition scores are read per lane ([B, K], [B, K, K]), never
//     broadcast to every sequence; per-sequence ones ([B*N, K], ...) are read
//     per sequence.  The mask [Bm, N, T] is shared by `mask_rep` consecutive
//     lanes (the restarts of one subject), so it is not expanded;
//   * coalescing against the public layout [N, T, K]: sequence-major, so a
//     thread reading its own row would stride T*K elements across the warp
//     (a first version did so, and was several times slower).  A block of
//     128 sequences walks T in chunks of TC steps (TC*K elements make 128
//     bytes); for each chunk it copies the 128 rows' slices of log_rho (and,
//     in the backward pass, of alpha) into shared memory with consecutive
//     threads on consecutive addresses, each thread runs its recursion on
//     its own tile row, and the block writes its alpha / gamma slices back
//     the same way.  Tile rows have an odd length, so the per-thread reads
//     do not collide in shared memory banks;
//   * the backward tile holds one step more in front (alpha_{c0-1}), so the
//     recomputation of c_p from alpha_{p-1} never reaches into the next
//     chunk;
//   * bytes moved: log_rho twice (forward and backward), alpha / gamma three
//     times (written, read back, written), against the two of the bound.
// Templated on float and double; no tuning yet.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }

// px[k] = exp(r[k] - max_k r[k]); returns the max (vbhmm_fb.m:289-291)
template <typename T, int K>
__device__ __forceinline__ T load_px(const T* __restrict__ r, T* px) {
#pragma unroll
  for (int k = 0; k < K; ++k) px[k] = r[k];
  T mx = px[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mx = dmax(mx, px[k]);
#pragma unroll
  for (int k = 0; k < K; ++k) px[k] = dexp(px[k] - mx);
  return mx;
}

// delta[l] = (sum_k alpha[k] A[k][l]) * px[l]; returns c = sum_l delta[l]
// guarded to 1 where it is not positive
template <typename T, int K>
__device__ __forceinline__ T predict(const T* alpha, const T (*A)[K],
                                     const T* px, T* delta) {
  T c = 0;
#pragma unroll
  for (int l = 0; l < K; ++l) {
    T pr = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) pr += alpha[k] * A[k][l];
    delta[l] = pr * px[l];
    c += delta[l];
  }
  return c > T(0) ? c : T(1);
}

// The mask bytes of one chunk of a sequence as a bit set, bit j for step
// c0 + j: the tc loads go out together, off the recursion's critical path.
template <int TC>
__device__ __forceinline__ unsigned chunk_mask(
    const unsigned char* __restrict__ m, int tc) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < TC; ++j)
    if (j < tc && m[j]) bits |= 1u << j;
  return bits;
}

// Chunk geometry of the shared-memory tiles for K states of type T.
template <typename T, int K>
struct Tile {
  static constexpr int kLine = 128 / static_cast<int>(sizeof(T));
  static constexpr int TC = kLine / K > 0 ? kLine / K : 1;  // steps per chunk
  static constexpr int LDR = (TC * K) | 1;        // log_rho tile row, odd
  static constexpr int LDG = ((TC + 1) * K) | 1;  // alpha/gamma row, odd
};

// Copy `len` consecutive elements of each of the block's `rows` sequences,
// starting at element `off` of each sequence's row of `row_len`, into the
// tile at column `col0`: consecutive threads take consecutive addresses.
template <typename T>
__device__ __forceinline__ void tile_in(T* tile, int ld, int col0,
                                        const T* src, long long seq0,
                                        long long row_len, long long off,
                                        int rows, int len) {
  for (int q = threadIdx.x; q < rows * len; q += blockDim.x) {
    const int row = q / len;
    const int e = q - row * len;
    tile[row * ld + col0 + e] = src[(seq0 + row) * row_len + off + e];
  }
}

template <typename T>
__device__ __forceinline__ void tile_out(T* dst, long long seq0,
                                         long long row_len, long long off,
                                         const T* tile, int ld, int col0,
                                         int rows, int len) {
  for (int q = threadIdx.x; q < rows * len; q += blockDim.x) {
    const int row = q / len;
    const int e = q - row * len;
    dst[(seq0 + row) * row_len + off + e] = tile[row * ld + col0 + e];
  }
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
fb_kernel(const T* __restrict__ log_rho,          // [B*N, T, K]
          const unsigned char* __restrict__ mask, // [Bm, N, T], Bm = B / rep
          const T* __restrict__ log_pz1,          // [B, K] or [B*N, K]
          const T* __restrict__ log_trans,        // [B, K, K] or [B*N, K, K]
          T* gamma,                               // [B*N, T, K]
          T* __restrict__ xi_out,                 // [B*N, K, K]
          T* __restrict__ phi_out,                // [B*N]
          long long n_seq, int n, int t_max, int mask_rep, int pz1_per_seq,
          int trans_per_seq) {
  constexpr int TC = Tile<T, K>::TC;
  constexpr int LDR = Tile<T, K>::LDR;
  constexpr int LDG = Tile<T, K>::LDG;
  __shared__ T s_rho[kThreads * LDR];
  __shared__ T s_g[kThreads * LDG];

  const long long seq0 = static_cast<long long>(blockIdx.x) * kThreads;
  const long long s = seq0 + threadIdx.x;
  const bool active = s < n_seq;
  const int rows = static_cast<int>(
      n_seq - seq0 < kThreads ? n_seq - seq0 : kThreads);
  const long long row_len = static_cast<long long>(t_max) * K;
  const T* rho = s_rho + threadIdx.x * LDR;  // this thread's tile rows
  T* g = s_g + threadIdx.x * LDG;

  // this sequence's lane, mask row and scores
  const long long b = active ? s / n : 0;
  const long long i = active ? s - b * n : 0;
  const unsigned char* msk = mask + ((b / mask_rep) * n + i) * t_max;
  T pz1[K], A[K][K];
  const T* p = log_pz1 + (pz1_per_seq ? (active ? s : 0) : b) * K;
  const T* a = log_trans + (trans_per_seq ? (active ? s : 0) : b) * K * K;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pz1[k] = dexp(p[k]);
#pragma unroll
    for (int l = 0; l < K; ++l) A[k][l] = dexp(a[k * K + l]);
  }

  // ---- forward (vbhmm_fb.m:299-323); alpha_t goes to gamma[t] ----
  T alpha[K], px[K], delta[K];
  T sum_logc = 0, sum_max = 0;
  for (int c0 = 0; c0 < t_max; c0 += TC) {
    const int tc = t_max - c0 < TC ? t_max - c0 : TC;
    __syncthreads();  // the previous chunk's tile_out has read s_g
    tile_in(s_rho, LDR, 0, log_rho, seq0, row_len, c0 * K, rows, tc * K);
    __syncthreads();
    if (active) {
      const unsigned valid = chunk_mask<TC>(msk + c0, tc);
      for (int j = 0; j < tc; ++j) {
        const int t = c0 + j;
        if (t == 0) {
          // step 0 is valid for every sequence (the wrapper checks it)
          sum_max = load_px<T, K>(rho, px);
          T c = 0;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            delta[k] = pz1[k] * px[k];
            c += delta[k];
          }
          sum_logc = dlog(c);
#pragma unroll
          for (int k = 0; k < K; ++k) alpha[k] = delta[k] / c;
        } else if (valid >> j & 1u) {
          const T mx = load_px<T, K>(rho + j * K, px);
          const T c = predict<T, K>(alpha, A, px, delta);
          const T inv_c = T(1) / c;
#pragma unroll
          for (int k = 0; k < K; ++k) alpha[k] = delta[k] * inv_c;
          sum_logc += dlog(c);
          sum_max += mx;
        }
        // a padded step carries alpha through
#pragma unroll
        for (int k = 0; k < K; ++k) g[(j + 1) * K + k] = alpha[k];
      }
    }
    __syncthreads();
    tile_out(gamma, seq0, row_len, c0 * K, s_g, LDG, K, rows, tc * K);
  }
  if (active) phi_out[s] = sum_logc + sum_max;

  // ---- backward (vbhmm_fb.m:325-362): gamma in place, xi_sum ----
  // position p sits at tile column j = p - c0 + 1; column 0 holds
  // alpha_{c0-1}
  T beta[K], xi[K][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    beta[k] = T(1);
#pragma unroll
    for (int l = 0; l < K; ++l) xi[k][l] = T(0);
  }
  for (int c0 = ((t_max - 1) / TC) * TC; c0 >= 0; c0 -= TC) {
    const int tc = t_max - c0 < TC ? t_max - c0 : TC;
    __syncthreads();
    tile_in(s_rho, LDR, 0, log_rho, seq0, row_len, c0 * K, rows, tc * K);
    if (c0 > 0)
      tile_in(s_g, LDG, 0, static_cast<const T*>(gamma), seq0, row_len,
              (c0 - 1) * K, rows, (tc + 1) * K);
    else
      tile_in(s_g, LDG, K, static_cast<const T*>(gamma), seq0, row_len, 0,
              rows, tc * K);
    __syncthreads();
    if (active) {
      const unsigned valid_bits = chunk_mask<TC>(msk + c0, tc);
      for (int j = tc; j >= 1; --j) {
        const int pos = c0 + j - 1;
        // beta holds beta_pos: gamma_pos = alpha_pos * beta_pos
        const bool valid = (valid_bits >> (j - 1) & 1u) != 0;
#pragma unroll
        for (int k = 0; k < K; ++k)
          g[j * K + k] = valid ? g[j * K + k] * beta[k] : T(0);
        if (pos == 0) continue;
        if (valid) {
          // beta_{pos-1} and xi_{pos-1 -> pos}, with c_pos recomputed from
          // alpha_{pos-1} as the forward pass computed it
#pragma unroll
          for (int k = 0; k < K; ++k) alpha[k] = g[(j - 1) * K + k];
          load_px<T, K>(rho + (j - 1) * K, px);
          const T inv_c = T(1) / predict<T, K>(alpha, A, px, delta);
          T bp[K];
#pragma unroll
          for (int l = 0; l < K; ++l) bp[l] = beta[l] * px[l];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            T e = 0;
#pragma unroll
            for (int l = 0; l < K; ++l) {
              const T ab = A[k][l] * bp[l];
              e += ab;
              xi[k][l] += ab * alpha[k] * inv_c;
            }
            beta[k] = e * inv_c;
          }
        } else {
          // beta resets to ones before a padded successor
#pragma unroll
          for (int k = 0; k < K; ++k) beta[k] = T(1);
        }
      }
    }
    __syncthreads();
    tile_out(gamma, seq0, row_len, c0 * K, s_g, LDG, K, rows, tc * K);
  }
  if (active) {
    T* xo = xi_out + s * K * K;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int l = 0; l < K; ++l) xo[k * K + l] = xi[k][l];
  }
}

template <typename T>
int launch(const void* log_rho, const void* mask, const void* log_pz1,
           const void* log_trans, void* gamma, void* xi_out, void* phi_out,
           long long n_seq, int n, int t_max, int k, int mask_rep,
           int pz1_per_seq, int trans_per_seq, void* stream) {
  const dim3 grid(static_cast<unsigned>((n_seq + kThreads - 1) / kThreads));
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VBHEM_FB_CASE(KK)                                                    \
  case KK:                                                                   \
    fb_kernel<T, KK><<<grid, block, 0, st>>>(                                \
        static_cast<const T*>(log_rho),                                      \
        static_cast<const unsigned char*>(mask),                             \
        static_cast<const T*>(log_pz1), static_cast<const T*>(log_trans),    \
        static_cast<T*>(gamma), static_cast<T*>(xi_out),                     \
        static_cast<T*>(phi_out), n_seq, n, t_max, mask_rep, pz1_per_seq,    \
        trans_per_seq);                                                      \
    break;
  switch (k) {
    VBHEM_FB_CASE(1)
    VBHEM_FB_CASE(2)
    VBHEM_FB_CASE(3)
    VBHEM_FB_CASE(4)
    VBHEM_FB_CASE(5)
    VBHEM_FB_CASE(6)
    VBHEM_FB_CASE(7)
    VBHEM_FB_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VBHEM_FB_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes.  The caller validates shapes, dtypes,
// contiguity and ranges (K in 1..8, T >= 1, step 0 valid for every
// sequence, B divisible by mask_rep) and allocates every output.  Returns
// the cudaError_t of the launch (0 = launched).
extern "C" int vbhem_fb_f32(const void* log_rho, const void* mask,
                            const void* log_pz1, const void* log_trans,
                            void* gamma, void* xi_out, void* phi_out,
                            long long n_seq, int n, int t_max, int k,
                            int mask_rep, int pz1_per_seq, int trans_per_seq,
                            void* stream) {
  return launch<float>(log_rho, mask, log_pz1, log_trans, gamma, xi_out,
                       phi_out, n_seq, n, t_max, k, mask_rep, pz1_per_seq,
                       trans_per_seq, stream);
}

extern "C" int vbhem_fb_f64(const void* log_rho, const void* mask,
                            const void* log_pz1, const void* log_trans,
                            void* gamma, void* xi_out, void* phi_out,
                            long long n_seq, int n, int t_max, int k,
                            int mask_rep, int pz1_per_seq, int trans_per_seq,
                            void* stream) {
  return launch<double>(log_rho, mask, log_pz1, log_trans, gamma, xi_out,
                        phi_out, n_seq, n, t_max, k, mask_rep, pz1_per_seq,
                        trans_per_seq, stream);
}
