// Kernel B2 (the VBEM forward-backward, fb.cuh) for K above 8: the wide
// body of entry 1.
//
// fb.cuh's designs keep a sequence's state vectors, its transition scores
// and its xi accumulator in registers, with K a template parameter (1..8).
// Past that, this body runs the streamed design's arithmetic (`load_px`,
// `predict`, the forward pass normalized per step, the backward pass that
// recomputes c_t) on vectors in device memory: alpha in the gamma output,
// xi in the xi_sum output, and exp(log_trans), px, beta and a scratch
// vector in a workspace [K*K + 3K, B*N] that the wrapper allocates,
// value-major so a warp's accesses fall on consecutive words.  So it takes
// any K whose workspace fits the card's memory.  It is written to be
// right, not fast: one thread per sequence, every value through memory.
// The plain version is `vbhem_tpu_torch/ops/fb.py:forward_backward`.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }
// as fb.cuh's recursion: the hardware's approximation in float32
__device__ __forceinline__ float rexp(float x) { return __expf(x); }
__device__ __forceinline__ double rexp(double x) { return exp(x); }

template <typename T>
struct Vec {
  T* p;
  long long s;
  __device__ __forceinline__ T& operator[](long long q) const {
    return p[q * s];
  }
};

// px[k] = exp(r[k] - max_k r[k]); returns the max
template <typename T>
__device__ __forceinline__ T load_px(const T* __restrict__ r, Vec<T> px,
                                     int k) {
  T mx = r[0];
  for (int q = 1; q < k; ++q) mx = dmax(mx, r[q]);
  for (int q = 0; q < k; ++q) px[q] = rexp(r[q] - mx);
  return mx;
}

// delta[l] = (sum_q alpha[q] A[q][l]) * px[l]; returns c = sum_l delta[l]
// guarded to 1 where it is not positive
template <typename T>
__device__ __forceinline__ T predict(const T* alpha, Vec<T> A, Vec<T> px,
                                     T* delta, long long dstride, int k) {
  T c = 0;
  for (int l = 0; l < k; ++l) {
    T pr = 0;
    for (int q = 0; q < k; ++q) pr += alpha[q] * A[q * k + l];
    delta[l * dstride] = pr * px[l];
    c += delta[l * dstride];
  }
  return c > T(0) ? c : T(1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fb_wide_kernel(const T* __restrict__ log_rho,           // [B*N, T, K]
               const unsigned char* __restrict__ mask,  // [Bm, N, T]
               const T* __restrict__ log_pz1,  // [B, K] or [B*N, K]
               const T* __restrict__ log_trans,
               T* __restrict__ rho_out,                 // [B*N, T, K]
               T* __restrict__ gamma,                   // [B*N, T, K]
               T* __restrict__ xi_out,                  // [B*N, K, K]
               T* __restrict__ phi_out,                 // [B*N]
               T* __restrict__ work,                    // [K*K + 3K, B*N]
               long long n_seq, int n, int t_max, int k, int mask_rep,
               int pz1_per_seq, int trans_per_seq) {
  const long long s =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (s >= n_seq) return;
  const long long b = s / n;
  const long long i = s - b * n;
  const unsigned char* msk = mask + ((b / mask_rep) * n + i) * t_max;
  const T* lp = log_pz1 + (pz1_per_seq ? s : b) * k;
  const T* la = log_trans + (trans_per_seq ? s : b) * k * k;
  const Vec<T> A{work + s, n_seq};
  const Vec<T> px{work + static_cast<long long>(k) * k * n_seq + s, n_seq};
  const Vec<T> beta{px.p + k * n_seq, n_seq};
  const Vec<T> bp{beta.p + k * n_seq, n_seq};
  for (int q = 0; q < k * k; ++q) A[q] = dexp(la[q]);

  const long long row = static_cast<long long>(t_max) * k;
  const T* r = log_rho + s * row;
  T* ro = rho_out + s * row;
  T* g = gamma + s * row;   // alpha_t, then gamma_t

  // ---- forward (vbhmm_fb.m:299-323) ----
  T sum_logc = 0, sum_max = 0;
  for (int t = 0; t < t_max; ++t) {
    const bool on = msk[t] != 0;
    for (int q = 0; q < k; ++q) ro[t * k + q] = on ? r[t * k + q] : T(0);
    if (t == 0) {
      // step 0 is valid for every sequence (the callers check it)
      sum_max = load_px(r, px, k);
      T c = 0;
      for (int q = 0; q < k; ++q) {
        g[q] = dexp(lp[q]) * px[q];
        c += g[q];
      }
      sum_logc = dlog(c);
      for (int q = 0; q < k; ++q) g[q] = g[q] / c;
    } else if (on) {
      const T mx = load_px(r + t * k, px, k);
      const T c = predict(g + (t - 1) * k, A, px, g + t * k, 1, k);
      const T inv_c = T(1) / c;
      for (int q = 0; q < k; ++q) g[t * k + q] *= inv_c;
      sum_logc += dlog(c);
      sum_max += mx;
    } else {   // a padded step carries alpha through
      for (int q = 0; q < k; ++q) g[t * k + q] = g[(t - 1) * k + q];
    }
  }
  phi_out[s] = sum_logc + sum_max;

  // ---- backward (vbhmm_fb.m:325-362): gamma in place, xi_sum ----
  T* xi = xi_out + s * k * k;
  for (int q = 0; q < k; ++q) {
    beta[q] = T(1);
    for (int l = 0; l < k; ++l) xi[q * k + l] = T(0);
  }
  for (int p = t_max - 1; p >= 0; --p) {
    const bool valid = msk[p] != 0;
    for (int q = 0; q < k; ++q)
      g[p * k + q] = valid ? g[p * k + q] * beta[q] : T(0);
    if (p == 0) continue;
    if (valid) {
      const T* alpha = g + (p - 1) * k;
      load_px(r + p * k, px, k);
      // predict's delta into bp, then bp = beta * px
      const T inv_c = T(1) / predict(alpha, A, px, bp.p, n_seq, k);
      for (int l = 0; l < k; ++l) bp[l] = beta[l] * px[l];
      for (int q = 0; q < k; ++q) {
        T e = 0;
        for (int l = 0; l < k; ++l) {
          const T ab = A[q * k + l] * bp[l];
          e += ab;
          xi[q * k + l] += ab * alpha[q] * inv_c;
        }
        beta[q] = e * inv_c;
      }
    } else {
      for (int q = 0; q < k; ++q) beta[q] = T(1);
    }
  }
}

template <typename T>
int launch_wide(const void* log_rho, const void* mask, const void* log_pz1,
                const void* log_trans, void* rho_out, void* gamma,
                void* xi_out, void* phi_out, void* work, long long n_seq,
                int n, int t_max, int k, int mask_rep, int pz1_per_seq,
                int trans_per_seq, void* stream) {
  if (k < 1 || t_max < 1 || n < 1 || n_seq < 1 || mask_rep < 1 ||
      work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n_seq + kThreads - 1) / kThreads));
  fb_wide_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(log_rho), static_cast<const unsigned char*>(mask),
      static_cast<const T*>(log_pz1), static_cast<const T*>(log_trans),
      static_cast<T*>(rho_out), static_cast<T*>(gamma),
      static_cast<T*>(xi_out), static_cast<T*>(phi_out),
      static_cast<T*>(work), n_seq, n, t_max, k, mask_rep, pz1_per_seq,
      trans_per_seq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface for ctypes: entry 1 for K above 8.  The caller
// validates shapes, dtypes and contiguity, checks step 0, lays the mask
// out as uint8 [Bm, N, T] (as for the streamed design) and allocates every
// output and the workspace [K*K + 3K, B*N].  Returns the cudaError_t of
// the launch (0 = launched).
#define VBHEM_FB_WIDE_ENTRY(NAME, T)                                         \
  extern "C" int NAME(const void* log_rho, const void* mask,                 \
                      const void* log_pz1, const void* log_trans,            \
                      void* rho_out, void* gamma, void* xi_out,              \
                      void* phi_out, void* work, long long n_seq, int n,     \
                      int t_max, int k, int mask_rep, int pz1_per_seq,       \
                      int trans_per_seq, void* stream) {                     \
    return launch_wide<T>(log_rho, mask, log_pz1, log_trans, rho_out, gamma, \
                          xi_out, phi_out, work, n_seq, n, t_max, k,         \
                          mask_rep, pz1_per_seq, trans_per_seq, stream);     \
  }

VBHEM_FB_WIDE_ENTRY(vbhem_fb_wide_f32, float)
VBHEM_FB_WIDE_ENTRY(vbhem_fb_wide_f64, double)
