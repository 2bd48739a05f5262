// The EM of the GMM starts for NVIDIA Hopper (sm_90a): `_em_to_tol` of
// `vbhem_tpu_torch/ops/gmm.py`, the full-covariance GMM EM that the VBEM
// 'random' and 'split' starts and the VBHEM 'random' initializer's
// per-cluster pools run to a relative log-likelihood tolerance, each
// restart lane's whole EM looped on chip.
//
// Replaces no TPU kernel: the JAX package's `vbhem_tpu/ops/gmm.py` is plain
// jnp under XLA.  It was added because the plain PyTorch version ran the
// bank's starts as tensors of [subjects, lanes, points, K(, D)]: at 8192
// subjects x 20 restarts x 1250 points x K = 2 some 4.1e8 elements, 1.6 GB
// a float32 tensor, 20-30 elementwise passes an EM iteration, up to 100
// iterations and a host sync on each; the starts were 68% of the bank job
// and 71% of the face VBEM job on the H100.
//
// What bounds it on this card: operations.  An EM iteration is, for each
// (lane, point, component), a difference, a quadratic form with the
// closed-form inverse and the six moment sums (about 20 FMAs) and one exp,
// and a log for each (lane, point): at the bank's shape 8e9 flops and 6e8
// special functions, 0.15-0.3 ms.  The points are few (1250 of D = 2 a
// subject, 10 KB in float32) and every restart lane of a subject reads
// them, so device memory is no limit once they are read once a block and
// kept on chip.  The design:
//   * a block serves one data row (a subject, or a VBHEM pool) and a run of
//     its restart lanes, one warp a lane; a row with more lanes than a
//     block's warps takes several blocks;
//   * the row's weighted mean point is summed by warp 0 in a fixed order,
//     and the row's points of nonzero weight, centered at it, are staged
//     once in shared memory with their weights, in their order (a point of
//     weight 0 adds exactly nothing in the plain version: its
//     responsibilities and its log-likelihood are multiplied by 0); a row
//     whose points outgrow shared memory is read from device memory
//     instead, its points of weight 0 skipped as they come;
//   * each warp runs its lane's EM to the plain version's stop rule (at
//     least two iterations, then a relative log-likelihood change of at
//     most tol, or max_iter) and leaves its loop; nothing waits on the host
//     until the launch ends;
//   * a thread takes every 32nd staged point and keeps its lane's
//     components (means, inverses, log-determinants, log-weights) and its
//     K (1 + D + D (D + 1) / 2) moment sums in registers; the sums are
//     reduced by a butterfly over the warp (every lane ends with the same
//     bits), with no float atomics, so a lane's answer is a function of its
//     own start and data alone, whatever the block layout;
//   * the arithmetic is the plain version's: moments about the row's mean
//     point, cov = (m2 - mean mean^T) + ridge, the weights' log floor, the
//     closed-form inverse and log-determinant for D <= 3 and Cholesky for
//     D = 4.  A component that the plain version turns NaN turns NaN here
//     (the plain version's Cholesky raises where a D = 4 covariance is not
//     positive definite; here that lane turns NaN, and the wrapper,
//     `ops/gmm_cuda.py`, raises on a NaN lane at D = 4).
// Templated on float and double, K = 1..8 and D = 1..4; the wrapper
// (`ops/gmm_cuda.py`) refuses a larger K or D on the card.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr double kLog2Pi = 1.8378770664093453;

template <typename T>
struct Limits;
template <>
struct Limits<float> {
  static __device__ __forceinline__ float max() { return FLT_MAX; }
};
template <>
struct Limits<double> {
  static __device__ __forceinline__ double max() { return DBL_MAX; }
};

// Entries of the upper triangle of a symmetric D x D matrix, row by row.
template <int D>
struct Tri {
  static constexpr int N = D * (D + 1) / 2;
};
__host__ __device__ constexpr int tri(int d, int e, int D) {
  return d * D - d * (d - 1) / 2 + (e - d);
}

// a * b rounded, never fused into a following add: the covariance
// m2 - mean mean^T and the closed forms' determinants then cancel as the
// plain version's do (a component on one point comes out exactly 0 +
// ridge, not a product's rounding residue that can leave it indefinite in
// float32)
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// The inverse p (upper triangle) and the log-determinant of the symmetric
// matrix a (upper triangle): the closed forms of `utils/numeric.py`'s
// inv_psd and logdet_psd for D <= 3, Cholesky for D = 4.
template <typename T, int D>
__device__ __forceinline__ void invert(const T (&a)[Tri<D>::N],
                                       T (&p)[Tri<D>::N], T& logdet) {
  if constexpr (D == 1) {
    p[0] = T(1) / a[0];
    logdet = log(a[0]);
  } else if constexpr (D == 2) {
    const T a00 = a[0], a01 = a[1], a11 = a[2];
    const T det = mul_rn(a00, a11) - mul_rn(a01, a01);
    p[0] = a11 / det;
    p[1] = -a01 / det;
    p[2] = a00 / det;
    logdet = log(det);
  } else if constexpr (D == 3) {
    const T a00 = a[0], a01 = a[1], a02 = a[2];
    const T a11 = a[3], a12 = a[4], a22 = a[5];
    const T c00 = mul_rn(a11, a22) - mul_rn(a12, a12);
    const T c01 = mul_rn(a02, a12) - mul_rn(a01, a22);
    const T c02 = mul_rn(a01, a12) - mul_rn(a02, a11);
    const T c11 = mul_rn(a00, a22) - mul_rn(a02, a02);
    const T c12 = mul_rn(a01, a02) - mul_rn(a00, a12);
    const T c22 = mul_rn(a00, a11) - mul_rn(a01, a01);
    const T det = mul_rn(a00, c00) + mul_rn(a01, c01) + mul_rn(a02, c02);
    p[0] = c00 / det;
    p[1] = c01 / det;
    p[2] = c02 / det;
    p[3] = c11 / det;
    p[4] = c12 / det;
    p[5] = c22 / det;
    logdet = log(det);
  } else {
    // a = L L^T; p = L^-T L^-1
    T l[D][D], li[D][D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T s = a[tri(j, j, D)];
#pragma unroll
      for (int q = 0; q < j; ++q) s -= l[j][q] * l[j][q];
      l[j][j] = sqrt(s);
#pragma unroll
      for (int i = j + 1; i < D; ++i) {
        T t = a[tri(j, i, D)];
#pragma unroll
        for (int q = 0; q < j; ++q) t -= l[i][q] * l[j][q];
        l[i][j] = t / l[j][j];
      }
    }
    logdet = T(0);
#pragma unroll
    for (int j = 0; j < D; ++j) logdet += log(l[j][j]);
    logdet = T(2) * logdet;
#pragma unroll
    for (int j = 0; j < D; ++j) {
      li[j][j] = T(1) / l[j][j];
#pragma unroll
      for (int i = j + 1; i < D; ++i) {
        T t = T(0);
#pragma unroll
        for (int q = j; q < i; ++q) t -= l[i][q] * li[q][j];
        li[i][j] = t / l[i][i];
      }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int e = d; e < D; ++e) {
        T t = T(0);
#pragma unroll
        for (int q = e; q < D; ++q) t += li[q][d] * li[q][e];
        p[tri(d, e, D)] = t;
      }
    }
  }
}

struct Args {
  const void* x;        // [rows or 1, M, D]
  long long x_stride;   // M D, or 0 where the rows share x
  const void* w;        // [rows or 1, M]
  long long w_stride;   // M, or 0
  const void* ridge;    // [rows or 1, D, D]
  long long ridge_stride;
  void* weight;         // [rows, per_row, K], the start in, the fit out
  void* mean;           // [rows, per_row, K, D]
  void* cov;            // [rows, per_row, K, D, D]
  void* iters;          // int32 [rows, per_row]
  int rows, per_row, m, warps, staged, max_iter;
  double tol, log_floor;
  cudaStream_t stream;
};

template <typename T, int K, int D>
__global__ void __launch_bounds__(kMaxWarps * 32)
gmm_em_kernel(const T* __restrict__ x, long long x_stride,
              const T* __restrict__ w, long long w_stride,
              const T* __restrict__ ridge, long long ridge_stride,
              T* __restrict__ weight, T* __restrict__ mean,
              T* __restrict__ cov, int* __restrict__ iters, int per_row,
              int m, int staged, int max_iter, T tol, T log_floor) {
  constexpr int N = Tri<D>::N;
  extern __shared__ __align__(16) unsigned char s_raw[];
  __shared__ T s_c[D];
  __shared__ int s_cnt[kMaxWarps];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blocks_per_row = (per_row + warps - 1) / warps;
  const int row = blockIdx.x / blocks_per_row;
  const int p = (blockIdx.x % blocks_per_row) * warps + warp;
  const T* __restrict__ xr = x + row * x_stride;
  const T* __restrict__ wr = w + row * w_stride;

  // the row's weighted mean point, summed by warp 0 in a fixed order
  if (warp == 0) {
    T sw = T(0), sx[D];
#pragma unroll
    for (int d = 0; d < D; ++d) sx[d] = T(0);
    for (int i = lane; i < m; i += 32) {
      const T wi = wr[i];
      sw += wi;
#pragma unroll
      for (int d = 0; d < D; ++d)
        sx[d] += wi * xr[static_cast<size_t>(i) * D + d];
    }
    sw = warp_sum(sw);
#pragma unroll
    for (int d = 0; d < D; ++d) sx[d] = warp_sum(sx[d]);
    if (lane == 0) {
#pragma unroll
      for (int d = 0; d < D; ++d) s_c[d] = sx[d] / sw;
    }
  }
  __syncthreads();
  T c[D];
#pragma unroll
  for (int d = 0; d < D; ++d) c[d] = s_c[d];

  // the points of nonzero weight, centered, in their order: s_w [M] and
  // s_x [D][M] in shared memory
  T* s_w = reinterpret_cast<T*>(s_raw);
  T* s_x = s_w + m;
  int n_pts = m;
  if (staged) {
    int out = 0;
    for (int base = 0; base < m; base += blockDim.x) {
      const int i = base + threadIdx.x;
      const T wi = i < m ? wr[i] : T(0);
      const bool keep = i < m && wi != T(0);
      const unsigned bal = __ballot_sync(kFull, keep);
      if (lane == 0) s_cnt[warp] = __popc(bal);
      __syncthreads();
      int at = out, total = 0;
      for (int q = 0; q < warps; ++q) {
        if (q < warp) at += s_cnt[q];
        total += s_cnt[q];
      }
      if (keep) {
        at += __popc(bal & ((1u << lane) - 1u));
        s_w[at] = wi;
#pragma unroll
        for (int d = 0; d < D; ++d)
          s_x[d * m + at] = xr[static_cast<size_t>(i) * D + d] - c[d];
      }
      out += total;
      __syncthreads();
    }
    n_pts = out;
  }
  if (p >= per_row) return;   // no block-wide sync after this point

  const size_t ln = static_cast<size_t>(row) * per_row + p;
  T* __restrict__ wt = weight + ln * K;
  T* __restrict__ mu_out = mean + ln * K * D;
  T* __restrict__ cv = cov + ln * K * D * D;
  T rg[N];
  {
    const T* __restrict__ rr = ridge + row * ridge_stride;
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int e = d; e < D; ++e) rg[tri(d, e, D)] = rr[d * D + e];
    }
  }
  // the start: the means shifted by the row's mean point; the covariances
  // as the plain version's inverse reads them (symmetrized for D <= 3, the
  // lower triangle for D = 4's Cholesky)
  T mu[K][D], pr[K][N], h[K], lw[K];
  T wk[K], cvk[K][N];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    wk[k] = wt[k];
#pragma unroll
    for (int d = 0; d < D; ++d) mu[k][d] = mu_out[k * D + d] - c[d];
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int e = d; e < D; ++e) {
        const T lo = cv[(k * D + e) * D + d];
        cvk[k][tri(d, e, D)] =
            D == 4 || d == e ? lo : T(0.5) * (cv[(k * D + d) * D + e] + lo);
      }
    }
  }
  const T hd = static_cast<T>(D * kLog2Pi);
  T ll = -Limits<T>::max(), last = -Limits<T>::max();
  int it = 0;
  while (true) {
    const T denom = last == T(0) ? T(1) : last;
    const bool not_conv = fabs((ll - last) / denom) > tol;
    if (!(it < max_iter && (it < 2 || not_conv))) break;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T logdet;
      invert<T, D>(cvk[k], pr[k], logdet);
      h[k] = logdet + hd;
      lw[k] = log(wk[k] + log_floor);
    }
    // E-step and the M-step's sums over this thread's points
    T acc_n[K], acc_x[K][D], acc_xx[K][N], acc_ll = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc_n[k] = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) acc_x[k][d] = T(0);
#pragma unroll
      for (int n = 0; n < N; ++n) acc_xx[k][n] = T(0);
    }
    for (int i = lane; i < n_pts; i += 32) {
      T wi, xi[D];
      if (staged) {
        wi = s_w[i];
#pragma unroll
        for (int d = 0; d < D; ++d) xi[d] = s_x[d * m + i];
      } else {
        wi = wr[i];
        if (wi == T(0)) continue;
#pragma unroll
        for (int d = 0; d < D; ++d)
          xi[d] = xr[static_cast<size_t>(i) * D + d] - c[d];
      }
      T lp[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        T df[D];
#pragma unroll
        for (int d = 0; d < D; ++d) df[d] = xi[d] - mu[k][d];
        T q = T(0);
#pragma unroll
        for (int d = 0; d < D; ++d) {
          q += df[d] * pr[k][tri(d, d, D)] * df[d];
#pragma unroll
          for (int e = d + 1; e < D; ++e)
            q += T(2) * df[d] * pr[k][tri(d, e, D)] * df[e];
        }
        lp[k] = T(-0.5) * (q + h[k]) + lw[k];
      }
      // log-sum-exp with the plain version's guard: the shift is 0 where
      // the largest term is not finite; a NaN term wins the max
      T mx = lp[0];
#pragma unroll
      for (int k = 1; k < K; ++k)
        mx = (isnan(lp[k]) || lp[k] > mx) ? lp[k] : mx;
      if (!isfinite(mx)) mx = T(0);
      T ex[K], s = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ex[k] = exp(lp[k] - mx);
        s += ex[k];
      }
      acc_ll += (log(s) + mx) * wi;
      const T f = wi / s;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T r = ex[k] * f;
        acc_n[k] += r;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const T rx = r * xi[d];
          acc_x[k][d] += rx;
#pragma unroll
          for (int e = d; e < D; ++e) acc_xx[k][tri(d, e, D)] += rx * xi[e];
        }
      }
    }
    acc_ll = warp_sum(acc_ll);
    // M-step: every thread forms the same components from the same sums
    T tot = T(0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T nk = warp_sum(acc_n[k]) + T(1e-30);
      acc_n[k] = nk;
      tot += nk;
#pragma unroll
      for (int d = 0; d < D; ++d) mu[k][d] = warp_sum(acc_x[k][d]) / nk;
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int e = d; e < D; ++e) {
          const int n = tri(d, e, D);
          cvk[k][n] = (warp_sum(acc_xx[k][n]) / nk -
                       mul_rn(mu[k][d], mu[k][e])) + rg[n];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) wk[k] = acc_n[k] / tot;
    last = ll;
    ll = acc_ll;
    ++it;
  }
  if (lane == 0) {
    iters[ln] = it;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int d = 0; d < D; ++d) mu_out[k * D + d] = mu[k][d] + c[d];
    }
    if (it > 0) {   // with no iteration the start's weights and
                    // covariances stand as they came
#pragma unroll
      for (int k = 0; k < K; ++k) {
        wt[k] = wk[k];
#pragma unroll
        for (int d = 0; d < D; ++d) {
#pragma unroll
          for (int e = 0; e < D; ++e)
            cv[(k * D + d) * D + e] =
                cvk[k][d <= e ? tri(d, e, D) : tri(e, d, D)];
        }
      }
    }
  }
}

template <typename T, int K, int D>
int launch(const Args& a) {
  auto* kernel = gmm_em_kernel<T, K, D>;
  const size_t smem =
      a.staged ? static_cast<size_t>(a.m) * (D + 1) * sizeof(T) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      static_cast<long long>(a.rows) * ((a.per_row + a.warps - 1) / a.warps);
  kernel<<<static_cast<unsigned>(blocks), a.warps * 32, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.x_stride, static_cast<const T*>(a.w),
      a.w_stride, static_cast<const T*>(a.ridge), a.ridge_stride,
      static_cast<T*>(a.weight), static_cast<T*>(a.mean),
      static_cast<T*>(a.cov), static_cast<int*>(a.iters), a.per_row, a.m,
      a.staged, a.max_iter, static_cast<T>(a.tol),
      static_cast<T>(a.log_floor));
  return static_cast<int>(cudaGetLastError());
}

// launch<T, K, D>(a) for the runtime K in 1..8 and D in 1..4.
template <typename T>
int dispatch(const Args& a, int k, int d) {
  if (d < 1 || d > 4 || a.warps < 1 || a.warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
#define VBHEM_GMM_K(KK)                       \
  case KK:                                    \
    switch (d) {                              \
      case 1: return launch<T, KK, 1>(a);     \
      case 2: return launch<T, KK, 2>(a);     \
      case 3: return launch<T, KK, 3>(a);     \
      default: return launch<T, KK, 4>(a);    \
    }
  switch (k) {
    VBHEM_GMM_K(1)
    VBHEM_GMM_K(2)
    VBHEM_GMM_K(3)
    VBHEM_GMM_K(4)
    VBHEM_GMM_K(5)
    VBHEM_GMM_K(6)
    VBHEM_GMM_K(7)
    VBHEM_GMM_K(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VBHEM_GMM_K
}

}  // namespace

// Plain C interface for ctypes.  The caller validates dtypes, devices,
// shapes, contiguity and ranges (K in 1..8, D in 1..4, 1..8 warps a block,
// at least one row, lane and point), copies the start into weight, mean
// and cov, which the kernel overwrites with the fit, and sets staged only
// where M (D + 1) values fit in a block's shared memory.  Returns the
// cudaError_t of the launch (0 = launched; cudaErrorInvalidValue for a K,
// D or warp count the kernel does not take).
#define VBHEM_GMM_ENTRY(SUFFIX, T)                                            \
  extern "C" int vbhem_gmm_em_##SUFFIX(                                       \
      const void* x, long long x_stride, const void* w, long long w_stride,   \
      const void* ridge, long long ridge_stride, void* weight, void* mean,    \
      void* cov, void* iters, int rows, int per_row, int m, int k, int d,     \
      int warps, int staged, int max_iter, double tol, double log_floor,      \
      void* stream) {                                                         \
    const Args a{x,     x_stride, w,       w_stride, ridge,                   \
                 ridge_stride,    weight,  mean,     cov,                     \
                 iters, rows,     per_row, m,        warps,                   \
                 staged,          max_iter, tol,     log_floor,               \
                 static_cast<cudaStream_t>(stream)};                          \
    return dispatch<T>(a, k, d);                                              \
  }

VBHEM_GMM_ENTRY(f32, float)
VBHEM_GMM_ENTRY(f64, double)
