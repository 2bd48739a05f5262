// The k-means of the VBHEM 'wtkmeans' start for NVIDIA Hopper (sm_90a):
// weighted Lloyd k-means and the energy-adjusted weighted k-means of
// `my_weighted_kmeans.m`, each lane's whole run in one block, its
// iterations looped on chip.
//
// Replaces no TPU kernel: the JAX package's `vbhem_tpu/ops/kmeans.py` is
// plain jnp under XLA.  It was added because the plain PyTorch version
// (`vbhem_tpu_torch/ops/kmeans.py`: `kmeans`, `weighted_kmeans_energy`) ran
// the face demo's wtkmeans start (750 lanes, Kr = 5, Sr = 3, over 8192 x 3
// pooled states) as some 19,000 launches a job: a GEMM of inner dimension
// D = 2 for the distances, an int64 one-hot times x for the centers, 100
// fixed Lloyd iterations and a host sync on every energy move; the start
// was 75% of the face job on the H100.
//
// What bounds it on this card: operations over points that every lane
// shares and that stay in L2 (8192 x 3 states of D = 2 are 196 KB in
// float32).  A Lloyd iteration is K distances of D terms, an argmin and
// K (1 + D) predicated sums a point; the energy move adds K divisions a
// point.  The design:
//   * one block of 256 threads a lane (a (lane, cluster) pair for the
//     per-cluster k-means, whose weights are that cluster's), each thread
//     a fixed stripe of the points, so
//     the block walks the M points once an iteration with no launch and
//     no host round trip between iterations;
//   * distances direct, sum over d of (x - c)^2 (not the expansion
//     |x|^2 - 2 x.c + |c|^2, which cancels in float32 at image
//     coordinates), and the argmin's tie rule of torch.argmin (the first
//     NaN, else the first minimum);
//   * each cluster's weighted mass and sum kept in registers, summed over
//     the block in a fixed order (a butterfly in each warp, then the warps
//     in order; no float atomics), so an iteration's centers are a
//     function of the assignment alone: a lane whose centers come back
//     unchanged bit for bit is at its fixed point (every later iteration
//     returns the same centers) and leaves its loop;
//   * the energy k-means keeps each point's assignment in shared memory,
//     one byte a point (the current move's in one nibble, the next move's
//     in the other; in a device-memory workspace where the points
//     outgrow shared memory), and forms the current state's energy and
//     the next state's centroid sums in one pass, so a move is one walk
//     over the points and the host reads nothing until the end.
// Templated on float and double, K = 1..8 and D = 1..4.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 8;

// torch.argmin's order (ATen's LessOrNan): scanning candidates in index
// order, v replaces the best so far if it is NaN and the best is not, or
// if neither is NaN and v is smaller; so the first NaN, else the first
// minimum.
template <typename T>
__device__ __forceinline__ bool takes(T v, T best) {
  return isnan(v) ? !isnan(best) : v < best;
}

// torch.clamp_min(v, lo): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_min(T v, T lo) {
  return v < lo ? lo : v;
}

template <typename T, int D>
__device__ __forceinline__ T sq_dist(const T (&x)[D], const T (&c)[D]) {
  T s = T(0);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const T e = x[d] - c[d];
    s += e * e;
  }
  return s;
}

template <typename T, int K, int D>
__device__ __forceinline__ int nearest(const T (&x)[D], const T (&c)[K][D]) {
  int best = 0;
  T bd = sq_dist<T, D>(x, c[0]);
#pragma unroll
  for (int k = 1; k < K; ++k) {
    const T s = sq_dist<T, D>(x, c[k]);
    if (takes(s, bd)) {
      bd = s;
      best = k;
    }
  }
  return best;
}

template <typename T, int D>
__device__ __forceinline__ void load_point(const T* __restrict__ x, int i,
                                           T (&xi)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) xi[d] = x[static_cast<size_t>(i) * D + d];
}

// Adds point x of weight w to cluster a's mass acc[off + k] and sums
// acc[off + K + k * D + d], predicated over k so the arrays stay in
// registers.
template <typename T, int K, int D, int N>
__device__ __forceinline__ void accumulate(T (&acc)[N], int off, int a, T w,
                                           const T (&x)[D]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const T wk = a == k ? w : T(0);
    acc[off + k] += wk;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[off + K + k * D + d] += wk * x[d];
  }
}

// Sums v over the block in a fixed order: a butterfly in each warp (every
// lane ends with the same bits, since a + b == b + a), then the warps'
// sums in warp order.  Every thread gets the totals back in v.
template <typename T, int N>
__device__ void block_sum(T (&v)[N], T* s_red, T* s_tot) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) v[n] += __shfl_xor_sync(kFull, v[n], off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) s_red[warp * N + n] = v[n];
  }
  __syncthreads();
  for (int n = threadIdx.x; n < N; n += kThreads) {
    T s = s_red[n];
    for (int w = 1; w < kWarps; ++w) s += s_red[w * N + n];
    s_tot[n] = s;
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = s_tot[n];
}

template <typename T, int K, int D>
__device__ __forceinline__ void load_centers(const T* __restrict__ c0,
                                             int lane, T (&c)[K][D]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int d = 0; d < D; ++d)
      c[k][d] = c0[(static_cast<size_t>(lane) * K + k) * D + d];
  }
}

template <typename T, int K, int D>
__device__ __forceinline__ void store_centers(T* __restrict__ out, int lane,
                                              const T (&c)[K][D]) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        out[(static_cast<size_t>(lane) * K + k) * D + d] = c[k][d];
    }
  }
}

// Weighted Lloyd k-means of x [M, D] into K centers under the weights w
// [n, M] (w_stride M) or [M] (w_stride 0), one lane a block: up to
// max_iter iterations, leaving the loop after an iteration that returns
// every center unchanged.  An empty cluster keeps its center; a point of
// weight 0 carries no mass.  The lane's assignment to its final centers
// is written to assign [n, M].
template <typename T, int K, int D>
__global__ void __launch_bounds__(kThreads)
lloyd_kernel(const T* __restrict__ x, const T* __restrict__ w,
             long long w_stride, const T* __restrict__ c0,
             long long* __restrict__ assign, T* __restrict__ c_out,
             int* __restrict__ iters, int m, int max_iter) {
  constexpr int N = K * (1 + D);   // mass[K], then sum[K][D]
  __shared__ T s_red[kWarps * N];
  __shared__ T s_tot[N];
  const int b = blockIdx.x;
  const T* __restrict__ wl = w + b * w_stride;

  T c[K][D];
  load_centers<T, K, D>(c0, b, c);
  int it = 0;
  while (it < max_iter) {
    T acc[N];
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = T(0);
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const T wi = wl[i];
      if (wi == T(0)) continue;
      T xi[D];
      load_point<T, D>(x, i, xi);
      accumulate<T, K, D>(acc, 0, nearest<T, K, D>(xi, c), wi, xi);
    }
    block_sum<T, N>(acc, s_red, s_tot);
    // every thread forms the same centers from the same totals, so the
    // exit below is uniform
    bool changed = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T mass = acc[k];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const T nc = mass > T(0)
                         ? acc[K + k * D + d] / clamp_min(mass, T(1e-30))
                         : c[k][d];
        changed |= !(nc == c[k][d]);
        c[k][d] = nc;
      }
    }
    ++it;
    if (!changed) break;
  }
  if (threadIdx.x == 0) iters[b] = it;
  store_centers<T, K, D>(c_out, b, c);
  for (int i = threadIdx.x; i < m; i += kThreads) {
    T xi[D];
    load_point<T, D>(x, i, xi);
    assign[static_cast<size_t>(b) * m + i] = nearest<T, K, D>(xi, c);
  }
}

// The energy-adjusted weighted k-means of `my_weighted_kmeans.m` of x
// [M, D] under the point weights w [M], one lane a block: the points go
// to their nearest seed, then every point moves to its cheapest cluster
// (a member of cluster j costs d2 w_j / (w_j - w_i), or +inf where
// w_j - w_i <= 0; a non-member d2 w_j / (w_j + w_i)) until the total
// energy changes by less than tol or max_iter moves have run.  An empty
// cluster gets a zero center.  Pass k reads state k (the assignment in
// nibble k % 2 of s_a, the centers and masses in registers), sums its
// energy and writes move k's assignment into the other nibble with the
// next state's centroid sums; the stop test then reads the energy of
// state k, as the plain version's loop does before it moves.  s_a is the
// block's dynamic shared memory, or row b of the workspace ws [n, M]
// where ws is given (M too large for shared memory).
template <typename T, int K, int D>
__global__ void __launch_bounds__(kThreads)
energy_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const T* __restrict__ c0, long long* __restrict__ assign,
              T* __restrict__ c_out, int* __restrict__ moves,
              unsigned char* __restrict__ ws, int m, int max_iter, T tol,
              T tol2) {
  constexpr int N = 1 + K * (1 + D);   // energy, mass[K], sum[K][D]
  __shared__ T s_red[kWarps * N];
  __shared__ T s_tot[N];
  extern __shared__ unsigned char s_dyn[];
  const int b = blockIdx.x;
  unsigned char* s_a =
      ws != nullptr ? ws + static_cast<size_t>(b) * m : s_dyn;   // [M]
  const T inf = static_cast<T>(INFINITY);

  T c[K][D];
  load_centers<T, K, D>(c0, b, c);
  T acc[N];
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = T(0);
  for (int i = threadIdx.x; i < m; i += kThreads) {
    T xi[D];
    load_point<T, D>(x, i, xi);
    const int a = nearest<T, K, D>(xi, c);
    s_a[i] = static_cast<unsigned char>(a);
    accumulate<T, K, D>(acc, 1, a, w[i], xi);
  }
  block_sum<T, N>(acc, s_red, s_tot);

  T wc[K];
  int k = 0, par = 0;
  T e_old = T(0);
  while (true) {
#pragma unroll
    for (int q = 0; q < K; ++q) {
      wc[q] = acc[1 + q];
#pragma unroll
      for (int d = 0; d < D; ++d)
        c[q][d] = acc[1 + K + q * D + d] / clamp_min(wc[q], T(1e-30));
    }
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = T(0);
    const int shift = 4 * par;
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int cur = (s_a[i] >> shift) & 15;
      const T wi = w[i];
      T xi[D];
      load_point<T, D>(x, i, xi);
      int nxt = 0;
      T best = T(0), own = T(0);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const T num = sq_dist<T, D>(xi, c[j]) * wc[j];
        T f;
        if (j == cur) {
          const T den = wc[j] - wi;
          f = den > T(0) ? num / den : inf;
          own = f;
        } else {
          f = num / (wc[j] + wi);
        }
        if (j == 0 || takes(f, best)) {
          best = f;
          nxt = j;
        }
      }
      if (isfinite(own)) acc[0] += wi * own;
      s_a[i] = static_cast<unsigned char>(par ? (nxt | (cur << 4))
                                              : (cur | (nxt << 4)));
      accumulate<T, K, D>(acc, 1, nxt, wi, xi);
    }
    block_sum<T, N>(acc, s_red, s_tot);
    const T e = acc[0];
    if (k == 0) e_old = (e + tol2) + T(1);
    if (!(k < max_iter && fabs(e - e_old) >= tol)) break;
    e_old = e;
    ++k;
    par ^= 1;
  }
  // state k: the centers in c, the assignment in nibble par
  if (threadIdx.x == 0) moves[b] = k;
  store_centers<T, K, D>(c_out, b, c);
  for (int i = threadIdx.x; i < m; i += kThreads)
    assign[static_cast<size_t>(b) * m + i] = (s_a[i] >> (4 * par)) & 15;
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

struct LloydArgs {
  const void* x;
  const void* w;
  long long w_stride;
  const void* c0;
  void* assign;
  void* c_out;
  void* iters;
  int n, m, max_iter;
  cudaStream_t stream;
};

template <typename T, int K, int D>
int launch_lloyd(const LloydArgs& a) {
  lloyd_kernel<T, K, D><<<a.n, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w), a.w_stride,
      static_cast<const T*>(a.c0), static_cast<long long*>(a.assign),
      static_cast<T*>(a.c_out), static_cast<int*>(a.iters), a.m,
      a.max_iter);
  return static_cast<int>(cudaGetLastError());
}

struct EnergyArgs {
  const void* x;
  const void* w;
  const void* c0;
  void* assign;
  void* c_out;
  void* moves;
  void* ws;
  int n, m, max_iter;
  double tol;
  cudaStream_t stream;
};

template <typename T, int K, int D>
int launch_energy(const EnergyArgs& a) {
  auto* kernel = energy_kernel<T, K, D>;
  const size_t smem = a.ws != nullptr ? 0 : static_cast<size_t>(a.m);
  const int err = set_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<a.n, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.w),
      static_cast<const T*>(a.c0), static_cast<long long*>(a.assign),
      static_cast<T*>(a.c_out), static_cast<int*>(a.moves),
      static_cast<unsigned char*>(a.ws), a.m, a.max_iter,
      static_cast<T>(a.tol), static_cast<T>(2.0 * a.tol));
  return static_cast<int>(cudaGetLastError());
}

// Calls F<T, K, D>(args) for the runtime K in 1..kMaxK and D in 1..4.
template <typename T, template <typename, int, int> class F, typename A>
int dispatch(const A& a, int k, int d) {
  if (d < 1 || d > 4) return static_cast<int>(cudaErrorInvalidValue);
#define VBHEM_KMEANS_K(KK)                                           \
  case KK:                                                           \
    switch (d) {                                                     \
      case 1: return F<T, KK, 1>::run(a);                            \
      case 2: return F<T, KK, 2>::run(a);                            \
      case 3: return F<T, KK, 3>::run(a);                            \
      default: return F<T, KK, 4>::run(a);                           \
    }
  switch (k) {
    VBHEM_KMEANS_K(1)
    VBHEM_KMEANS_K(2)
    VBHEM_KMEANS_K(3)
    VBHEM_KMEANS_K(4)
    VBHEM_KMEANS_K(5)
    VBHEM_KMEANS_K(6)
    VBHEM_KMEANS_K(7)
    VBHEM_KMEANS_K(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VBHEM_KMEANS_K
}

template <typename T, int K, int D>
struct Lloyd {
  static int run(const LloydArgs& a) { return launch_lloyd<T, K, D>(a); }
};

template <typename T, int K, int D>
struct Energy {
  static int run(const EnergyArgs& a) { return launch_energy<T, K, D>(a); }
};

static_assert(kMaxK <= 15, "the energy kernel keeps an assignment a nibble");

}  // namespace

// Plain C interface for ctypes.  The caller validates dtypes, devices,
// shapes, contiguity and ranges (K in 1..8, D in 1..4, n >= 1 lanes,
// M >= 1) and allocates every output, and the energy k-means' workspace
// ws (uint8 [n, M]) where M bytes exceed a block's shared memory (null
// otherwise).  x [M, D]; c0 and c_out [n, K, D]; iters and moves int32
// [n]; assign int64 [n, M].  Lloyd: w [M] (w_stride 0) or [n, M]
// (w_stride M).  Returns the cudaError_t of the launch (0 = launched;
// cudaErrorInvalidValue for a K or D the kernels do not take).
#define VBHEM_KMEANS_ENTRIES(SUFFIX, T)                                       \
  extern "C" int vbhem_kmeans_lloyd_##SUFFIX(                                 \
      const void* x, const void* w, long long w_stride, const void* c0,       \
      void* assign, void* c_out, void* iters, int n, int m, int k, int d,     \
      int max_iter, void* stream) {                                           \
    const LloydArgs a{x, w,  w_stride, c0, assign,  c_out,                    \
                      iters, n, m,     max_iter,                              \
                      static_cast<cudaStream_t>(stream)};                     \
    return dispatch<T, Lloyd>(a, k, d);                                       \
  }                                                                           \
  extern "C" int vbhem_kmeans_energy_##SUFFIX(                                \
      const void* x, const void* w, const void* c0, void* assign,             \
      void* c_out, void* moves, void* ws, int n, int m, int k, int d,         \
      int max_iter, double tol, void* stream) {                               \
    const EnergyArgs a{x, w, c0, assign,   c_out, moves,                      \
                       ws, n, m,  max_iter, tol,                              \
                       static_cast<cudaStream_t>(stream)};                    \
    return dispatch<T, Energy>(a, k, d);                                      \
  }

VBHEM_KMEANS_ENTRIES(f32, float)
VBHEM_KMEANS_ENTRIES(f64, double)
