// Scaled forward-backward of the VBEM E-step for NVIDIA Hopper (sm_90a):
// kernel B2 of the port.
//
// Replaces the TPU kernel `_kernel` of vbhem_tpu/ops/fb_pallas.py (launched by
// `forward_backward_pallas`).  For every sequence of a padded batch it runs
// the scaled forward pass (per-step max shift of log_rho, normalizers c_t, a
// padded step carrying alpha through with c = 1), then the backward pass
// (beta reset to ones before a padded successor) that yields gamma [T, K],
// xi_sum [K, K] and phi_norm = sum_t log c_t + sum_t max_k log_rho; it also
// writes log_rho with its padded steps zeroed, which the bound reads.  The
// plain PyTorch version is `vbhem_tpu_torch/ops/fb.py:forward_backward`
// (entry 1) and `expected_log_gauss` followed by it (the fused entry).
//
// One template, `fb_resident_kernel<T, K, D>`, over the dtype, the states
// K (1..8) and where the emission scores come from:
//   * D = 0 (entry 1, `vbhem_fb_f32/f64`): log_rho [B*N, T, K] is read;
//   * D = 1..3 (the fused E-step, `vbhem_fb_fused_f32/f64`): x [Bx*N, T, D]
//     and per-lane constants of the NIW expected log-density are read and
//     log_rho_k(x) = c_k - 1/2 (x - m_k)^T P_k (x - m_k) is formed on chip
//     (P_k = v_k W_k, c_k = 1/2 E[log|Lambda_k|] - D / (2 beta_k)
//     - (D/2) log 2 pi).  All restarts of a subject share its x rows, and
//     x is never expanded over them.
//
// Its bound on this card is bytes.  Per sequence the arithmetic is about
// T*(K + 1) transcendentals and 3*T*K^2 multiply-adds, far below the card's
// rates at K <= 8.  The least traffic is the input read once (log_rho, or x
// once per subject) and log_rho and gamma written once.  At the VBEM
// main-path launch (8192 subjects x 20 restarts x 25 sequences, T=50, K=2,
// f32) that is 1.64 GB + 2 x 1.64 GB for entry 1 (about 1.5 ms at
// 3.35 TB/s) and 82 MB + 2 x 1.64 GB for the fused entry (about 1.0 ms),
// plus xi_sum, phi_norm and the mask.  The kernel itself is held back by
// the latency of each thread's serial passes: shared memory caps the
// sequences an SM holds (PERF.md, section 6).
//
// The resident design (the default; `ops/fb_cuda.py:design` picks it):
//   * one thread per sequence, K a template parameter, so the state
//     vectors, the transition scores and the xi accumulator live in
//     registers.  The recursion over T is serial and K x K products at
//     K <= 8 give the tensor cores no work;
//   * whole sequences stay on chip: a block runs `rows` consecutive
//     sequences (a multiple of 32 up to 128, from fb_cuda.design: the rows
//     that let an SM hold the most sequences in its 228 KB, the fewest
//     among equals) with their log_rho tile, alpha tile and mask rows in
//     dynamic shared memory for both passes.  So HBM sees the input once
//     and each output once; alpha is turned into gamma in place.  At T=50,
//     K=2 in f32 a sequence takes 824 bytes in either entry (the input
//     rows land in the alpha rows; the mask is 16 bytes of bits): 32-row
//     blocks, eight to an SM, 256 sequences per SM;
//   * several blocks per SM, not persistent blocks: one block's copies
//     land while the SM's other blocks compute.  (A persistent grid whose
//     blocks copied the next group into a second buffer held 128-160
//     sequences per SM and took 1.6-1.8x as long on an H100: the kernel is
//     bound by the latency of each thread's passes, so the sequences in
//     flight per SM set its speed.)
//   * loads are bulk copies (TMA, `cp.async.bulk` completing on one
//     mbarrier per block), one per lane segment of the block and tensor:
//     a lane's sequences in the block are consecutive rows of the input
//     (log_rho, or x) and of the mask, so at most three copies of each
//     bring a 32-row block in, and the copy engine moves them while the
//     threads load their scores and emission constants.  A bulk copy wants
//     16-byte-aligned spans of whole 16-byte units: input rows of an odd
//     number of units (400 bytes at T*K = 100, f32) land densely in the
//     alpha tile, and the mask arrives packed as bits (the wrapper packs
//     it; 16 bytes a row up to T = 128).  Only the emission pass reads the
//     staged rows, with 4-way bank conflicts; the tiles the recursion
//     walks have odd row strides, so a thread reading its own row hits its
//     own bank and no swizzle is needed.  Other input rows copy element by
//     element (`cp.async`) into the same staging rows.  A clock count per
//     phase on an H100 (PERF.md, section 6) found 4-byte
//     `cp.async` copies of every element 41% of each block's cycles, and
//     a bulk copy per thread and row nearly as slow: the copy instruction
//     takes its operands in uniform registers, so 32 threads' copies issue
//     one at a time;
//   * each thread forms its log_rho row from its staged row (x, or
//     log_rho in entry 1) with the padded steps zeroed, so the masked
//     log_rho is stored straight from the tile, and a padded step adds 0
//     to sum_t max;
//   * the forward pass forms px_t as each step comes, normalizes one step
//     late (the reciprocal of c runs beside the K x K product, not after
//     it) and leaves px_t / c_t in the log_rho row, so the backward pass
//     recomputes no c_t;
//   * stores are 16-byte vector stores (float4 / double2) of the group's
//     contiguous span of gamma and of the masked log_rho, gathered from
//     the padded tiles.  The span starts on a 16-byte boundary because
//     `rows` is a multiple of 32;
//   * restart lanes: sequence s = b * N + n belongs to lane b; blocks run
//     in order, so the restarts of one subject (consecutive lanes) run
//     next to each other and share its x rows and mask rows through L2.
//     Shared initial and transition scores are read per lane,
//     per-sequence ones per sequence.
// Bytes the resident design moves: the bound's (input once, outputs
// once); x is read once per block that holds one of its subject's
// sequences, from L2 after the first.
//
// The streamed design, for shapes whose tiles do not fit (long T): a block
// of 128 sequences walks T in chunks of 128 bytes per sequence through
// shared memory, reading log_rho twice and moving alpha / gamma three times
// (written, read back, written).  It serves entry 1 only; the fused
// E-step's dispatch computes log_rho in PyTorch for such shapes and
// launches entry 1.
//
// Numerics follow ops/fb.py (`vbhmm_fb.m:289-377`) in both designs.  A
// sequence whose mask row is all false (length 0: a padded trial of a
// ragged bank) is empty and contributes nothing: zero gamma, xi_sum and
// phi_norm, and a zero masked log_rho.  Both designs run its passes on its
// padded steps, which zero gamma and xi_sum, and write its phi_norm as 0.
//
// This header holds both designs and their launchers; fb.cu holds the C
// interface, and fb_entry1_f32.cu, fb_entry1_f64.cu, fb_fused_f32.cu and
// fb_fused_f64.cu instantiate the kernels, so that ops/_build.py compiles
// them in four nvcc processes at once.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace vbhem_fb {

constexpr int kThreads = 128;      // streamed design: sequences per block
constexpr int kMaxRows = 128;      // resident design: most sequences per block
constexpr int kMaxSmem = 232448;   // shared memory one block may use

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double dmax(double a, double b) { return fmax(a, b); }

// The recursion's special functions.  In float32 the hardware's
// approximations (ex2 and lg2 with a scale, rcp), a few instructions each
// on the recursion's critical path where the correctly rounded versions
// take tens; their errors (a few ulp) are far inside the f32 parity gate.
// In float64 the correctly rounded ones.
__device__ __forceinline__ float rexp(float x) { return __expf(x); }
__device__ __forceinline__ double rexp(double x) { return exp(x); }
__device__ __forceinline__ float rlog(float x) { return __logf(x); }
__device__ __forceinline__ double rlog(double x) { return log(x); }
__device__ __forceinline__ float rrcp(float x) { return __fdividef(1.0f, x); }
__device__ __forceinline__ double rrcp(double x) { return __drcp_rn(x); }

// px[k] = exp(r[k] - max_k r[k]); returns the max (vbhmm_fb.m:289-291)
template <typename T, int K>
__device__ __forceinline__ T load_px(const T* __restrict__ r, T* px) {
  T mx = r[0];
#pragma unroll
  for (int k = 1; k < K; ++k) mx = dmax(mx, r[k]);
#pragma unroll
  for (int k = 0; k < K; ++k) px[k] = rexp(r[k] - mx);
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

// exp of a sequence's initial and transition scores
template <typename T, int K>
__device__ __forceinline__ void load_scores(const T* __restrict__ p,
                                            const T* __restrict__ a, T* pz1,
                                            T (*A)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pz1[k] = dexp(p[k]);
#pragma unroll
    for (int l = 0; l < K; ++l) A[k][l] = dexp(a[k * K + l]);
  }
}

// ---------------------------------------------------------------------------
// resident design
// ---------------------------------------------------------------------------

// Tile row strides, in elements (words for the mask).  ops/fb_cuda.py
// (`resident_row_bytes`, `mask_row_words`) uses the same formulas to pick
// the design and pack the mask.
//   rho_ld: the log_rho / px tile and (at least) the alpha tile, odd, so a
//     thread walking its own row hits its own bank;
//   stage_ld: where a bulk copy lands an input row of `len` elements: a
//     whole, odd number of 16-byte units (a thread reading its own staged
//     row then meets 4-way bank conflicts, in one pass only);
//   mask_words: the mask row as bits, bit j of word w for step 32 w + j,
//     padded to whole 16-byte units.
__host__ __device__ __forceinline__ int rho_ld(int t, int k) {
  return (t * k) | 1;
}
__host__ __device__ __forceinline__ int stage_ld(int len, int size) {
  const int per = 16 / size;
  return (((len + per - 1) / per) | 1) * per;
}
__host__ __device__ __forceinline__ int mask_words(int t) {
  return 4 * (((t + 31) / 32 + 3) / 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// element-wise asynchronous copies (rows that are not whole 16-byte units)
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the block's mbarrier, on which the bulk copies complete
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a bulk (TMA) copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// step t of a mask row of bits
__device__ __forceinline__ bool mask_bit(const unsigned* mw, int t) {
  return (mw[t >> 5] >> (t & 31)) & 1u;
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
};

// Store a block's tile rows [rows, row_len] (row stride ld) to the
// contiguous, 16-byte-aligned span dst: 16-byte stores, consecutive threads
// on consecutive vectors.  Where whole vectors fill a row, each vector's
// elements are consecutive in one tile row and a thread steps through its
// vectors without a branch; else it walks element by element.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                           const T* tile, int ld, int rows,
                                           int row_len) {
  using V = Vec16<T>;
  constexpr int NV = V::n;
  const int total = rows * row_len;
  const int nvec = total / NV;
  if (row_len % NV == 0) {
    const int vpr = row_len / NV;
    const int adv_rows = blockDim.x / vpr;
    const int adv_c = blockDim.x - adv_rows * vpr;
    int row = threadIdx.x / vpr;
    int c = threadIdx.x - row * vpr;
#pragma unroll 4
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      union {
        typename V::type w;
        T a[NV];
      } u;
      const T* src = tile + row * ld + c * NV;
#pragma unroll
      for (int j = 0; j < NV; ++j) u.a[j] = src[j];
      reinterpret_cast<typename V::type*>(dst)[v] = u.w;
      c += adv_c;
      const bool wrap = c >= vpr;
      c = wrap ? c - vpr : c;
      row += adv_rows + (wrap ? 1 : 0);
    }
    return;
  }
  // (row, e) of this thread's next element, advanced without a division
  // per vector: a thread's vectors are blockDim.x * NV elements apart
  const int adv = (blockDim.x - 1) * NV;
  const int adv_rows = adv / row_len;
  const int adv_e = adv - adv_rows * row_len;
  int row = threadIdx.x * NV / row_len;
  int e = threadIdx.x * NV - row * row_len;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    union {
      typename V::type w;
      T a[NV];
    } u;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      u.a[j] = tile[row * ld + e];
      if (++e == row_len) {
        e = 0;
        ++row;
      }
    }
    reinterpret_cast<typename V::type*>(dst)[v] = u.w;
    row += adv_rows;
    e += adv_e;
    if (e >= row_len) {
      e -= row_len;
      ++row;
    }
  }
  for (int q = nvec * NV + threadIdx.x; q < total; q += blockDim.x) {
    const int r = q / row_len;
    dst[q] = tile[r * ld + q - r * row_len];
  }
}

// Where a block's tiles sit in its dynamic shared memory, in bytes, for
// `rows` sequences: the block's mbarrier (16 bytes), the alpha tile (row
// stride ldg), the log_rho / px tile (ld) and the mask rows (ldw words).
// The input rows (log_rho in entry 1, x in the fused entry) land in the
// alpha tile at stride ldi and are dead once the log_rho tile is formed.
// ops/fb_cuda.py (`resident_row_bytes`) mirrors the total.
struct Layout {
  int ldi, ld, ldg, ldw;  // row strides: input, log_rho, alpha, mask words
  int g, rho, m;          // offsets
  int bytes;
};

__host__ __device__ inline Layout layout(int rows, int t, int k, int d,
                                         int size) {
  Layout l;
  l.ld = rho_ld(t, k);
  l.ldi = stage_ld(d == 0 ? t * k : t * d, size);
  l.ldg = (l.ld > l.ldi ? l.ld : l.ldi) | 1;
  l.ldw = mask_words(t);
  l.g = 16;
  l.rho = l.g + rows * l.ldg * size;
  l.m = l.rho + rows * l.ld * size;
  l.bytes = l.m + rows * l.ldw * 4;
  return l;
}

// One sequence's scores (exponentiated) and, in the fused entry, its
// lane's emission constants: c_k, m_k and the quadratic form
// Q_k = -1/2 P_k folded onto its upper triangle (Q_ee = -P_ee / 2,
// Q_ef = -(P_ef + P_fe) / 2 for e < f), so that
// log_rho_k(x) = c_k + sum_e d_e sum_{f >= e} Q_ef d_f with d = x - m_k.
template <typename T, int K, int D>
struct SeqParams {
  static constexpr int DD = D > 0 ? D : 1;
  static constexpr int NQ = DD * (DD + 1) / 2;
  T pz1[K], A[K][K];
  T c[K], m[K][DD], Q[K][NQ];

  __device__ __forceinline__ void load(const T* __restrict__ log_pz1,
                                       const T* __restrict__ log_trans,
                                       const T* __restrict__ emis, int s,
                                       int b, int pz1_per_seq,
                                       int trans_per_seq) {
    load_scores<T, K>(
        log_pz1 + static_cast<long long>(pz1_per_seq ? s : b) * K,
        log_trans + static_cast<long long>(trans_per_seq ? s : b) * K * K,
        pz1, A);
    if constexpr (D > 0) {
      constexpr int E = 1 + D + D * D;
      const T* em = emis + static_cast<long long>(b) * K * E;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const T* ek = em + k * E;
        c[k] = ek[0];
#pragma unroll
        for (int e = 0; e < D; ++e) m[k][e] = ek[1 + e];
        int j = 0;
#pragma unroll
        for (int e = 0; e < D; ++e) {
          Q[k][j++] = T(-0.5) * ek[1 + D + e * D + e];
#pragma unroll
          for (int f = e + 1; f < D; ++f)
            Q[k][j++] = T(-0.5) * (ek[1 + D + e * D + f] +
                                   ek[1 + D + f * D + e]);
        }
      }
    }
  }
};

// The fused entry's emission row, from the staged x row to the log_rho
// row: log_rho_k(x_t), or 0 at a padded step (the masked log_rho the
// kernel stores; the recursion ignores a padded step's scores).
template <typename T, int K, int D>
__device__ __forceinline__ void emission_row(const SeqParams<T, K, D>& q,
                                             const T* __restrict__ x,
                                             T* __restrict__ rho,
                                             const unsigned* mw,
                                             int t_max) {
#pragma unroll 4
  for (int t = 0; t < t_max; ++t) {
    const bool valid = mask_bit(mw, t);
    T xv[D];
#pragma unroll
    for (int e = 0; e < D; ++e) xv[e] = x[t * D + e];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      T diff[D];
#pragma unroll
      for (int e = 0; e < D; ++e) diff[e] = xv[e] - q.m[k][e];
      T acc = q.c[k];
      int j = 0;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        T y = 0;
#pragma unroll
        for (int f = e; f < D; ++f) y += q.Q[k][j++] * diff[f];
        acc += diff[e] * y;
      }
      rho[t * K + k] = valid ? acc : T(0);
    }
  }
}

// Entry 1's counterpart: the staged log_rho row into the log_rho row, its
// padded steps zeroed.
template <typename T, int K>
__device__ __forceinline__ void copy_row(const T* __restrict__ in,
                                         T* __restrict__ rho,
                                         const unsigned* mw, int t_max) {
#pragma unroll 4
  for (int t = 0; t < t_max; ++t) {
    const bool valid = mask_bit(mw, t);
#pragma unroll
    for (int k = 0; k < K; ++k) rho[t * K + k] = valid ? in[t * K + k] : T(0);
  }
}

// The recursion of one sequence on its tile rows, after the masked log_rho
// has been stored from its row, in two passes over the row:
//   1. forward: px_t = exp(log_rho_t - max) is formed as the step comes
//      (its exps depend on log_rho alone, off the recursion's chain),
//      alpha_t goes to g[t], and px_t / c_t replaces log_rho_t in the row;
//   2. backward: gamma in place in g, xi_sum, reading px_t / c_t, so no
//      step recomputes c_t (vbhmm_fb.m:339 divides by the forward's c).
// The steps are branch-free (a padded step selects, it does not branch),
// and the tile rows are declared not to alias, so the unrolled steps'
// loads and exps overlap the alpha and beta chains.  A padded step's
// scores are 0, so its max adds 0 to sum_t max.

// forward (vbhmm_fb.m:299-323); returns sum_t log c_t + sum_t max_k
// log_rho_t.  Step 0 is taken as valid (for an empty sequence, whose mask
// row is all false, the caller discards the sum).  The normalization runs one step late, off the recursion's chain:
// from delta_{t-1} (alpha_{t-1} before its division by c_{t-1}), the
// product (delta_{t-1} A) o px_t and c_{t-1} = sum delta_{t-1} with its
// reciprocal go in parallel, and
//   delta_t = ((delta_{t-1} A) o px_t) / c_{t-1} = (alpha_{t-1} A) o px_t,
// the plain version's delta, so each step's chain is the longer of the two
// (the reciprocal) plus a multiply, not their sum.  alpha_{t-1}, px_{t-1}
// / c_{t-1} and log c_{t-1} come off that chain.  A padded step carries
// alpha through: delta_t = alpha_{t-1}, whose c (1 up to rounding) adds no
// log.
template <typename T, int K, int D>
__device__ __forceinline__ T forward(const SeqParams<T, K, D>& q,
                                     T* __restrict__ row,
                                     T* __restrict__ g,
                                     const unsigned* mw, int t_max) {
  T p_prev[K], delta[K];
  T sum = load_px<T, K>(row, p_prev);
#pragma unroll
  for (int k = 0; k < K; ++k) delta[k] = q.pz1[k] * p_prev[k];
  bool valid = true;
#pragma unroll 4
  for (int t = 1; t < t_max; ++t) {
    T p[K];
    sum += load_px<T, K>(row + t * K, p);
    // c_{t-1}, log c_{t-1}, alpha_{t-1} and px_{t-1} / c_{t-1}
    T c = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) c += delta[k];
    c = c > T(0) ? c : T(1);
    const T inv_c = rrcp(c);
    sum += valid ? rlog(c) : T(0);
    T alpha[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      alpha[k] = delta[k] * inv_c;
      g[(t - 1) * K + k] = alpha[k];
      row[(t - 1) * K + k] = p_prev[k] * inv_c;
    }
    valid = mask_bit(mw, t);
    T next[K];
#pragma unroll
    for (int l = 0; l < K; ++l) {
      T pr = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) pr += delta[k] * q.A[k][l];
      next[l] = pr * p[l];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      delta[k] = valid ? next[k] * inv_c : alpha[k];
      p_prev[k] = p[k];
    }
  }
  T c = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) c += delta[k];
  c = c > T(0) ? c : T(1);
  const T inv_c = rrcp(c);
  sum += valid ? rlog(c) : T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    g[(t_max - 1) * K + k] = delta[k] * inv_c;
    row[(t_max - 1) * K + k] = p_prev[k] * inv_c;
  }
  return sum;
}

// backward (vbhmm_fb.m:325-362): gamma in place in g, xi_sum to xi_out.
// The row holds px_t / c_t from the forward pass.
template <typename T, int K, int D>
__device__ __forceinline__ void backward(const SeqParams<T, K, D>& q,
                                         const T* __restrict__ row,
                                         T* __restrict__ g,
                                         const unsigned* mw, int t_max,
                                         T* xi_out) {
  T beta[K], xi[K][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    beta[k] = T(1);
#pragma unroll
    for (int l = 0; l < K; ++l) xi[k][l] = T(0);
  }
#pragma unroll 4
  for (int pos = t_max - 1; pos >= 1; --pos) {
    const bool valid = mask_bit(mw, pos);
    // beta holds beta_pos: gamma_pos = alpha_pos * beta_pos
#pragma unroll
    for (int k = 0; k < K; ++k)
      g[pos * K + k] = valid ? g[pos * K + k] * beta[k] : T(0);
    // beta_{pos-1} and xi_{pos-1 -> pos} from alpha_{pos-1} and
    // px_pos / c_pos; before a padded successor beta resets to ones and
    // xi takes nothing
    T bp[K];
#pragma unroll
    for (int l = 0; l < K; ++l) bp[l] = beta[l] * row[pos * K + l];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T w = valid ? g[(pos - 1) * K + k] : T(0);
      T e = 0;
#pragma unroll
      for (int l = 0; l < K; ++l) {
        const T ab = q.A[k][l] * bp[l];
        e += ab;
        xi[k][l] += ab * w;
      }
      beta[k] = valid ? e : T(1);
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) g[k] = mask_bit(mw, 0) ? g[k] * beta[k] : T(0);
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int l = 0; l < K; ++l) xi_out[k * K + l] = xi[k][l];
}

// The element-wise copy of the block's input rows, for rows that are not
// whole 16-byte units: each warp copies the rows of its own threads, one
// row at a time with its lanes on consecutive addresses; a row's source
// offset (in rows of in_len elements) comes from the thread that owns it
// by a shuffle.
template <typename T>
__device__ __forceinline__ void copy_rows_async(T* s_in,
                                                const T* __restrict__ src,
                                                long long in_row, int rows,
                                                int in_len, int ldi) {
  const int lane = threadIdx.x & 31;
  const int w0 = threadIdx.x - lane;
  const int n_rows = rows - w0 < 32 ? rows - w0 : 32;
  for (int j = 0; j < n_rows; ++j) {
    const long long ir = __shfl_sync(0xffffffffu, in_row, j);
    const T* in = src + ir * in_len;
    T* dst = s_in + (w0 + j) * ldi;
    for (int e = lane; e < in_len; e += 32) cp_async(dst + e, in + e);
  }
  cp_async_commit();
}

// One block runs one group of blockDim.x consecutive sequences.
template <typename T, int K, int D>
__global__ void __launch_bounds__(kMaxRows)
fb_resident_kernel(const T* __restrict__ src,      // log_rho or x
                   const T* __restrict__ emis,     // [B, K, 1 + D + D*D]
                   const unsigned* __restrict__ mask,  // [Bm, N, ldw] bits
                   const T* __restrict__ log_pz1,  // [B, K] or [B*N, K]
                   const T* __restrict__ log_trans,
                   T* __restrict__ rho_out,        // [B*N, T, K] masked
                   T* __restrict__ gamma,          // [B*N, T, K]
                   T* __restrict__ xi_out,         // [B*N, K, K]
                   T* __restrict__ phi_out,        // [B*N]
                   int n_seq, int n, int t_max, int mask_rep, int x_rep,
                   int pz1_per_seq, int trans_per_seq, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows_max = blockDim.x;
  const int row_len = t_max * K;
  const int in_len = D == 0 ? row_len : t_max * D;
  const Layout l = layout(rows_max, t_max, K, D, sizeof(T));
  const unsigned bar = smem_addr(smem);
  // the input rows land in the alpha tile, dead once log_rho is formed
  T* s_in = reinterpret_cast<T*>(smem + l.g);
  T* s_g = s_in;
  T* s_rho = reinterpret_cast<T*>(smem + l.rho);
  unsigned* s_mw = reinterpret_cast<unsigned*>(smem + l.m);
  if (threadIdx.x == 0) mbar_init(bar, blockDim.x);
  __syncthreads();

  const int seq0 = blockIdx.x * rows_max;
  const int rows = n_seq - seq0 < rows_max ? n_seq - seq0 : rows_max;
  const int r = threadIdx.x;
  // this thread's sequence (the last one for rows past the end), its
  // lane, and its rows of the input (log_rho rows of the sequence, or x
  // rows of its subject) and of the mask
  const int s = seq0 + (r < rows ? r : rows - 1);
  const int b = s / n;
  const int i = s - b * n;
  const long long in_row =
      D == 0 ? s : static_cast<long long>(b / x_rep) * n + i;
  const long long m_row = static_cast<long long>(b / mask_rep) * n + i;
  // Bulk copies by lane segment: the block's rows of one lane are
  // consecutive rows of the input and of the mask, so the thread that
  // starts a segment (the block's first row or a lane's first sequence)
  // copies all of its rows with one instruction per tensor, at most
  // ceil(rows / N) + 1 of each per block.  (A bulk copy takes its operands
  // in uniform registers, so the copies of many threads of a warp issue
  // one at a time.)  Every thread arrives once.
  {
    const bool head = r < rows && (r == 0 || i == 0);
    const int seg = n - i < rows - r ? n - i : rows - r;
    const unsigned in_bytes = head && bulk ? seg * in_len * sizeof(T) : 0u;
    const unsigned m_bytes = head ? seg * l.ldw * 4u : 0u;
    mbar_arrive_expect_tx(bar, in_bytes + m_bytes);
    if (in_bytes)
      bulk_copy(s_in + r * l.ldi, src + in_row * in_len, in_bytes, bar);
    if (m_bytes)
      bulk_copy(s_mw + r * l.ldw, mask + m_row * l.ldw, m_bytes, bar);
  }
  if (!bulk) copy_rows_async<T>(s_in, src, in_row, rows, in_len, l.ldi);
  // the scores and emission constants load while the copies fly
  SeqParams<T, K, D> q;
  q.load(log_pz1, log_trans, emis, s, b, pz1_per_seq, trans_per_seq);
  if (!bulk) cp_async_wait_all();
  mbar_wait(bar, 0);
  __syncthreads();

  const unsigned* mw = s_mw + r * l.ldw;
  T* rho = s_rho + r * l.ld;
  if (r < rows) {
    if constexpr (D > 0)
      emission_row<T, K, D>(q, s_in + r * l.ldi, rho, mw, t_max);
    else
      copy_row<T, K>(s_in + r * l.ldi, rho, mw, t_max);
  }
  __syncthreads();
  // the masked log_rho, once, before the forward pass turns each row into
  // px / c
  const long long off = static_cast<long long>(seq0) * row_len;
  store_tile<T>(rho_out + off, s_rho, l.ld, rows, row_len);
  __syncthreads();
  if (r < rows) {
    T* g = s_g + r * l.ldg;
    // an empty sequence (its mask row all false) runs the same passes on
    // its zero scores: the backward pass zeroes its gamma and adds nothing
    // to xi_sum, and its phi_norm is written as 0 (a branch around the
    // passes cost the full-width launch 7% of its time)
    const T phi = forward<T, K, D>(q, rho, g, mw, t_max);
    phi_out[s] = mask_bit(mw, 0) ? phi : T(0);
    backward<T, K, D>(q, rho, g, mw, t_max,
                      xi_out + static_cast<long long>(s) * K * K);
  }
  __syncthreads();
  store_tile<T>(gamma + off, s_g, l.ldg, rows, row_len);
}

// ---------------------------------------------------------------------------
// streamed design (shapes whose tiles do not fit)
// ---------------------------------------------------------------------------

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
fb_streamed_kernel(const T* __restrict__ log_rho,          // [B*N, T, K]
                   const unsigned char* __restrict__ mask, // [Bm, N, T]
                   const T* __restrict__ log_pz1,  // [B, K] or [B*N, K]
                   const T* __restrict__ log_trans,
                   T* __restrict__ rho_out,                // [B*N, T, K]
                   T* gamma,                               // [B*N, T, K]
                   T* __restrict__ xi_out,                 // [B*N, K, K]
                   T* __restrict__ phi_out,                // [B*N]
                   long long n_seq, int n, int t_max, int mask_rep,
                   int pz1_per_seq, int trans_per_seq) {
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
  load_scores<T, K>(log_pz1 + (pz1_per_seq ? (active ? s : 0) : b) * K,
                    log_trans + (trans_per_seq ? (active ? s : 0) : b) * K * K,
                    pz1, A);

  // ---- forward (vbhmm_fb.m:299-323); alpha_t goes to gamma[t] ----
  T alpha[K], px[K], delta[K];
  T sum_logc = 0, sum_max = 0;
  for (int c0 = 0; c0 < t_max; c0 += TC) {
    const int tc = t_max - c0 < TC ? t_max - c0 : TC;
    __syncthreads();  // the previous chunk's tile_out has read s_g
    tile_in(s_rho, LDR, 0, log_rho, seq0, row_len, c0 * K, rows, tc * K);
    __syncthreads();
    // the chunk of the masked log_rho output, from the tile
    for (int q = threadIdx.x; q < rows * tc * K; q += blockDim.x) {
      const int row = q / (tc * K);
      const int e = q - row * tc * K;
      const long long sq = seq0 + row;
      const long long bq = sq / n;
      const bool on =
          mask[((bq / mask_rep) * n + (sq - bq * n)) * t_max + c0 + e / K];
      rho_out[sq * row_len + c0 * K + e] = on ? s_rho[row * LDR + e] : T(0);
    }
    if (active) {
      const unsigned valid = chunk_mask<TC>(msk + c0, tc);
      for (int j = 0; j < tc; ++j) {
        const int t = c0 + j;
        if (t == 0) {
          // step 0 starts every sequence; an empty one's phi_norm is
          // written as 0 below
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
  if (active) phi_out[s] = msk[0] ? sum_logc + sum_max : T(0);

  // ---- backward (vbhmm_fb.m:325-362): gamma in place, xi_sum ----
  // position p sits at tile column j = p - c0 + 1; column 0 holds
  // alpha_{c0-1}, so the recomputation of c_p never reaches into the next
  // chunk
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
        const bool valid = (valid_bits >> (j - 1) & 1u) != 0;
#pragma unroll
        for (int k = 0; k < K; ++k)
          g[j * K + k] = valid ? g[j * K + k] * beta[k] : T(0);
        if (pos == 0) continue;
        if (valid) {
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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

struct Args {
  const void* src;
  const void* emis;
  const void* mask;
  const void* log_pz1;
  const void* log_trans;
  void* rho_out;
  void* gamma;
  void* xi_out;
  void* phi_out;
  long long n_seq;
  int n, t_max, k, d, mask_rep, x_rep, pz1_per_seq, trans_per_seq, rows;
  cudaStream_t stream;
};

template <typename T, int K, int D>
int launch_resident(const Args& a) {
  const int smem = layout(a.rows, a.t_max, K, D, sizeof(T)).bytes;
  if (a.rows % 32 != 0 || a.rows > kMaxRows || smem > kMaxSmem ||
      a.n_seq >= (1LL << 31) ||
      reinterpret_cast<std::uintptr_t>(a.rho_out) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(a.gamma) % 16 != 0 ||
      reinterpret_cast<std::uintptr_t>(a.mask) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // input rows that are an odd number of whole 16-byte units stage
  // densely (stage_ld is their length) and copy in bulk; others element
  // by element
  const int in_len = D == 0 ? a.t_max * K : a.t_max * D;
  const int bulk = stage_ld(in_len, sizeof(T)) == in_len &&
                   reinterpret_cast<std::uintptr_t>(a.src) % 16 == 0;
  auto* kernel = fb_resident_kernel<T, K, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // the whole 228 KB for shared memory, so every block design() counted
  // on is resident
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (a.n_seq + a.rows - 1) / a.rows;
  kernel<<<static_cast<unsigned>(grid), a.rows, static_cast<size_t>(smem),
           a.stream>>>(
      static_cast<const T*>(a.src), static_cast<const T*>(a.emis),
      static_cast<const unsigned*>(a.mask),
      static_cast<const T*>(a.log_pz1), static_cast<const T*>(a.log_trans),
      static_cast<T*>(a.rho_out), static_cast<T*>(a.gamma),
      static_cast<T*>(a.xi_out), static_cast<T*>(a.phi_out),
      static_cast<int>(a.n_seq), a.n, a.t_max, a.mask_rep, a.x_rep,
      a.pz1_per_seq, a.trans_per_seq, bulk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_streamed(const Args& a) {
  const dim3 grid(static_cast<unsigned>((a.n_seq + kThreads - 1) / kThreads));
  fb_streamed_kernel<T, K><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.src), static_cast<const unsigned char*>(a.mask),
      static_cast<const T*>(a.log_pz1), static_cast<const T*>(a.log_trans),
      static_cast<T*>(a.rho_out), static_cast<T*>(a.gamma),
      static_cast<T*>(a.xi_out), static_cast<T*>(a.phi_out), a.n_seq, a.n,
      a.t_max, a.mask_rep, a.pz1_per_seq, a.trans_per_seq);
  return static_cast<int>(cudaGetLastError());
}

// The dispatch over K of one dtype: entry 1 (the resident design reading
// log_rho, or the streamed design when rows = 0) and the fused E-step (D in
// 1..3, the resident design only).
template <typename T, int K>
struct Entry1 {
  static int run(const Args& a) {
    return a.rows == 0 ? launch_streamed<T, K>(a)
                       : launch_resident<T, K, 0>(a);
  }
};

template <typename T, int K>
struct Fused {
  static int run(const Args& a) {
    if (a.rows == 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (a.d) {
      case 1: return launch_resident<T, K, 1>(a);
      case 2: return launch_resident<T, K, 2>(a);
      case 3: return launch_resident<T, K, 3>(a);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
};

template <template <typename, int> class Entry, typename T>
int launch_k(const Args& a) {
  switch (a.k) {
    case 1: return Entry<T, 1>::run(a);
    case 2: return Entry<T, 2>::run(a);
    case 3: return Entry<T, 3>::run(a);
    case 4: return Entry<T, 4>::run(a);
    case 5: return Entry<T, 5>::run(a);
    case 6: return Entry<T, 6>::run(a);
    case 7: return Entry<T, 7>::run(a);
    case 8: return Entry<T, 8>::run(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Each defined, and its kernels instantiated, in a translation unit of its
// own (16 kernels in each of entry 1's, 24 in each of the fused E-step's).
int entry1_f32(const Args& a);  // fb_entry1_f32.cu
int entry1_f64(const Args& a);  // fb_entry1_f64.cu
int fused_f32(const Args& a);   // fb_fused_f32.cu
int fused_f64(const Args& a);   // fb_fused_f64.cu

}  // namespace vbhem_fb
