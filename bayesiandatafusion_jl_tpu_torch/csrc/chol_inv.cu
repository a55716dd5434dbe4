// Batched Cholesky factor-and-invert of diagonal panels: W = chol(P)^-1,
// one warp a panel, on the panel core of warp_chol.cuh (K <= 64).
//
// Replaces the TPU kernel bayesiandatafusion_jl_tpu/ops/pallas_chol.py
// `_chol_inv_slab_kernel` (:389), called through `chol_inv_pallas` (:424)
// by the blocked K > 96 sampler `chol_sample_blocked` (:452) once per
// 64-wide diagonal panel.  For every b, W[b] = L^-1 with L = chol(P[b]),
// P[b] read at its upper triangle.  W is written as a full [K, K]
// lower-triangular matrix with exact zeros above the diagonal, because the
// caller multiplies whole panels.  The TPU kernel builds W row by row
// (W[i][:i] = -(sum_{k<i} L[i][k] W[k][:i]) / L[i][i]); here W is built by
// panels, in another rounding order.
//
// What bounds it on an H100: per panel it reads the triangle, K(K+1)/2
// values, and writes K^2 (8.3 KB and 16 KB at K = 64 in float32: 1.77 GB
// at B = 71,567, 0.53 ms at 3.35 TB/s), and does ~K^3/3 multiply-adds
// for the factor and ~K^3/3 for the inverse.  On an NVIDIA H100 80GB HBM3
// at 700 W it takes 1.31 ms there, 40% of that bound: each warp's chain
// of dependent steps (the factorization 43% of its cycles, the load 26%,
// the inverse 20%, the writer 8%) at 16 warps a SM is the limit
// (PERF.md).
//
// Design: K4's loader and the panel core without Lambda and without the
// solves.  A block of panel_rows (8 float, 4 double) warps; each warp owns
// one panel: it copies the upper triangle of P[b] row by row with cp.async
// (row j of P at j ld, panel b at b bs: a panel of a larger P is read in
// place) into the blocked triangle, K padded to 32 NB (NB = 1 or 2) with
// identity rows, and factors it (panel_factor).  Then lane i computes
// column i of W by panels, multiplying by the factorization's kept
// reciprocals (no division):
//
//     W00 e_i = L00^-1 e_i                     (panel_trsm)
//     W10 e_i = -L11^-1 (L10 (W00 e_i))        (panel_gemv, panel_trsm)
//     W11 e_i = L11^-1 e_i                     (panel_trsm)
//
// with W00 e_i kept in registers for the product (read back from shared
// memory it cost 7%, PERF.md), and stores it over L as a lane stores its
// row, so that each row of W lies in one stored column, where the writer
// reads it as chunks: W's rows go to device memory whole, zeros included,
// in 16-byte stores when K allows (K a multiple of 16 / sizeof(T)), else
// one value a lane.  Rows past B are masked.  Dynamic shared memory: panel_words a warp, 105 KB a
// block of 8 float rows at K = 64 (two blocks, 16 warps a SM).
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxK = 2 * kPanel;

// Blocks a SM: what shared memory allows at NB = 2 in both types, and the
// __launch_bounds__ minimum (so registers never cut the occupancy below
// it: 128 a thread in float, 255 in double); NB = 1 takes the same bound,
// since the six blocks its shared memory would allow leave 40 registers
template <typename T, int NB>
__host__ __device__ constexpr int inv_smem() {
  return panel_rows<T>() * panel_words<T, NB>() * static_cast<int>(sizeof(T));
}

constexpr int kMinBlocks = 2;
static_assert(232448 / (inv_smem<float, 2>() + 1024) == kMinBlocks &&
                  232448 / (inv_smem<double, 2>() + 1024) == kMinBlocks,
              "K5's blocks a SM at K = 64");

__device__ __forceinline__ void store_chunk(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_chunk(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// y -= L x for one lane: x in registers, L's column k read as broadcast
// chunks, each feeding G multiply-adds
template <typename T>
__device__ __forceinline__ void panel_gemv(T (&y)[kPanel], const T* L,
                                           const T (&x)[kPanel]) {
  constexpr int G = 16 / sizeof(T);
#pragma unroll
  for (int k = 0; k < kPanel; ++k) {
#pragma unroll
    for (int g = 0; g < kPanel / G; ++g) {
      T v[G];
      load_chunk(L + chunk_off<T>(g, k), v);
#pragma unroll
      for (int h = 0; h < G; ++h) y[g * G + h] -= v[h] * x[k];
    }
  }
}

template <typename T, int NB>
__global__ void __launch_bounds__(panel_rows<T>() * 32, kMinBlocks)
chol_inv_kernel(const T* __restrict__ P, long long ld, long long bs,
                T* __restrict__ W, int B, int K) {
  constexpr int kRows = panel_rows<T>();
  constexpr int kWords = panel_words<T, NB>();
  constexpr int G = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int w = threadIdx.x / 32;
  const int i = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + w;
  if (row >= B) return;  // whole warp leaves; no block-wide sync follows
  T* const A = reinterpret_cast<T*>(smem_raw) + w * kWords;

  // stage: entry (m, j), m >= j, of the triangle from P[b][j][m]
  const T* const Pr = P + row * bs;
  for (int j = 0; j < K; ++j) {
    const int c = j % kPanel, rb = j / kPanel;
    T* const dst = A + blk_off<T>(i, c);
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      const int m = kPanel * q + i;
      if (q >= rb && m >= j && m < K) {
        cp_async<sizeof(T)>(dst + blk_base(q, rb), Pr + j * ld + m);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  panel_pad<T, NB>(A, K, i);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  panel_factor<T, NB, false>(A, NoLam{}, i);

  // column i of W by panels, then stored over L as a lane stores its row
  // (x[k] = W[k][i] at blk_off(i, k)): row k of each block of W lies in
  // its stored column k
  const T* const inv = A + panel_vec<NB>() + kPanel * NB;
  T* const D0 = A + blk_base(0, 0);
  T x[kPanel];
#pragma unroll
  for (int k = 0; k < kPanel; ++k) x[k] = T(k == i);
  panel_trsm<T>(D0, inv, x);                // W00 e_i
  if constexpr (NB == 2) {
    T* const E = A + blk_base(1, 0);
    T* const D1 = A + blk_base(1, 1);
    T y[kPanel];
#pragma unroll
    for (int k = 0; k < kPanel; ++k) y[k] = T(0);
    panel_gemv<T>(y, E, x);                 // -L10 W00 e_i
    panel_trsm<T>(D1, inv + kPanel, y);     // W10 e_i
    __syncwarp();               // every lane has read L00 and L10
#pragma unroll
    for (int k = 0; k < kPanel; ++k) D0[blk_off<T>(i, k)] = x[k];
#pragma unroll
    for (int k = 0; k < kPanel; ++k) E[blk_off<T>(i, k)] = y[k];
#pragma unroll
    for (int k = 0; k < kPanel; ++k) x[k] = T(k == i);
    panel_trsm<T>(D1, inv + kPanel, x);     // W11 e_i
    __syncwarp();               // every lane has read L11
#pragma unroll
    for (int k = 0; k < kPanel; ++k) D1[blk_off<T>(i, k)] = x[k];
  } else {
    __syncwarp();               // every lane has read L00
#pragma unroll
    for (int k = 0; k < kPanel; ++k) D0[blk_off<T>(i, k)] = x[k];
  }
  __syncwarp();

  // W's rows, whole: row m of block (q, r) is stored column m % 32 of it
  T* const Wr = W + row * K * K;
  if (K % G == 0) {
    // lane i takes chunk g of row m0 + (i >> sh): 2^sh lanes a row
    const int cpr = K / G;                  // chunks a row, <= 32
    const int sh = 32 - __clz(cpr - 1);
    const int g = i & ((1 << sh) - 1);
    if (g < cpr) {
      const int c = g * G, r = c / kPanel;
      for (int m = i >> sh; m < K; m += 32 >> sh) {
        const int q = m / kPanel;
        T v[G];
        if (r <= q) {
          load_chunk(A + blk_base(q, r) +
                         chunk_off<T>((c % kPanel) / G, m % kPanel), v);
        } else {
#pragma unroll
          for (int h = 0; h < G; ++h) v[h] = T(0);
        }
        store_chunk(Wr + m * K + c, v);
      }
    }
  } else {
    for (int m = 0; m < K; ++m) {
#pragma unroll
      for (int r = 0; r < NB; ++r) {
        const int c = kPanel * r + i;
        if (c < K) {
          Wr[m * K + c] =
              c <= m ? A[blk_base(m / kPanel, r) + blk_off<T>(i, m % kPanel)]
                     : T(0);
        }
      }
    }
  }
}

template <typename T, int NB>
int launch_nb(const T* P, long long ld, long long bs, T* W, int B, int K,
              cudaStream_t stream) {
  constexpr int kRows = panel_rows<T>();
  constexpr int smem = inv_smem<T, NB>();
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  chol_inv_kernel<T, NB><<<blocks, kRows * 32, smem, stream>>>(P, ld, bs, W,
                                                               B, K);
  return static_cast<int>(cudaGetLastError());
}

// K <= 32: one panel, else two
template <typename T>
int launch(const T* P, long long ld, long long bs, T* W, int B, int K,
           void* stream) {
  if (K < 1 || K > kMaxK || B < 0 || ld < K || bs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return K <= kPanel ? launch_nb<T, 1>(P, ld, bs, W, B, K, s)
                     : launch_nb<T, 2>(P, ld, bs, W, B, K, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  P[b][j][m] is at
// P + b bs + j ld + m (unit inner stride, ld >= K; a panel of a larger P
// is read in place); W is contiguous [B, K, K] and 16-byte aligned.  P must be
// symmetric positive definite (its upper triangle is read).  Returns the
// launch's CUDA error code (0 on success).
extern "C" int bdf_chol_inv_f32(const float* P, long long ld, long long bs,
                                float* W, int B, int K, void* stream) {
  return launch<float>(P, ld, bs, W, B, K, stream);
}

extern "C" int bdf_chol_inv_f64(const double* P, long long ld, long long bs,
                                double* W, int B, int K, void* stream) {
  return launch<double>(P, ld, bs, W, B, K, stream);
}
