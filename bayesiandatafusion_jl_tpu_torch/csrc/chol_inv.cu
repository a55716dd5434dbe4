// Batched Cholesky factor-and-invert of diagonal panels: W = chol(P)^-1,
// one warp per panel, the factor and W in shared memory (K <= 64).
//
// Replaces the TPU kernel bayesiandatafusion_jl_tpu/ops/pallas_chol.py
// `_chol_inv_slab_kernel` (:389), called through `chol_inv_pallas` (:424)
// by the blocked K > 96 sampler `chol_sample_blocked` (:452) once per
// 64-wide diagonal panel.  For every row b of P [B, K, K] it factors
// P[b] = L L^T with the column-slab recurrence (warp_chol.cuh) and builds
// W = L^-1 row by row, in the TPU kernel's order:
//
//     W[0][0] = 1 / L[0][0]
//     W[i][:i] = -(sum_{k < i} L[i][k] W[k][:i]) * (1 / L[i][i])
//     W[i][i] = 1 / L[i][i]
//
// W is written as a full [K, K] lower-triangular matrix with exact zeros
// above the diagonal, because the caller multiplies whole panels.
//
// What bounds it on an H100: per row it reads and writes K^2 floats (16 KB
// each at K = 64 in float32: 2.3 GB of traffic at B = 71,567, ~0.7 ms at
// 3.35 TB/s) and does ~K^3/6 multiply-adds for the factor plus ~K^3/6 for
// the inverse.  Both recurrences run from shared memory (one load per
// multiply-add and a store per factor update), and that shared traffic is
// the floor, as in K2.
//
// Design: the TPU kernel put the batch on the lanes and padded it with
// identity panels.  Here each warp owns one row: it reads the upper
// triangle of P[b] row by row (contiguous, so coalesced; P is symmetric and
// row j's upper part is column j of L) into the packed column-major layout
// of warp_chol.cuh, factors it, then computes W's rows with lane l owning
// the columns l and l + 32: the sum over k reads L[i][k] as a broadcast and
// W[k][c] at consecutive addresses.  W's rows are kept packed in shared
// memory for the later rows and written to device memory as they finish.
// Rows past B are masked.  Dynamic shared memory: kRows * K (K + 1) values,
// 66.6 KB at K = 64 in float32.
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxK = 64;
constexpr int kMaxT = kMaxK / 32;
constexpr int kRows = 4;              // rows (= warps) per block

template <typename T>
__global__ void __launch_bounds__(kRows * 32)
chol_inv_kernel(const T* __restrict__ P, T* __restrict__ W, int B, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = K * (K + 1) / 2;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + w;
  if (row >= B) return;  // whole warp leaves; no block-wide sync follows
  T* A = reinterpret_cast<T*>(smem_raw) + w * 2 * C;  // L, column by column
  T* Wp = A + C;                                      // W, row by row
  const T* Pr = P + row * K * K;
  T* Wr = W + row * K * K;

  for (int j = 0; j < K; ++j) {
    const int oj = tri_off(j, K);
    for (int i = j + lane; i < K; i += 32) A[oj + i - j] = Pr[j * K + i];
  }
  __syncwarp();

  warp_chol_packed<T, kMaxT>(A, K, lane);

  for (int i = 0; i < K; ++i) {
    const T inv = T(1) / A[tri_off(i, K)];
    T s[kMaxT];
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) s[t] = T(0);
    for (int k = 0; k < i; ++k) {
      const T lik = A[tri_off(k, K) + i - k];
      const T* wk = Wp + k * (k + 1) / 2;
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        const int c = lane + 32 * t;
        if (c <= k) s[t] = s[t] + lik * wk[c];   // W[k][c] = 0 for c > k
      }
    }
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int c = lane + 32 * t;
      const T v = c < i ? -s[t] * inv : (c == i ? inv : T(0));
      if (c <= i) Wp[i * (i + 1) / 2 + c] = v;
      if (c < K) Wr[i * K + c] = v;
    }
    __syncwarp();
  }
}

template <typename T>
int launch(const T* P, T* W, int B, int K, void* stream) {
  if (K < 1 || K > kMaxK || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const size_t smem = static_cast<size_t>(kRows) * K * (K + 1) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chol_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  chol_inv_kernel<T><<<blocks, kRows * 32, smem,
                       static_cast<cudaStream_t>(stream)>>>(P, W, B, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  P and W are contiguous
// [B, K, K]; P must be symmetric positive definite (its upper triangle is
// read).  Returns the launch's CUDA error code (0 on success).
extern "C" int bdf_chol_inv_f32(const float* P, float* W, int B, int K,
                                void* stream) {
  return launch<float>(P, W, B, K, stream);
}

extern "C" int bdf_chol_inv_f64(const double* P, double* W, int B, int K,
                                void* stream) {
  return launch<double>(P, W, B, K, stream);
}
