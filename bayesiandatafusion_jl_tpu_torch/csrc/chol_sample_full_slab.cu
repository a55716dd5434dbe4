// Full-P column-slab Cholesky factorize-solve-sample, one warp per row, the
// row's triangle in shared memory (32 < K <= 96): the sampler of the gather
// path.
//
// Replaces the TPU kernel bayesiandatafusion_jl_tpu/ops/pallas_chol.py
// `_chol_sample_slab_kernel` (:77), called through `chol_sample_pallas_tiled`
// (:119).  For every row r of P [B, K, K]
//
//     P' = (P[r] (+ Lambda when given)) + jitter I,   L = chol(P'),
//     u[r] = L^-T (L^-1 b[r] + xi[r])
//
// reading the upper triangle of P[r] (row j's part right of the diagonal is
// column j of L under symmetry, as the TPU kernel reads its transposed
// input), with the TPU kernel's operation order (warp_chol.cuh
// `warp_packed_solve_sample`).  The JAX package adds Lambda by an XLA
// broadcast-add before the kernel; here it is added on load.
//
// What bounds it on an H100: per row it must read the triangle, K(K+1)/2
// floats (8.3 KB at K = 64, 18.6 KB at K = 96 in float32), plus 2K floats
// of b and xi, and write K; it does ~K^3/3 + 2K^2 operations.  At
// B = 71,567 and K = 64 that is ~0.6 GB (0.18 ms at 3.35 TB/s) and
// ~6.8 GFLOP (0.1 ms at 67 TFLOP/s).  As in K2, every multiply-add of the
// trailing update is a shared load and store, and that shared traffic is
// the floor in practice.
//
// Design: K2 with a full-P loader.  Each warp owns one row: it copies the
// upper triangle of P[r] row by row (contiguous, so coalesced) into the
// packed column-major layout of warp_chol.cuh, with Lambda and jitter added
// on load, then factors, solves and samples.  Rows past B are masked, not
// padded with identity rows as on the TPU.  Dynamic shared memory holds
// kRows * (C + 2K) values: 77.6 KB at K = 96 in float32, 155 KB in float64.
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxK = 96;
constexpr int kMaxT = kMaxK / 32;     // rows of the trailing matrix a lane owns
constexpr int kRows = 4;              // rows (= warps) per block

template <typename T>
__global__ void __launch_bounds__(kRows * 32)
chol_sample_full_slab_kernel(const T* __restrict__ P,
                             const T* __restrict__ lam, T jitter,
                             const T* __restrict__ b,
                             const T* __restrict__ xi, T* __restrict__ u,
                             int B, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = K * (K + 1) / 2;
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + w;
  if (row >= B) return;  // whole warp leaves together; no block-wide sync
  T* A = reinterpret_cast<T*>(smem_raw) + w * (C + 2 * K);  // triangle
  T* R = A + C;                // b, then y + xi; then u scratch
  const T* Pr = P + row * K * K;

  // stage: A[off(j) + i - j] = (P[r][j][i] + Lambda[j][i]) + jitter [i == j]
  for (int j = 0; j < K; ++j) {
    const int oj = tri_off(j, K);
    for (int i = j + lane; i < K; i += 32) {
      T v = Pr[j * K + i];
      if (lam != nullptr) v = v + lam[j * K + i];
      if (i == j) v = v + jitter;
      A[oj + i - j] = v;
    }
  }
  for (int k = lane; k < K; k += 32) R[k] = b[row * K + k];
  __syncwarp();

  warp_packed_solve_sample<T, kMaxT>(A, R, R + K, xi + row * K,
                                     u + row * K, K, lane);
}

template <typename T>
int launch(const T* P, const T* lam, double jitter, const T* b, const T* xi,
           T* u, int B, int K, void* stream) {
  if (K < 1 || K > kMaxK || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int C = K * (K + 1) / 2;
  const size_t smem = static_cast<size_t>(kRows) * (C + 2 * K) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chol_sample_full_slab_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  chol_sample_full_slab_kernel<T><<<blocks, kRows * 32, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      P, lam, static_cast<T>(jitter), b, xi, u, B, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes), with K3's signature.  P is
// contiguous [B, K, K]; b, xi and u are contiguous [B, K]; lam is
// contiguous [K, K], or null for no Lambda.  Returns the launch's CUDA
// error code (0 on success).
extern "C" int bdf_chol_sample_full_slab_f32(const float* P,
                                             const float* lam, double jitter,
                                             const float* b, const float* xi,
                                             float* u, int B, int K,
                                             void* stream) {
  return launch<float>(P, lam, jitter, b, xi, u, B, K, stream);
}

extern "C" int bdf_chol_sample_full_slab_f64(const double* P,
                                             const double* lam,
                                             double jitter, const double* b,
                                             const double* xi, double* u,
                                             int B, int K, void* stream) {
  return launch<double>(P, lam, jitter, b, xi, u, B, K, stream);
}
