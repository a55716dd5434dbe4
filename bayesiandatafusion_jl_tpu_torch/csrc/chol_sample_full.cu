// Full-P Cholesky factorize-solve-sample, one warp per row (K <= 32): the
// sampler of the gather path.
//
// Replaces the TPU kernels bayesiandatafusion_jl_tpu/ops/pallas_chol.py
// `_chol_sample_kernel` (:29) and `_chol_sample_lam_kernel` (:36), arithmetic
// in `_chol_solve_sample` (:44), called through `chol_sample_pallas` (:525).
// For every row r of P [B, K, K] it computes
//
//     P' = (P[r] + jitter I) (+ Lambda when given),   L = chol(P'),
//     u[r] = L^-T (L^-1 b[r] + xi[r])
//
// reading the lower triangle of P[r], with the TPU kernel's operation order
// (warp_chol.cuh `lane_chol_sample`, shared with K1).
//
// What bounds it on an H100: per row it must read the lower triangle,
// K(K+1)/2 floats (2.1 KB at K = 32 in float32), plus 2K floats of b and xi,
// and write K; it does ~K^3/3 + 2K^2 floating-point operations (13k at
// K = 32).  At B = 71,567 that is ~170 MB (0.05 ms at 3.35 TB/s) and
// ~0.9 GFLOP (0.014 ms at 67 TFLOP/s): the read stream is the floor.  The
// shuffle-and-FMA chain of the register factorization is the limit in
// practice, as in K1.
//
// Design: K1's register factorization with a different loader.  The TPU
// kernel put the batch on the 128 lanes and padded it to the tile with
// identity rows.  Here each warp owns one row: it copies the lower triangle
// of P[r], which lies in K*K contiguous floats, into shared memory with
// neighbouring lanes on neighbouring addresses (coalesced; lanes with an
// upper-triangle element stay idle, so those sectors are not fetched), at a
// pitch of K + 1 so that lane i's reads of its row i hit distinct banks.
// Lane i then holds row i in registers (a[0..i]), adding jitter on the
// diagonal and Lambda on load.  Rows past B are masked, not padded.
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxK = 32;
constexpr int kRows = 4;                       // rows (= warps) per block
constexpr int kTile = kMaxK * (kMaxK + 1);     // one row's staged triangle

template <typename T>
__global__ void __launch_bounds__(kRows * 32)
chol_sample_full_kernel(const T* __restrict__ P, const T* __restrict__ lam,
                        T jitter, const T* __restrict__ b,
                        const T* __restrict__ xi, T* __restrict__ u, int B,
                        int K) {
  __shared__ T tile[kRows * kTile];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + w;
  if (row >= B) return;  // whole warp leaves together; no block-wide sync
  T* t = tile + w * kTile;
  const T* Pr = P + row * K * K;

  // stage the lower triangle: t[i * (K + 1) + k] = P[r][i][k], k <= i
  for (int e = lane; e < K * K; e += 32) {
    const int i = e / K, k = e % K;
    if (k <= i) t[i * (K + 1) + k] = Pr[e];
  }
  __syncwarp();

  // lane i holds row i of the lower triangle: a[k] = P'[i][k], k <= i
  T a[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    a[k] = T(0);
    if (k <= lane && lane < K) {
      T v = t[lane * (K + 1) + k];
      if (k == lane) v = v + jitter;
      if (lam != nullptr) v = v + lam[lane * K + k];
      a[k] = v;
    }
  }

  const T b_lane = lane < K ? b[row * K + lane] : T(0);
  const T xi_lane = lane < K ? xi[row * K + lane] : T(0);
  const T uval = lane_chol_sample<T, kMaxK>(a, b_lane, xi_lane, K, lane);
  if (lane < K) u[row * K + lane] = uval;
}

template <typename T>
int launch(const T* P, const T* lam, double jitter, const T* b, const T* xi,
           T* u, int B, int K, void* stream) {
  if (K < 1 || K > kMaxK || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  chol_sample_full_kernel<T><<<blocks, kRows * 32, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      P, lam, static_cast<T>(jitter), b, xi, u, B, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  P is contiguous [B, K, K];
// b, xi and u are contiguous [B, K]; lam is contiguous [K, K], or null for
// no Lambda.  Returns the launch's cudaGetLastError() (0 on success).
extern "C" int bdf_chol_sample_full_f32(const float* P, const float* lam,
                                        double jitter, const float* b,
                                        const float* xi, float* u, int B,
                                        int K, void* stream) {
  return launch<float>(P, lam, jitter, b, xi, u, B, K, stream);
}

extern "C" int bdf_chol_sample_full_f64(const double* P, const double* lam,
                                        double jitter, const double* b,
                                        const double* xi, double* u, int B,
                                        int K, void* stream) {
  return launch<double>(P, lam, jitter, b, xi, u, B, K, stream);
}
