// Packed-triangle Cholesky factorize-solve-sample, one warp per row (K <= 32).
//
// Replaces the TPU kernel bayesiandatafusion_jl_tpu/ops/pallas_chol.py
// `_chol_sample_packed_kernel` (:178, arithmetic in `_chol_solve_sample` :44),
// called through `chol_sample_packed` (:192).  For every row r it computes
//
//     P' = unpack(Pp[:, r]) + (Lambda + jitter I),   L = chol(P'),
//     u[r] = L^-T (L^-1 b[:, r] + xi[r])
//
// with the TPU kernel's operation order (warp_chol.cuh `lane_chol_sample`).
//
// What bounds it on an H100: per row it reads C = K(K+1)/2 packed floats
// (528 * 4 B = 2.1 KB at K = 32) plus 2K floats of b and xi, and does about
// K^3/3 = 11k multiply-adds plus ~K^2 warp shuffles.  At the ML-10M shapes
// (71,567 + 10,681 rows per sweep) that is ~174 MB of reads and ~0.9 G
// multiply-adds: the read stream is the floor (~0.05 ms at 3.35 TB/s); the
// shuffle and FMA instruction rate is the limit in practice (0.92 ms at
// B = 71,567 on an H100 SXM at 700 W, ~5% of the read roofline).
//
// Design: the TPU put the batch on the 128 lanes and padded it to the tile
// with identity rows.  Here a block of 8 warps owns 8 consecutive rows.  The
// block first copies the rows' packed triangles and right-hand sides into
// shared memory with neighbouring threads on neighbouring rows, so the reads
// of the [C, B] layout coalesce; rows past B are masked, so no padding.  Then
// lane i of a row's warp holds row i of the trailing matrix in registers
// (a[0..i], 32 registers at K = 32 instead of the 528 one thread would need),
// and the pivot column is broadcast with __shfl_sync (`lane_chol_sample`,
// warp_chol.cuh, shared with K3).  The shared tile rows
// are padded to 9 entries so the per-lane reads hit distinct banks.
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxK = 32;
constexpr int kRows = 8;              // rows (= warps) per block
constexpr int kPitch = kRows + 1;     // shared tile pitch, bank-conflict free
constexpr int kMaxC = kMaxK * (kMaxK + 1) / 2;

template <typename T>
__global__ void __launch_bounds__(kRows * 32)
chol_sample_packed_kernel(const T* __restrict__ Pp, long long p_sc,
                          long long p_sr, const T* __restrict__ lam,
                          T jitter, const T* __restrict__ b, long long b_sk,
                          long long b_sr, const T* __restrict__ xi,
                          T* __restrict__ u, int B, int K) {
  __shared__ T tile_p[kMaxC * kPitch];
  __shared__ T tile_b[kMaxK * kPitch];
  const int C = K * (K + 1) / 2;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;

  for (int e = threadIdx.x; e < C * kRows; e += blockDim.x) {
    const int c = e / kRows, r = e % kRows;
    const long long row = row0 + r;
    tile_p[c * kPitch + r] = row < B ? Pp[c * p_sc + row * p_sr] : T(0);
  }
  for (int e = threadIdx.x; e < K * kRows; e += blockDim.x) {
    const int k = e / kRows, r = e % kRows;
    const long long row = row0 + r;
    tile_b[k * kPitch + r] = row < B ? b[k * b_sk + row * b_sr] : T(0);
  }
  __syncthreads();

  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = row0 + w;
  if (row >= B) return;  // whole warp leaves together: shuffles stay full

  // lane i holds row i of the lower triangle: a[k] = P'[i][k], k <= i
  T a[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    a[k] = T(0);
    if (k <= lane && lane < K) {
      const int c = k * K - k * (k - 1) / 2 + (lane - k);  // triu (k, lane)
      T l = lam[lane * K + k];
      if (k == lane) l = l + jitter;
      a[k] = tile_p[c * kPitch + w] + l;
    }
  }

  const T b_lane = lane < K ? tile_b[lane * kPitch + w] : T(0);
  const T xi_lane = lane < K ? xi[row * K + lane] : T(0);
  const T uval = lane_chol_sample<T, kMaxK>(a, b_lane, xi_lane, K, lane);
  if (lane < K) u[row * K + lane] = uval;
}

template <typename T>
int launch(const T* Pp, long long p_sc, long long p_sr, const T* lam,
           double jitter, const T* b, long long b_sk, long long b_sr,
           const T* xi, T* u, int B, int K, void* stream) {
  if (K < 1 || K > kMaxK || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  chol_sample_packed_kernel<T><<<blocks, kRows * 32, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      Pp, p_sc, p_sr, lam, static_cast<T>(jitter), b, b_sk, b_sr, xi, u, B,
      K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Element (c, r) of Pp is
// Pp[c * p_sc + r * p_sr], element (k, r) of b is b[k * b_sk + r * b_sr];
// xi and u are contiguous [B, K], lam contiguous [K, K].  Returns the
// launch's cudaGetLastError() (0 on success).
extern "C" int bdf_chol_sample_packed_f32(
    const float* Pp, long long p_sc, long long p_sr, const float* lam,
    double jitter, const float* b, long long b_sk, long long b_sr,
    const float* xi, float* u, int B, int K, void* stream) {
  return launch<float>(Pp, p_sc, p_sr, lam, jitter, b, b_sk, b_sr, xi, u, B,
                       K, stream);
}

extern "C" int bdf_chol_sample_packed_f64(
    const double* Pp, long long p_sc, long long p_sr, const double* lam,
    double jitter, const double* b, long long b_sk, long long b_sr,
    const double* xi, double* u, int B, int K, void* stream) {
  return launch<double>(Pp, p_sc, p_sr, lam, jitter, b, b_sk, b_sr, xi, u,
                        B, K, stream);
}
