// Packed-triangle column-slab Cholesky factorize-solve-sample, one warp per
// row, the row's triangle in shared memory (32 < K <= 96).
//
// Replaces the TPU kernel bayesiandatafusion_jl_tpu/ops/pallas_chol.py
// `_chol_sample_packed_slab_kernel` (:269, offsets `_tri_offsets` :260),
// called through `chol_sample_packed_tiled` (:315).  For every row r
//
//     P' = unpack(Pp[:, r]) + (Lambda + jitter I),   L = chol(P'),
//     u[r] = L^-T (L^-1 b[:, r] + xi[r])
//
// with the TPU kernel's operation order: the column-slab factorization
// (warp_chol.cuh), the forward solve with a true division by the diagonal,
// then the column-oriented backward solve, whose sum over a column is a warp
// reduction here.
//
// What bounds it on an H100: per row it reads C = K(K+1)/2 floats (8.3 KB
// at K = 64, 18.6 KB at K = 96 in float32) and does ~K^3/6 multiply-adds
// (44k at K = 64, 147k at K = 96).  A row's triangle does not fit in
// registers (K1's one-row-per-lane design would need ~195 floats a lane at
// K = 96), so it lives in shared memory and every multiply-add of the
// trailing update is one shared load and one shared store.  That shared
// traffic, ~2 wavefronts per warp-wide update step, is the floor, well above
// the read stream (1.33 GB at K = 96 and B = 71,567: 0.4 ms at 3.35 TB/s).
//
// Design: a block of kRows warps owns kRows consecutive rows.  It first
// copies the rows' triangles (Lambda + jitter added on load) and right-hand
// sides into shared memory with neighbouring threads on neighbouring rows,
// so the [C, B] reads coalesce; both strides are taken, so the Gramian's
// padded [C, N_stored] output is read as a view.  Rows past B are masked,
// not padded.  Then one warp factors and solves each row (lane l owns the
// rows l, l + 32, l + 64).  Dynamic shared memory holds kRows * (C + 2K)
// values: 77.6 KB at K = 96 in float32, 155 KB in float64.
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxK = 96;
constexpr int kMaxT = kMaxK / 32;     // rows of the trailing matrix a lane owns
constexpr int kRows = 4;              // rows (= warps) per block

template <typename T>
__global__ void __launch_bounds__(kRows * 32)
chol_sample_packed_slab_kernel(const T* __restrict__ Pp, long long p_sc,
                               long long p_sr, const T* __restrict__ lam,
                               T jitter, const T* __restrict__ b,
                               long long b_sk, long long b_sr,
                               const T* __restrict__ xi, T* __restrict__ u,
                               int B, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int C = K * (K + 1) / 2;
  const int per_row = C + 2 * K;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;

  // stage: tri[r][e] = Pp[e, row0 + r] + (Lambda + jitter I)[k][m] for the
  // packed entry e = (k, m), m >= k, walked column by column
  for (int k = 0; k < K; ++k) {
    const int ok = tri_off(k, K);
    const int n = (K - k) * kRows;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int i = e / kRows, r = e % kRows;
      const int m = k + i;
      const long long row = row0 + r;
      T v = T(0);
      if (row < B) {
        T l = lam[k * K + m];
        if (m == k) l = l + jitter;
        v = Pp[(ok + i) * p_sc + row * p_sr] + l;
      }
      smem[r * per_row + ok + i] = v;
    }
  }
  for (int e = threadIdx.x; e < K * kRows; e += blockDim.x) {
    const int k = e / kRows, r = e % kRows;
    const long long row = row0 + r;
    smem[r * per_row + C + k] = row < B ? b[k * b_sk + row * b_sr] : T(0);
  }
  __syncthreads();

  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = row0 + w;
  if (row >= B) return;  // whole warp leaves together
  T* A = smem + w * per_row;   // the packed triangle, L overwrites it
  T* R = A + C;                // b, then y, then y + xi
  T* U = R + K;                // u

  warp_chol_packed<T, kMaxT>(A, K, lane);

  // forward solve L y = b (y overwrites R); L[m][k] = A[off(k) + m - k]
  for (int k = 0; k < K; ++k) {
    const int ok = tri_off(k, K);
    const T yk = R[k] / A[ok];
    __syncwarp();
    if (lane == 0) R[k] = yk;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int m = lane + 32 * t;
      if (m > k && m < K) R[m] = R[m] - A[ok + m - k] * yk;
    }
    __syncwarp();
  }

  // backward solve L^T u = y + xi, column-oriented:
  // u_i = (v_i - sum_{k > i} L[k][i] u_k) / L[i][i]
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    const int m = lane + 32 * t;
    if (m < K) R[m] = R[m] + xi[row * K + m];
  }
  __syncwarp();
  for (int i = K - 1; i >= 0; --i) {
    const int oi = tri_off(i, K);
    T part = T(0);
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int k = lane + 32 * t;
      if (k > i && k < K) part = part + A[oi + k - i] * U[k];
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      part += __shfl_xor_sync(kFullMask, part, s);
    }
    if (lane == 0) U[i] = (R[i] - part) / A[oi];
    __syncwarp();
  }
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    const int m = lane + 32 * t;
    if (m < K) u[row * K + m] = U[m];
  }
}

template <typename T>
int launch(const T* Pp, long long p_sc, long long p_sr, const T* lam,
           double jitter, const T* b, long long b_sk, long long b_sr,
           const T* xi, T* u, int B, int K, void* stream) {
  if (K < 1 || K > kMaxK || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const int C = K * (K + 1) / 2;
  const size_t smem = static_cast<size_t>(kRows) * (C + 2 * K) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      chol_sample_packed_slab_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  chol_sample_packed_slab_kernel<T><<<blocks, kRows * 32, smem,
                                      static_cast<cudaStream_t>(stream)>>>(
      Pp, p_sc, p_sr, lam, static_cast<T>(jitter), b, b_sk, b_sr, xi, u, B,
      K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (loaded with ctypes), with K1's signature.  Element
// (c, r) of Pp is Pp[c * p_sc + r * p_sr], element (k, r) of b is
// b[k * b_sk + r * b_sr]; xi and u are contiguous [B, K], lam contiguous
// [K, K].  Returns the launch's CUDA error code (0 on success).
extern "C" int bdf_chol_sample_packed_slab_f32(
    const float* Pp, long long p_sc, long long p_sr, const float* lam,
    double jitter, const float* b, long long b_sk, long long b_sr,
    const float* xi, float* u, int B, int K, void* stream) {
  return launch<float>(Pp, p_sc, p_sr, lam, jitter, b, b_sk, b_sr, xi, u, B,
                       K, stream);
}

extern "C" int bdf_chol_sample_packed_slab_f64(
    const double* Pp, long long p_sc, long long p_sr, const double* lam,
    double jitter, const double* b, long long b_sk, long long b_sr,
    const double* xi, double* u, int B, int K, void* stream) {
  return launch<double>(Pp, p_sc, p_sr, lam, jitter, b, b_sk, b_sr, xi, u,
                        B, K, stream);
}
