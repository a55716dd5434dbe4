// Full-P column-slab Cholesky factorize-solve-sample, one warp a row, the
// row's triangle in shared memory in 32 x 32 blocks (32 < K <= 96): the
// sampler of the gather path.
//
// Replaces the TPU kernel bayesiandatafusion_jl_tpu/ops/pallas_chol.py
// `_chol_sample_slab_kernel` (:77), called through `chol_sample_pallas_tiled`
// (:119).  For every row r of P [B, K, K]
//
//     P' = P[r] + ((Lambda when given) + jitter I),   L = chol(P'),
//     u[r] = L^-T (L^-1 b[r] + xi[r])
//
// reading the upper triangle of P[r] (row j's part right of the diagonal is
// column j of L under symmetry, as the TPU kernel reads its transposed
// input), with K2's core (warp_chol.cuh `panel_chol_sample`).  The JAX
// package adds Lambda by an XLA broadcast-add before the kernel; here it is
// added where the core first reads each entry.
//
// What bounds it on an H100: per row it must read the triangle, K(K+1)/2
// floats (8.3 KB at K = 64, 18.6 KB at K = 96 in float32), plus 2K floats
// of b and xi, and write K; it does ~K^3/3 + 2K^2 operations.  At
// B = 71,567 and K = 64 that is ~0.6 GB (0.18 ms at 3.35 TB/s) and
// ~6.8 GFLOP (0.1 ms at 67 TFLOP/s).  In practice the load of each group's
// rows (not overlapped at K = 96, one block a SM) and the factorization's
// dependent steps are the limit, as in K2 (PERF.md).
//
// Design: K2's core and block shape with a full-P loader.  Each warp owns
// one row: it copies the upper triangle of P[r] row by row with cp.async
// (contiguous, so coalesced) into the blocked triangle of warp_chol.cuh,
// K padded to 32 NB with identity rows; the block's warps share one
// float copy of Lambda (panel_stage_lam), then each factors, solves and
// samples its row.  Rows past B are masked, not padded with identity rows
// as on the TPU.  Dynamic shared memory: panel_smem, 224 KB a block of 8
// rows at K = 96 in float32 (one block a SM), 113 KB at K = 64.
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxK = 96;

template <typename T, int NB>
__global__ void __launch_bounds__(panel_rows<T>() * 32,
                                   panel_blocks<T, NB>(panel_rows<T>()))
chol_sample_full_slab_kernel(const T* __restrict__ P,
                             const T* __restrict__ lam, T jitter,
                             const T* __restrict__ b,
                             const T* __restrict__ xi, T* __restrict__ u,
                             int B, int K) {
  constexpr int kRows = panel_rows<T>();
  constexpr int kWords = panel_words<T, NB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const group = reinterpret_cast<T*>(smem_raw);
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = static_cast<long long>(blockIdx.x) * kRows + w;
  T* const W = group + w * kWords;

  // stage: entry (i, j), i >= j, of the triangle from P[r][j][i]
  if (row < B) {
    const T* const Pr = P + row * K * K;
    for (int j = 0; j < K; ++j) {
      const int c = j % kPanel, rb = j / kPanel;
      T* const dst = W + blk_off<T>(lane, c);
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        const int m = kPanel * q + lane;
        if (q >= rb && m >= j && m < K) {
          cp_async<sizeof(T)>(dst + blk_base(q, rb), Pr + j * K + m);
        }
      }
    }
  }
  T* const lam_s = group + kRows * kWords;
  panel_stage_lam<T, NB>(lam_s, lam, K, w, kRows, lane);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  if (row < B) {
    panel_pad<T, NB>(W, K, lane);
    for (int k = lane; k < K; k += 32) {
      W[panel_vec<NB>() + k] = b[row * K + k];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (row >= B) return;  // whole warp leaves together; no sync follows

  const T* const lam_at = panel_lam_words<T, NB>() > 0 ? lam_s : lam;
  panel_chol_sample<T, NB>(W, LamJitter<T, NB>{lam_at, jitter, K},
                           xi + row * K, u + row * K, K, lane);
}

template <typename T, int NB>
int launch_nb(const T* P, const T* lam, double jitter, const T* b,
              const T* xi, T* u, int B, int K, cudaStream_t stream) {
  constexpr int kRows = panel_rows<T>();
  const int smem = panel_smem<T, NB>(kRows);
  cudaError_t err = cudaFuncSetAttribute(
      chol_sample_full_slab_kernel<T, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  chol_sample_full_slab_kernel<T, NB><<<blocks, kRows * 32, smem, stream>>>(
      P, lam, static_cast<T>(jitter), b, xi, u, B, K);
  return static_cast<int>(cudaGetLastError());
}

// K <= 64: two panels, else three
template <typename T>
int launch(const T* P, const T* lam, double jitter, const T* b, const T* xi,
           T* u, int B, int K, void* stream) {
  if (K < 1 || K > kMaxK || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return K <= 2 * kPanel
             ? launch_nb<T, 2>(P, lam, jitter, b, xi, u, B, K, s)
             : launch_nb<T, 3>(P, lam, jitter, b, xi, u, B, K, s);
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
