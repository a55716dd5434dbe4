// Packed-triangle column-slab Cholesky factorize-solve-sample, one warp a
// row, the row's triangle in shared memory in 32 x 32 blocks (32 < K <= 96).
//
// Replaces the TPU kernel bayesiandatafusion_jl_tpu/ops/pallas_chol.py
// `_chol_sample_packed_slab_kernel` (:269, offsets `_tri_offsets` :260),
// called through `chol_sample_packed_tiled` (:315).  For every row r
//
//     P' = unpack(Pp[:, r]) + (Lambda + jitter I),   L = chol(P'),
//     u[r] = L^-T (L^-1 b[:, r] + xi[r])
//
// (warp_chol.cuh `panel_chol_sample`, shared with K4: a blocked Cholesky
// over 32-wide panels, in another rounding order than the TPU kernel's
// column-slab recurrence: one IEEE reciprocal a pivot, kept for both
// solves, which multiply by it).
//
// What bounds it on an H100: per row it reads C = K(K+1)/2 floats (8.3 KB
// at K = 64, 18.6 KB at K = 96 in float32) and does ~K^3/6 multiply-adds
// (44k at K = 64, 147k at K = 96).  At B = 71,567 the reads take 0.19 /
// 0.42 ms at 3.35 TB/s, the multiply-adds 0.09 / 0.31 ms at 67 TFLOP/s.
// A row's triangle does not fit in a warp's registers, so it lives in
// shared memory; the column-slab core this replaced paid one shared load
// and one store for every multiply-add of the trailing update and was
// latency-bound at 1-4% of the bytes bound.  The panel core reads and
// writes a trailing entry once a panel, and each broadcast shared chunk
// feeds 4 (float32) multiply-adds; what is left is the load of each
// group's rows, not overlapped at K = 96 (one block a SM), and the
// factorization's dependent steps (PERF.md).
//
// Design: a block of kRows = panel_rows (8 float, 4 double) warps owns
// kRows consecutive rows, so that each packed entry's read of the group
// is one 32-byte sector.  Warp w copies the packed columns k = w,
// w + kRows, ... of every row of the group with cp.async, neighbouring
// lanes on neighbouring rows, into each row's blocked triangle
// (warp_chol.cuh), K padded to 32 NB (64 or 96) with identity rows; both
// strides are taken, so the Gramian's padded [C, N_stored] output is read
// as a view.  A float block also stages Lambda once for its rows; Lambda
// and jitter are added where the core first reads each entry.  Rows past
// B are not loaded.  Dynamic shared memory: panel_smem, 224 KB a float
// block at K = 96 (one block a SM) and 113 KB at K = 64 (two); a double
// block 205 / 105 KB.
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kMaxK = 96;

template <typename T, int NB>
__global__ void __launch_bounds__(panel_rows<T>() * 32,
                                   panel_blocks<T, NB>(panel_rows<T>()))
chol_sample_packed_slab_kernel(const T* __restrict__ Pp, long long p_sc,
                               long long p_sr, const T* __restrict__ lam,
                               T jitter, const T* __restrict__ b,
                               long long b_sk, long long b_sr,
                               const T* __restrict__ xi, T* __restrict__ u,
                               int B, int K) {
  constexpr int kRows = panel_rows<T>();
  constexpr int kWords = panel_words<T, NB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const group = reinterpret_cast<T*>(smem_raw);
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  const long long row = row0 + w;
  T* const W = group + w * kWords;

  // stage: packed entry (k, m), m >= k, of row row0 + r into row r's
  // triangle at (m, k).  Warp w takes the columns k = w, w + kRows, ...;
  // lane (h, r) takes row r and, in each 32-row block of the column, the
  // rows h, h + H, ...: one instruction reads H entries of kRows
  // consecutive rows, H 32-byte sectors
  {
    constexpr int H = 32 / kRows;
    const int r = lane % kRows, h = lane / kRows;
    const bool live = row0 + r < B;
    T* const dst_r = group + r * kWords;
    const T* const src_r = Pp + (row0 + r) * p_sr;
    for (int k = w; k < K; k += kRows) {
      const int c = k % kPanel, rb = k / kPanel;
      const int ok = tri_off(k, K) - k;   // entry (k, m) at ok + m
#pragma unroll
      for (int q = 0; q < NB; ++q) {
        if (q < rb) continue;
        T* const dst = dst_r + blk_base(q, rb);
        const T* const src = src_r + (ok + kPanel * q) * p_sc;
#pragma unroll
        for (int t = 0; t < kPanel / H; ++t) {
          const int mm = h + H * t, m = kPanel * q + mm;
          if (live && m >= k && m < K) {
            cp_async<sizeof(T)>(dst + blk_off<T>(mm, c), src + mm * p_sc);
          }
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
      W[panel_vec<NB>() + k] = b[k * b_sk + row * b_sr];
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
int launch_nb(const T* Pp, long long p_sc, long long p_sr, const T* lam,
              double jitter, const T* b, long long b_sk, long long b_sr,
              const T* xi, T* u, int B, int K, cudaStream_t stream) {
  constexpr int kRows = panel_rows<T>();
  const int smem = panel_smem<T, NB>(kRows);
  cudaError_t err = cudaFuncSetAttribute(
      chol_sample_packed_slab_kernel<T, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  chol_sample_packed_slab_kernel<T, NB><<<blocks, kRows * 32, smem, stream>>>(
      Pp, p_sc, p_sr, lam, static_cast<T>(jitter), b, b_sk, b_sr, xi, u, B,
      K);
  return static_cast<int>(cudaGetLastError());
}

// K <= 64: two panels, else three
template <typename T>
int launch(const T* Pp, long long p_sc, long long p_sr, const T* lam,
           double jitter, const T* b, long long b_sk, long long b_sr,
           const T* xi, T* u, int B, int K, void* stream) {
  if (K < 1 || K > kMaxK || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return K <= 2 * kPanel
             ? launch_nb<T, 2>(Pp, p_sc, p_sr, lam, jitter, b, b_sk, b_sr,
                               xi, u, B, K, s)
             : launch_nb<T, 3>(Pp, p_sc, p_sr, lam, jitter, b, b_sk, b_sr,
                               xi, u, B, K, s);
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
