// Full-P Cholesky factorize-solve-sample, two rows a warp (K <= 32): the
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
// reading the lower triangle of P[r] (warp_chol.cuh `half_chol_sample`,
// shared with K1).
//
// What bounds it on an H100: per row it must read the lower triangle,
// K(K+1)/2 floats (2.1 KB at K = 32 in float32), plus 2K floats of b and xi,
// and write K; it does ~K^3/3 + 2K^2 floating-point operations (13k at
// K = 32).  At B = 71,567 that is ~170 MB (0.05 ms at 3.35 TB/s) and
// ~0.9 GFLOP (0.014 ms at 67 TFLOP/s): the read stream is the floor.  The
// instruction stream of the register factorization is the limit in
// practice, as in K1.  On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md):
// 0.2855 ms at B = 71,567 with Lambda, 0.2381 without, 0.7751 at
// 200,000; the shuffle design this replaced ran 1.1588, 1.0819 and 3.2046
// ms in the same call.
//
// Design: K1's core with a different loader.  The TPU kernel put the batch
// on the 128 lanes and padded it to the tile with identity rows.  Here each
// warp owns two consecutive rows: it copies the lower triangle of each
// P[r], whose rows lie in K*K contiguous floats, into shared memory with
// cp.async, neighbouring lanes on neighbouring addresses (coalesced; the
// upper triangle is not fetched), packed row by row (row i at i(i+1)/2), so
// that the lanes' reads of their rows fall in distinct banks.  Lane l of
// each half-warp then holds the rows l and 31 - l in registers, adding
// jitter on the diagonal and Lambda on load, and the same shared words then
// hold the matrix's L for the backward solve.  Rows past B are masked, not
// padded.  K1's persistent double buffering, a warp's next two rows in
// flight, measured slower here (0.3302 against 0.2855 ms), so each block
// takes one group.  110 registers, no spills, 16 resident warps a SM.
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 2 * kWarps;     // rows (matrices) a block, two a warp

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
chol_sample_full_kernel(const T* __restrict__ P, const T* __restrict__ lam,
                        T jitter, const T* __restrict__ b,
                        const T* __restrict__ xi, T* __restrict__ u, int B,
                        int K) {
  // each matrix's lower triangle, packed; after the register fill, its L
  __shared__ T tile[kRows * kTri];
  __shared__ alignas(16) T col[kWarps][2][2][kRegK];
  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows + 2 * w;
  if (row0 >= B) return;  // whole warp leaves together; no block-wide sync
  T* t = tile + 2 * w * kTri;

  for (int q = 0; q < 2; ++q) {
    if (row0 + q < B) {
      const T* Pr = P + (row0 + q) * K * K;
      for (int i = 0; i < K; ++i) {
        if (lane <= i) {
          cp_async<sizeof(T)>(t + q * kTri + i * (i + 1) / 2 + lane,
                              Pr + i * K + lane);
        }
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  const int h = lane / kHalf;
  const int l = lane % kHalf;
  const int rb = kRegK - 1 - l;
  const long long row = row0 + h;
  const bool in = row < B;
  T* th = t + h * kTri;

  // rows l and rb of P', identity rows for a row past B
  T a[kHalf], c[kRegK];
  fill_rows<T>(a, c, l, K, in, [&](int i, int k) {
    T v = th[i * (i + 1) / 2 + k];
    if (k == i) v = v + jitter;
    if (lam != nullptr) v = v + lam[i * K + k];
    return v;
  });
  const T b_a = in && l < K ? b[row * K + l] : T(0);
  const T b_c = in && rb < K ? b[row * K + rb] : T(0);
  const T xi_a = in && l < K ? xi[row * K + l] : T(0);
  const T xi_c = in && rb < K ? xi[row * K + rb] : T(0);
  __syncwarp();                            // the staged words are free for L

  T u_a, u_c;
  half_chol_sample<T>(a, c, b_a, b_c, xi_a, xi_c, K, l, &col[w][0][h][0],
                      th, u_a, u_c);
  if (in) {
    if (l < K) u[row * K + l] = u_a;
    if (rb < K) u[row * K + rb] = u_c;
  }
}

template <typename T>
int launch(const T* P, const T* lam, double jitter, const T* b, const T* xi,
           T* u, int B, int K, void* stream) {
  if (K < 1 || K > kRegK || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((B + kRows - 1) / kRows);
  chol_sample_full_kernel<T><<<blocks, kWarps * 32, 0,
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
