// Packed-triangle Cholesky factorize-solve-sample, two rows a warp (K <= 32).
//
// Replaces the TPU kernel bayesiandatafusion_jl_tpu/ops/pallas_chol.py
// `_chol_sample_packed_kernel` (:178, arithmetic in `_chol_solve_sample` :44),
// called through `chol_sample_packed` (:192).  For every row r it computes
//
//     P' = unpack(Pp[:, r]) + (Lambda + jitter I),   L = chol(P'),
//     u[r] = L^-T (L^-1 b[:, r] + xi[r])
//
// (warp_chol.cuh `half_chol_sample`, shared with K3).
//
// What bounds it on an H100: per row it reads C = K(K+1)/2 packed floats
// (528 * 4 B = 2.1 KB at K = 32) plus 2K floats of b and xi, and does
// about K^3/6 = 5.5k multiply-adds.  At B = 71,567 that is 0.053 ms of
// reads at 3.35 TB/s and ~0.02 ms of float32 multiply-adds: the read
// stream is the floor.  In practice the instruction stream is the limit.
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md): 0.2904 ms at B = 71,567,
// 1.9050 at 480,189, 0.0516 at 10,681; the shuffle-per-pivot-pair design
// this replaced (7,944 SASS instructions a row, 1,056 of them shuffles)
// ran 0.9115, 5.9618 and 0.1711 ms in the same call.
//
// Design: the TPU put the batch on the 128 lanes and padded it to the tile
// with identity rows.  Here a group of kRows = 2 kWarps consecutive rows
// is one block's unit of work, and the blocks are persistent: one grid
// fills the card, and a block takes every gridDim.x-th group.  It copies a
// group's packed triangles and right-hand sides into shared memory with
// cp.async, neighbouring threads on neighbouring rows, so the [C, B] reads
// coalesce; both strides are taken, so the Gramian's padded [C, N_stored]
// output is read as a view.  The next group's copies go into a second
// buffer while the block factors this one.  Rows past B get P' = Lambda +
// jitter I and are not written.  Each half-warp takes one row: lane l
// holds the matrix rows l and 31 - l in registers, and the warp factors
// and solves both matrices together (warp_chol.cuh).  Once the registers
// are filled, the group's tile holds each matrix's L for the backward
// solve.  Each mechanism against the simpler choice, at B = 71,567 in one
// call (PERF.md): the cp.async copies against plain loads 0.3174 against
// 0.5322 ms; persistent double-buffered blocks against a block a group
// 0.2919 against 0.3174; two rows a warp against one 0.3174 against
// 0.4419.  120 registers, no spills, 16 resident warps a SM.
#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 2 * kWarps;     // rows (matrices) a group, two a warp
constexpr int kPitch = kRows + 1;     // shared tile pitch
constexpr int kTileP = kTri * kPitch;  // a group's packed triangles
constexpr int kTileB = kRegK * kPitch; // a group's right-hand sides
constexpr int kCols = kWarps * 4 * kRegK;  // the warps' column buffers

// Start copying group g's triangles and right-hand sides into tp / tb,
// neighbouring threads on neighbouring rows (zeros past B).
template <typename T>
__device__ __forceinline__ void load_group(
    T* tp, T* tb, long long g, const T* __restrict__ Pp, long long p_sc,
    long long p_sr, const T* __restrict__ b, long long b_sk, long long b_sr,
    int B, int K) {
  const int C = K * (K + 1) / 2;
  const long long row0 = g * kRows;
  for (int e = threadIdx.x; e < C * kRows; e += blockDim.x) {
    const int c = e / kRows, r = e % kRows;
    const long long row = row0 + r;
    T* dst = tp + c * kPitch + r;
    if (row < B) {
      cp_async<sizeof(T)>(dst, Pp + c * p_sc + row * p_sr);
    } else {
      *dst = T(0);
    }
  }
  for (int e = threadIdx.x; e < K * kRows; e += blockDim.x) {
    const int k = e / kRows, r = e % kRows;
    const long long row = row0 + r;
    T* dst = tb + k * kPitch + r;
    if (row < B) {
      cp_async<sizeof(T)>(dst, b + k * b_sk + row * b_sr);
    } else {
      *dst = T(0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Persistent: block i takes the groups i, i + gridDim.x, ...; while it
// factors one, the next one's copies are in flight into the other buffer.
template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
chol_sample_packed_kernel(const T* __restrict__ Pp, long long p_sc,
                          long long p_sr, const T* __restrict__ lam,
                          T jitter, const T* __restrict__ b, long long b_sk,
                          long long b_sr, const T* __restrict__ xi,
                          T* __restrict__ u, int B, int K) {
  // the warps' column buffers, then two buffers of a group's tiles; once
  // the registers are filled, a group's triangle tile holds its L
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const cols = reinterpret_cast<T*>(smem_raw);
  T* const tiles = cols + kCols;
  const long long groups = (static_cast<long long>(B) + kRows - 1) / kRows;
  const int w = threadIdx.x / 32;
  const int h = (threadIdx.x % 32) / kHalf;
  const int l = threadIdx.x % kHalf;
  const int rb = kRegK - 1 - l;
  const int m = 2 * w + h;                 // the group's matrix
  T* const col = cols + w * 4 * kRegK + h * kRegK;

  long long g = blockIdx.x;
  if (g < groups) {
    load_group(tiles, tiles + kTileP, g, Pp, p_sc, p_sr, b, b_sk, b_sr, B, K);
  }
  for (int it = 0; g < groups; ++it, g += gridDim.x) {
    T* const tp = tiles + (it & 1) * (kTileP + kTileB);
    T* const tb = tp + kTileP;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // the group is in; the other buffer's L is done
    if (g + gridDim.x < groups) {
      T* const next = tiles + ((it + 1) & 1) * (kTileP + kTileB);
      load_group(next, next + kTileP, g + gridDim.x, Pp, p_sc, p_sr, b,
                 b_sk, b_sr, B, K);
    }

    // rows l and rb of P': entry (i, k), k <= i, is triu index
    // k K - k (k - 1) / 2 + i - k
    T a[kHalf], c[kRegK];
    fill_rows<T>(a, c, l, K, true, [&](int i, int k) {
      T v = lam[i * K + k];
      if (k == i) v = v + jitter;
      return tp[(k * K - k * (k - 1) / 2 + i - k) * kPitch + m] + v;
    });
    const long long row = g * kRows + m;
    const bool in = row < B;
    const T b_a = l < K ? tb[l * kPitch + m] : T(0);
    const T b_c = rb < K ? tb[rb * kPitch + m] : T(0);
    const T xi_a = in && l < K ? xi[row * K + l] : T(0);
    const T xi_c = in && rb < K ? xi[row * K + rb] : T(0);
    __syncthreads();   // the triangle tile is free for L

    T u_a, u_c;
    half_chol_sample<T>(a, c, b_a, b_c, xi_a, xi_c, K, l, col,
                        tp + m * kTri, u_a, u_c);
    if (in) {
      if (l < K) u[row * K + l] = u_a;
      if (rb < K) u[row * K + rb] = u_c;
    }
  }
}

// Per dtype and device: the grid that fills the card once (resident
// blocks a SM times SMs), worked out at the first launch.
template <typename T>
int launch(const T* Pp, long long p_sc, long long p_sr, const T* lam,
           double jitter, const T* b, long long b_sk, long long b_sr,
           const T* xi, T* u, int B, int K, void* stream) {
  if (K < 1 || K > kRegK || B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  constexpr int kMaxDevices = 64;
  static long long full_grid[kMaxDevices] = {};
  const int smem = static_cast<int>(sizeof(T) * (kCols + 2 * (kTileP + kTileB)));
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (full_grid[dev] == 0) {
    int sms = 0, per_sm = 0;
    rc = cudaFuncSetAttribute(chol_sample_packed_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
    if (rc == cudaSuccess) {
      rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (rc == cudaSuccess) {
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, chol_sample_packed_kernel<T>, kWarps * 32, smem);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    full_grid[dev] = static_cast<long long>(sms) * per_sm;
  }
  const long long groups = (static_cast<long long>(B) + kRows - 1) / kRows;
  const unsigned blocks = static_cast<unsigned>(
      groups < full_grid[dev] ? groups : full_grid[dev]);
  chol_sample_packed_kernel<T><<<blocks, kWarps * 32, smem,
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
