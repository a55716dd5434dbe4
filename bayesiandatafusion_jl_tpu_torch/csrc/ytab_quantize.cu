// Packed-triangle quantized partner table (K7): the fused path's per-sweep
// int8 partner operand, without ever storing the float32 table.
//
// Replaces the TPU kernels of bayesiandatafusion_jl_tpu/ops/pallas_ytab.py
// `ytab_quantize_pallas` (:125): `_kern_colmax` (:81) and `_kern_quant`
// (:99).  For U [n, K] float32 (K <= 96) and the table
//
//     T[p, c] = U[p, iu[c]] * U[p, ju[c]]   c < C = K(K+1)/2 (np.triu_indices)
//     T[p, C + k] = U[p, k]                 k < K
//
// it computes the per-column scales s[c] = max(max_{p < n_valid} |T[p, c]|
// * float32(1/127), FLT_MIN) and the codes clip(rint(T / s), +-127) as int8,
// written transposed, YZ8T [C + K, ld] (the contraction-major layout K8
// reads), rows p >= n exact zeros.  Bitwise equal to the plain version
// (ops/ytab.ytab_quantize_plain): the same float32 products, an exact max
// (order-free; non-negative floats compare as their bit patterns, so block
// partials merge with atomicMax), IEEE division (this file is built without
// fast-math) and round-half-even (rintf).
//
// What bounds it on an H100: its bytes, two reads of U and one int8 write
// of the table: (8 K + C + K) n bytes, 0.39 GB at n = 480,189, K = 32
// (0.117 ms at 3.35 TB/s); ~10 operations per table cell are far below the
// card's rate.
//
// Design: two launches, as on the TPU.  Each block stages 128 rows of U,
// transposed, in shared memory (pitch 132 floats, so that a lane's four
// consecutive rows are one aligned float4), and every warp walks a share of
// the C + K columns with four rows a lane: pass 1 reduces |T| over the
// block's rows with warp shuffles and merges its block maximum into the
// global column maxima with one atomicMax per column; pass 2 divides,
// rounds and packs four codes into one 32-bit store, so that a warp writes
// 128 contiguous bytes of a table row.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int TN = 128;          // rows per tile (32 lanes x 4)
constexpr int PITCH = TN + 4;    // floats per staged factor column
constexpr int NTHREADS = 256;
constexpr int MAX_K = 96;

// (i, j) of packed column c < C, in np.triu_indices order
__device__ void build_pairs(uint8_t* pi, uint8_t* pj, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < K; i += NTHREADS / 32) {
    const int off = i * K - i * (i - 1) / 2;
    for (int j = i + lane; j < K; j += 32) {
      pi[off + j - i] = static_cast<uint8_t>(i);
      pj[off + j - i] = static_cast<uint8_t>(j);
    }
  }
}

// stage rows [r0, r0 + TN) of U, transposed, rows >= n_rows as zeros
__device__ void stage(float* uT, const float* __restrict__ U, long long r0,
                      long long n_rows, int K) {
  for (int e = threadIdx.x; e < TN * K; e += NTHREADS) {
    const int r = e / K, k = e % K;
    const long long p = r0 + r;
    uT[k * PITCH + r] = p < n_rows ? U[p * K + k] : 0.0f;
  }
}

// the table's four entries (rows 4 lane .. 4 lane + 3) of column c
__device__ __forceinline__ float4 cell4(const float* uT, const uint8_t* pi,
                                        const uint8_t* pj, int c, int C,
                                        int lane) {
  if (c >= C)
    return *reinterpret_cast<const float4*>(uT + (c - C) * PITCH + 4 * lane);
  const float4 a = *reinterpret_cast<const float4*>(uT + pi[c] * PITCH + 4 * lane);
  const float4 b = *reinterpret_cast<const float4*>(uT + pj[c] * PITCH + 4 * lane);
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y),
                     __fmul_rn(a.z, b.z), __fmul_rn(a.w, b.w));
}

__global__ void __launch_bounds__(NTHREADS)
ytab_colmax_kernel(const float* __restrict__ U, long long n_valid, int K,
                   unsigned* __restrict__ colmax) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = K * (K + 1) / 2, CK = C + K;
  float* uT = reinterpret_cast<float*>(smem);
  float* bmax = uT + K * PITCH;
  uint8_t* pi = reinterpret_cast<uint8_t*>(bmax + CK);
  uint8_t* pj = pi + C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  build_pairs(pi, pj, K);
  for (int c = threadIdx.x; c < CK; c += NTHREADS) bmax[c] = 0.0f;
  const long long tiles = (n_valid + TN - 1) / TN;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    __syncthreads();
    stage(uT, U, t * TN, n_valid, K);
    __syncthreads();
    for (int c = warp; c < CK; c += NTHREADS / 32) {
      const float4 v = cell4(uT, pi, pj, c, C, lane);
      float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                      fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      if (lane == 0) bmax[c] = fmaxf(bmax[c], m);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < CK; c += NTHREADS)
    atomicMax(colmax + c, __float_as_uint(bmax[c]));
}

__global__ void __launch_bounds__(NTHREADS)
ytab_quant_kernel(const float* __restrict__ U, long long n, int K,
                  const unsigned* __restrict__ colmax, float inv127,
                  float* __restrict__ scale, int8_t* __restrict__ out,
                  long long ld) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = K * (K + 1) / 2, CK = C + K;
  float* uT = reinterpret_cast<float*>(smem);
  float* s = uT + K * PITCH;
  uint8_t* pi = reinterpret_cast<uint8_t*>(s + CK);
  uint8_t* pj = pi + C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  build_pairs(pi, pj, K);
  for (int c = threadIdx.x; c < CK; c += NTHREADS) {
    s[c] = fmaxf(__fmul_rn(__uint_as_float(colmax[c]), inv127), FLT_MIN);
    if (blockIdx.x == 0) scale[c] = s[c];
  }
  const long long r0 = static_cast<long long>(blockIdx.x) * TN;
  stage(uT, U, r0, n, K);
  __syncthreads();
  const long long p = r0 + 4 * lane;
  if (p >= ld) return;
  for (int c = warp; c < CK; c += NTHREADS / 32) {
    const float4 v = cell4(uT, pi, pj, c, C, lane);
    const float sc = s[c];
    const float q[4] = {v.x, v.y, v.z, v.w};
    uint32_t w = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float r = fminf(fmaxf(rintf(__fdiv_rn(q[e], sc)), -127.0f), 127.0f);
      w |= (static_cast<uint32_t>(static_cast<int>(r)) & 0xffu) << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(out + c * ld + p) = w;
  }
}

size_t smem_bytes(int K) {
  const int C = K * (K + 1) / 2;
  return sizeof(float) * (static_cast<size_t>(K) * PITCH + C + K) + 2 * C;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  U is contiguous [n, K] float32,
// 1 <= K <= 96, n_valid <= n rows enter the scales; colmax is [C + K]
// scratch (zeroed here); scale receives the [C + K] float32 scales and out
// the codes, contiguous [C + K, ld] int8 with ld >= n a multiple of 4 (rows
// past n are zero).  Both passes go on `stream`.  Returns the first CUDA
// error (0 on success).
extern "C" int bdf_ytab_quantize(const float* U, long long n,
                                 long long n_valid, int K, float inv127,
                                 unsigned* colmax, float* scale, void* out,
                                 long long ld, void* stream) {
  if (K < 1 || K > MAX_K || n_valid > n || n > ld || ld % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const int CK = K * (K + 1) / 2 + K;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(smem_bytes(K));
  cudaError_t err;
  for (auto kern : {reinterpret_cast<const void*>(ytab_colmax_kernel),
                    reinterpret_cast<const void*>(ytab_quant_kernel)}) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaMemsetAsync(colmax, 0, sizeof(unsigned) * CK, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n_valid + TN - 1) / TN;
  if (tiles > 0) {
    const unsigned blocks = static_cast<unsigned>(tiles < 528 ? tiles : 528);
    ytab_colmax_kernel<<<blocks, NTHREADS, smem, st>>>(U, n_valid, K, colmax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long out_tiles = (ld + TN - 1) / TN;
  if (out_tiles == 0) return 0;
  ytab_quant_kernel<<<static_cast<unsigned>(out_tiles), NTHREADS, smem, st>>>(
      U, n, K, colmax, inv127, scale, static_cast<int8_t*>(out), ld);
  return static_cast<int>(cudaGetLastError());
}
