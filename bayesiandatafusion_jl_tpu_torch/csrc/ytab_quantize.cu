// Packed-triangle quantized partner table (K7): the int8 pair's and the
// fused path's per-sweep int8 partner operand, without ever storing the
// float32 table.
//
// Replaces the TPU kernels of bayesiandatafusion_jl_tpu/ops/pallas_ytab.py
// `ytab_quantize_pallas` (:125): `_kern_colmax` (:81) and `_kern_quant`
// (:99), and above their K = 64 the JAX package's XLA `_quantize_cols`.
// For U [n, K] float32 (K <= 128) and the table
//
//     T[p, c] = U[p, iu[c]] * U[p, ju[c]]   c < C = K(K+1)/2 (np.triu_indices)
//     T[p, C + k] = U[p, k]                 k < K
//
// it computes the per-column scales s[c] = max(max_{p < n_valid} |T[p, c]|
// * float32(1/127), FLT_MIN) and the codes clip(rint(T / s), +-127) as int8,
// written transposed, YZ8T [C + K, ld] (the contraction-major layout K6 and
// K8 read), rows p >= n exact zeros.  Bitwise equal to the plain version
// (ops/ytab.ytab_quantize_plain): the same float32 products, an exact max
// (order-free; non-negative floats compare as their bit patterns, so block
// partials merge with atomicMax), the code of the correctly rounded
// quotient, and round-half-even.
//
// What bounds it on an H100: its bytes, U read twice and the int8 table
// written once, (8 K + C + K) n bytes (0.20 ms at n = 71,567, K = 128), and
// the ~11 instructions a table cell the quant pass executes, of the same
// order; measured (PERF.md) ~2.7x the bytes bound at K = 128.
//
// Design: two launches, as on the TPU (every code needs the grid-wide max).
// Both cut the table by rows and by columns, so that every shape fills the
// card.  A column is a pair (i, j) of the triangle's rows, i then j >= i;
// the U columns are the pairs (K, j) of a row K of ones.
// - colmax: a thread owns the quad of columns (i, 4Q .. 4Q + 3) of the
//   triangle's rows i = 2h and 2h + 1 (which start on the same quad) and
//   walks the row tiles of its block (64 rows of U staged by cp.async,
//   row-major, the ones in column K): per row two broadcast loads of
//   U[p, i] and one 16-byte load of U[p, 4Q ..] for 8 cells.  Its maxima
//   stay in registers across the tiles; one atomicMax a column a block,
//   into one of 8 copies of the maxima (blockIdx.y % 8), so that few
//   blocks meet on an address; the quant pass merges the copies.
// - quant: a block takes a 128-row tile of U (staged transposed by
//   cp.async, 4-row chunks swizzled across the banks) and a group of
//   consecutive packed columns, whose scales, reciprocals and pairs (a
//   16-bit table) it computes once.  Eight lanes cover a column's 128
//   rows, 16 a lane, and a warp four columns a step.  A code is
//   rint(q * (1/s)) unless that product lies within 2^-13 of a
//   half-integer, where only the correctly rounded q / s can decide it (1/s
//   within an ulp: |q * (1/s) - q / s| <= 1.5 2^-23 |q / s| < 2^-15.4 for
//   |q / s| <= 128); there the lane compares q with s times the midpoints
//   around that half-integer, exactly, in double (one rare branch a
//   column step).  rint is the 1.5 2^23 addition, whose low byte is the
//   code; a lane writes its 16 codes as one 16-byte store, so a warp
//   writes 128 contiguous bytes of four table rows.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int MAX_K = 128;
constexpr int NTHREADS = 256;       // a block of either pass
constexpr int NWARPS = NTHREADS / 32;
// quant
constexpr int TR = 128;             // rows a tile
constexpr int TPITCH = TR + 4;      // floats a staged column
constexpr int V = 16;               // rows (codes) a lane: one 16-byte store
constexpr int LPC = TR / V;         // lanes a column
constexpr int CPW = 32 / LPC;       // columns a warp step
constexpr int MAX_GROUP = 2048;     // columns a quant block
// colmax
constexpr int MR = 64;              // rows a tile
constexpr int COPIES = 8;           // copies of the column maxima
// rint by addition: |y| <= 127 plus 1.5 2^23 rounds y to an integer,
// half to even, and keeps it in the low bits
constexpr float MAGIC = 12582912.0f;
constexpr float NEAR_HALF = 0.5f - 0x1p-13f;

__device__ __forceinline__ int row_start(int i, int K) { return i < K ? i : 0; }

// packed column of the pair (i, j)
__device__ __forceinline__ int col_of(int i, int j, int K) {
  return i < K ? i * K - i * (i - 1) / 2 + (j - i) : K * (K + 1) / 2 + j;
}

// the pair (i, j) of packed column c
__device__ void pair_of(int c, int K, int& i, int& j) {
  const int C = K * (K + 1) / 2;
  if (c >= C) {
    i = K;
    j = c - C;
    return;
  }
  // i(2K + 1 - i) / 2 <= c: the smaller root, then exact steps
  const float b = 2.0f * K + 1.0f;
  int t = static_cast<int>((b - sqrtf(b * b - 8.0f * c)) * 0.5f);
  t = max(0, min(t, K - 1));
  while (t > 0 && t * K - t * (t - 1) / 2 > c) --t;
  while (t + 1 < K && (t + 1) * K - (t + 1) * t / 2 <= c) ++t;
  i = t;
  j = t + c - (t * K - t * (t - 1) / 2);
}

// 4-byte asynchronous copy global -> shared; zeros when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 16-byte asynchronous copy global -> shared; zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- colmax

// floats a staged row of U: K, the ones column, padding to the 16-byte
// loads of the last quad
__host__ __device__ constexpr int colmax_pitch(int K) { return 4 * ((K + 4) / 4); }

// stage rows [r0, r0 + MR) of U, rows >= n_valid zeros, into u [MR][P]:
// 16-byte copies when every row starts on 16 bytes (vec), else 4-byte ones
__device__ __forceinline__ void stage_rows(float* u, const float* __restrict__ U,
                                           long long r0, long long n_valid,
                                           int K, int P, bool vec) {
  if (vec) {
    const int kq = K / 4;
    for (int e = threadIdx.x; e < MR * kq; e += blockDim.x) {
      const int r = e / kq, k = 4 * (e - r * kq);
      const long long p = r0 + r;
      cp_async16(u + r * P + k, p < n_valid ? U + p * K + k : U, p < n_valid);
    }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int r = warp; r < MR; r += blockDim.x >> 5) {
      const long long p = r0 + r;
      for (int k = lane; k < K; k += 32)
        cp_async4(u + r * P + k, p < n_valid ? U + p * K + k : U, p < n_valid);
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
ytab_colmax_kernel(const float* __restrict__ U, long long n_valid, int K,
                   int group, bool vec, unsigned* __restrict__ colmax) {
  extern __shared__ __align__(16) float u[];
  const int P = colmax_pitch(K), nq = (K + 3) / 4, pairs = (K + 1) / 2;
  // this thread's columns (i0, 4Q .. 4Q + 3) and (i1, 4Q .. 4Q + 3): rows
  // i0 = 2h and i1 = 2h + 1 of the triangle share their first quad, the
  // one holding (i0, i0); the ones row K (U's columns) comes alone, as
  // does the last row of an odd K (i1 = i0)
  int t = blockIdx.x * group + threadIdx.x, h = 0;
  for (; h <= pairs; ++h) {
    const int len = nq - (h < pairs ? h / 2 : 0);
    if (t < len) break;
    t -= len;
  }
  const bool active = threadIdx.x < group && h <= pairs;
  const int i0 = h < pairs ? 2 * h : K;
  const int i1 = h < pairs && 2 * h + 1 < K ? 2 * h + 1 : i0;
  const int j0 = 4 * ((h < pairs ? h / 2 : 0) + t);
  for (int e = threadIdx.x; e < MR * (P - K); e += blockDim.x) {
    const int k = K + e % (P - K);
    u[e / (P - K) * P + k] = k == K ? 1.0f : 0.0f;
  }
  float m[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const long long tiles = (n_valid + MR - 1) / MR;
  for (long long tile = blockIdx.y; tile < tiles; tile += gridDim.y) {
    __syncthreads();
    stage_rows(u, U, tile * MR, n_valid, K, P, vec);
    cp_async_wait_all();
    __syncthreads();
    if (active) {
#pragma unroll 8
      for (int r = 0; r < MR; ++r) {
        const float a0 = u[r * P + i0], a1 = u[r * P + i1];
        const float4 b = *reinterpret_cast<const float4*>(u + r * P + j0);
        m[0] = fmaxf(m[0], fabsf(__fmul_rn(a0, b.x)));
        m[1] = fmaxf(m[1], fabsf(__fmul_rn(a0, b.y)));
        m[2] = fmaxf(m[2], fabsf(__fmul_rn(a0, b.z)));
        m[3] = fmaxf(m[3], fabsf(__fmul_rn(a0, b.w)));
        m[4] = fmaxf(m[4], fabsf(__fmul_rn(a1, b.x)));
        m[5] = fmaxf(m[5], fabsf(__fmul_rn(a1, b.y)));
        m[6] = fmaxf(m[6], fabsf(__fmul_rn(a1, b.z)));
        m[7] = fmaxf(m[7], fabsf(__fmul_rn(a1, b.w)));
      }
    }
  }
  if (!active) return;
  // one of COPIES copies of the maxima, so that fewer blocks meet on an
  // address
  unsigned* cm = colmax + (blockIdx.y % COPIES) * (K * (K + 1) / 2 + K);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int i = e < 4 ? i0 : i1, j = j0 + e % 4;
    if ((e < 4 || i1 != i0) && j >= row_start(i, K) && j < K)
      atomicMax(cm + col_of(i, j, K), __float_as_uint(m[e]));
  }
}

// ----------------------------------------------------------------- quant

// word offset of row r in a staged column: its 4-row chunk swizzled so
// that the eight lanes of a quarter warp read eight different bank quads
__device__ __forceinline__ int chunk_pos(int r) {
  const int ch = r >> 2;
  return 4 * (ch ^ ((ch >> 3) & 7)) + (r & 3);
}

__device__ __forceinline__ uint32_t pack4(float t0, float t1, float t2,
                                          float t3) {
  const uint32_t lo =
      __byte_perm(__float_as_uint(t0), __float_as_uint(t1), 0x0040);
  const uint32_t hi =
      __byte_perm(__float_as_uint(t2), __float_as_uint(t3), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// 1 / s within an ulp: the approximate reciprocal and a Newton step (s is
// a normal float up to 2^122, so its reciprocal is normal too)
__device__ __forceinline__ float recip(float s) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(s));
  return fmaf(r, fmaf(-s, r, 1.0f), r);
}

// MAGIC + the code of q / s, exact, from y ~ q / s: the half-integer h
// nearest y decides it, and RN(q / s) lies below, on or above h (an even
// float: ties go to it) as |q| lies below, between or above s times the
// midpoints around |h|, products exact in double (25 by 24 bits)
__device__ __forceinline__ float exact_code_sum(float q, float s, float y) {
  const float ah = fabsf(floorf(y) + 0.5f);
  const double lo =
      0.5 * (static_cast<double>(ah) + __uint_as_float(__float_as_uint(ah) - 1));
  const double hi =
      0.5 * (static_cast<double>(ah) + __uint_as_float(__float_as_uint(ah) + 1));
  const double aq = fabs(static_cast<double>(q));
  const float az = aq < lo * s ? ah - 0.5f : aq > hi * s ? ah + 0.5f : rintf(ah);
  return __fadd_rn(copysignf(fminf(az, 127.0f), q), MAGIC);
}

__global__ void __launch_bounds__(NTHREADS)
ytab_quant_kernel(const float* __restrict__ U, long long n, int K,
                  const unsigned* __restrict__ colmax, float inv127,
                  float* __restrict__ scale, int8_t* __restrict__ out,
                  long long ld, int groups, int group) {
  extern __shared__ __align__(16) float smem[];
  const int CK = K * (K + 1) / 2 + K;
  float* uT = smem;                        // K + 1 columns; [K] = ones
  float* sc = uT + (K + 1) * TPITCH;       // the group's scales
  float* rc = sc + group;                  // and their reciprocals
  uint16_t* pij = reinterpret_cast<uint16_t*>(rc + group);  // their pairs
  const int g = blockIdx.x % groups;
  const long long r0 = static_cast<long long>(blockIdx.x / groups) * TR;
  const int c0 = g * group, c1 = min(c0 + group, CK);
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // a warp stages 4 rows x 8 columns a step: 32 different banks
    for (int rb = 4 * warp; rb < TR; rb += 4 * NWARPS) {
      const int r = rb + (lane >> 3);
      const long long p = r0 + r;
      const bool valid = p < n;
      float* dst = uT + chunk_pos(r);
      for (int k = lane & 7; k < K; k += 8)
        cp_async4(dst + k * TPITCH, valid ? U + p * K + k : U, valid);
    }
  }
  for (int r = threadIdx.x; r < TR; r += NTHREADS) uT[K * TPITCH + r] = 1.0f;
  for (int c = c0 + threadIdx.x; c < c1; c += NTHREADS) {
    unsigned mx = 0;
#pragma unroll
    for (int k = 0; k < COPIES; ++k) mx = max(mx, colmax[k * CK + c]);
    const float s = fmaxf(__fmul_rn(__uint_as_float(mx), inv127), FLT_MIN);
    sc[c - c0] = s;
    rc[c - c0] = recip(s);
    if (r0 == 0) scale[c] = s;
    int i, j;
    pair_of(c, K, i, j);
    pij[c - c0] = static_cast<uint16_t>(i | j << 8);
  }
  cp_async_wait_all();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rl = lane % LPC;
  const long long p = r0 + rl * V;
  if (p >= ld) return;
  int pos[V / 4];
#pragma unroll
  for (int m = 0; m < V / 4; ++m) pos[m] = chunk_pos(rl * V + 4 * m);
  int ia = -1;
  float4 a[V / 4];
  for (int c = c0 + warp * CPW + lane / LPC; c < c1; c += NWARPS * CPW) {
    const int i = pij[c - c0] & 0xff, j = pij[c - c0] >> 8;
    if (i != ia) {
#pragma unroll
      for (int m = 0; m < V / 4; ++m)
        a[m] = *reinterpret_cast<const float4*>(uT + i * TPITCH + pos[m]);
      ia = i;
    }
    const float rs = rc[c - c0];
    uint32_t w[V / 4];
    float d[V / 4];
#pragma unroll
    for (int m = 0; m < V / 4; ++m) {
      const float4 b =
          *reinterpret_cast<const float4*>(uT + j * TPITCH + pos[m]);
      const float q[4] = {__fmul_rn(a[m].x, b.x), __fmul_rn(a[m].y, b.y),
                          __fmul_rn(a[m].z, b.z), __fmul_rn(a[m].w, b.w)};
      float t[4];
      d[m] = 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float y = fminf(fmaxf(__fmul_rn(q[e], rs), -127.0f), 127.0f);
        t[e] = __fadd_rn(y, MAGIC);
        d[m] = fmaxf(d[m], fabsf(__fsub_rn(y, __fsub_rn(t[e], MAGIC))));
      }
      w[m] = pack4(t[0], t[1], t[2], t[3]);
    }
    float dm = d[0];
#pragma unroll
    for (int m = 1; m < V / 4; ++m) dm = fmaxf(dm, d[m]);
    if (dm > NEAR_HALF) {
      // rare: a chunk with a product near a half-integer, again, exactly
      const float s = sc[c - c0];
#pragma unroll
      for (int m = 0; m < V / 4; ++m)
        if (d[m] > NEAR_HALF) {
          const float4 b =
              *reinterpret_cast<const float4*>(uT + j * TPITCH + pos[m]);
          const float q[4] = {__fmul_rn(a[m].x, b.x), __fmul_rn(a[m].y, b.y),
                              __fmul_rn(a[m].z, b.z), __fmul_rn(a[m].w, b.w)};
          float t[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            t[e] = exact_code_sum(
                q[e], s, fminf(fmaxf(__fmul_rn(q[e], rs), -127.0f), 127.0f));
          w[m] = pack4(t[0], t[1], t[2], t[3]);
        }
    }
    *reinterpret_cast<uint4*>(out + static_cast<long long>(c) * ld + p) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
}

int quant_smem(int K) {
  const int CK = K * (K + 1) / 2 + K;
  const int group = CK < MAX_GROUP ? CK : MAX_GROUP;
  return static_cast<int>(sizeof(float)) * (K + 1) * TPITCH +
         (2 * sizeof(float) + sizeof(uint16_t)) * group;
}

int colmax_smem(int K) {
  return static_cast<int>(sizeof(float)) * MR * colmax_pitch(K);
}

// the colmax pass's column groups: (groups, items a group), an item the
// eight columns of one quad of two triangle rows, or four of the ones row
void colmax_groups(int K, int* groups, int* group) {
  const int nq = (K + 3) / 4;
  int items = nq;
  for (int h = 0; h < (K + 1) / 2; ++h) items += nq - h / 2;
  *groups = (items + NTHREADS - 1) / NTHREADS;
  *group = (items + *groups - 1) / *groups;
}

// the device's SM count and each pass's resident blocks a SM, per K
struct Fit {
  int sms, quant, colmax;
};

cudaError_t fit(int K, Fit* f) {
  constexpr int MAX_DEV = 16;
  static Fit cache[MAX_DEV][MAX_K + 1];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEV && cache[dev][K].sms) {
    *f = cache[dev][K];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&f->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const void* kq = reinterpret_cast<const void*>(ytab_quant_kernel);
  const void* kc = reinterpret_cast<const void*>(ytab_colmax_kernel);
  for (const void* kern : {kq, kc}) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               quant_smem(MAX_K));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f->quant, kq, NTHREADS,
                                                      quant_smem(K));
  if (err != cudaSuccess) return err;
  int gc, group;
  colmax_groups(K, &gc, &group);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &f->colmax, kc, (group + 31) / 32 * 32, colmax_smem(K));
  if (err != cudaSuccess) return err;
  if (f->quant < 1 || f->colmax < 1) return cudaErrorInvalidConfiguration;
  if (dev < MAX_DEV) cache[dev][K] = *f;
  return cudaSuccess;
}

// column groups of the quant pass over `tiles` row tiles: the count whose
// busiest SM has the least work, a block's work its columns plus the
// staging of its tile (~half a column a factor column), derated when the
// SM holds fewer than 16 warps
int quant_groups(int K, long long tiles, const Fit& f) {
  const int CK = K * (K + 1) / 2 + K;
  const int lo = (CK + MAX_GROUP - 1) / MAX_GROUP;
  const int hi = lo > CK / 64 ? lo : CK / 64;
  int best = lo;
  double best_cost = 0.0;
  for (int G = lo; G <= hi; ++G) {
    const long long per_sm = (tiles * G + f.sms - 1) / f.sms;
    const long long resident = per_sm < f.quant ? per_sm : f.quant;
    const double warps = static_cast<double>(NWARPS * resident);
    const double cost = per_sm * ((CK + G - 1) / G + 0.5 * K) *
                        (warps < 16.0 ? 16.0 / warps : 1.0);
    if (G == lo || cost < best_cost) {
      best = G;
      best_cost = cost;
    }
  }
  return best;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  U is contiguous [n, K] float32,
// 1 <= K <= 128, n_valid <= n rows enter the scales; colmax is [8 (C + K)]
// scratch (zeroed here); scale receives the [C + K] float32 scales and out
// the codes, contiguous [C + K, ld] int8 with ld >= n a multiple of 16 (rows
// past n are zero).  Both passes go on `stream`.  Returns the first CUDA
// error (0 on success).
extern "C" int bdf_ytab_quantize(const float* U, long long n,
                                 long long n_valid, int K, float inv127,
                                 unsigned* colmax, float* scale, void* out,
                                 long long ld, void* stream) {
  if (K < 1 || K > MAX_K || n_valid < 0 || n_valid > n || n > ld || ld % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int CK = K * (K + 1) / 2 + K;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Fit f;
  cudaError_t err = fit(K, &f);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(colmax, 0, sizeof(unsigned) * COPIES * CK, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n_valid + MR - 1) / MR;
  if (tiles > 0) {
    int gc, group;
    colmax_groups(K, &gc, &group);
    // one wave of blocks, each walking the same number of row tiles
    const long long wave = (static_cast<long long>(f.sms) * f.colmax + gc - 1) / gc;
    const long long per = (tiles + wave - 1) / wave;
    const dim3 grid(gc, static_cast<unsigned>((tiles + per - 1) / per));
    const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(U) % 16 == 0;
    ytab_colmax_kernel<<<grid, (group + 31) / 32 * 32, colmax_smem(K), st>>>(
        U, n_valid, K, group, vec, colmax);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long out_tiles = (ld + TR - 1) / TR;
  if (out_tiles == 0) return 0;
  const int G = quant_groups(K, out_tiles, f);
  const int group = (CK + G - 1) / G;
  const int groups = (CK + group - 1) / group;
  ytab_quant_kernel<<<static_cast<unsigned>(out_tiles * groups), NTHREADS,
                      quant_smem(K), st>>>(U, n, K, colmax, inv127, scale,
                                           static_cast<int8_t*>(out), ld,
                                           groups, group);
  return static_cast<int>(cudaGetLastError());
}
