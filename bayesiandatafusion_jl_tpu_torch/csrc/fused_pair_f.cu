// Fused masked-pair contraction with float operands (K8, float variants):
// both Gramian orientations of the fused sparse regime from the ONE stored
// int8 value array, for a relation that is off the s8 path.
//
// Replaces the TPU kernels of bayesiandatafusion_jl_tpu/ops/pallas_fused.py
// `fused_pair_pallas` (:345) in its float variants: flip_out
// `_kern_focus_rows_t` (:252) / `_kern_focus_cols_t` (:280) and the natural
// layout `_kern_focus_rows` (:303) / `_kern_focus_cols` (:322).  With V8
// [n0, n1] the stored codes (0 = unobserved) and YZT [C+K, n_contract] the
// partner table [Ypack | U] in the operand type (bfloat16, float32 or
// float64), transposed so that the contraction axis is contiguous, it
// computes for the focus mode f (f = 0: V8's rows, contracting n1; f = 1:
// V8's columns, contracting n0)
//
//     PM[c, i] = sum_p (V8_f[i, p] != 0) * YZT[c, p]      c < C + K
//     BV[k, i] = sum_p  V8_f[i, p]       * YZT[C + k, p]  k < K
//
// with the 0/1 mask and the codes cast to the operand type (codes up to
// 127 are exact in bfloat16) and the sums accumulated in float32 (float64
// for float64 operands), written in the packed sampler's layout
// (PM [C+K, n_focus], BV [K, n_focus]) or the natural one (PM [n_focus,
// C+K], BV [n_focus, K]).  No transposed copy of V8 and no mask in device
// memory.
//
// What bounds it on an H100: 2 n0 n1 (C + 2K) operations, 1.01e13 at the
// Netflix shape (480,189 x 17,770, K = 32): 10.2 ms at the 989 TFLOP/s
// dense bfloat16 peak, 151 ms at 67 TFLOP/s in float32; its bytes (V8 8.5
// GB once, the f32 outputs 1.1 GB) are 2.9 ms at 3.35 TB/s.
//
// Two kernels:
//   - bfloat16 operands: the int8 kernel's design (fused_pair_i8.cu) on
//     `mma.sync.m16n8k16.bf16` with float32 accumulators.  A CTA of 8 warps
//     computes 128 focus rows x 128 virtual columns in 64-element steps
//     through two shared-memory stages; the V8 tile is widened from int8 to
//     bfloat16 on the way to shared memory, twice (codes and 0/1 mask).  A
//     tile row is 128 bytes as in the int8 kernel, so the swizzle and the
//     fragment addresses are the same.  For focus columns each thread loads
//     16 focus columns of two neighbouring contraction rows and stores the
//     16 (k, k+1) pairs as 32-bit words of the transposed tile.
//     The tensor cores add each step's products into the accumulator with
//     truncation, which biases a long sum of one sign low (the diagonal of
//     P of a heavy row); so each stage's four steps accumulate from zero
//     and are added to the running sums by ordinary float32 adds.
//   - float32 / float64 operands: a tiled FMA kernel (64 x 64 outputs a
//     CTA, 4 x 4 a thread, 16 contraction elements a step), no TF32: it is
//     the parity seam (compute dtype operands), not the fast path.
#include "fused_pair.cuh"

namespace {

using namespace fused_pair;

struct Args {
  const int8_t* v8;      // [n0, n1], n0 and n1 multiples of 16
  long long n0, n1;
  const void* yzt;       // [C + K, n_contract] in the operand type
  int C, K, ckp;         // ckp: first value column (C + K rounded up)
  long long nf;          // focus rows written (<= stored focus extent)
  void* pm;              // [C + K, nf], natural layout [nf, C + K]
  void* bv;              // [K, nf], natural layout [nf, K]
};

// signed byte j of a 32-bit word
__device__ __forceinline__ int sbyte(uint32_t w, int j) {
  return static_cast<int>(w << (24 - 8 * j)) >> 24;
}

// two int8 codes as a packed bfloat16 pair (exact: |code| <= 127 has at
// most 7 significant bits), lo in the low half
__device__ __forceinline__ uint32_t code2(int lo, int hi) {
  return (__float_as_uint(static_cast<float>(lo)) >> 16) |
         (__float_as_uint(static_cast<float>(hi)) & 0xffff0000u);
}

// their 0/1 mask as a packed bfloat16 pair (1.0 = 0x3f80)
__device__ __forceinline__ uint32_t mask2(int lo, int hi) {
  return (lo != 0 ? 0x3f80u : 0u) | (hi != 0 ? 0x3f800000u : 0u);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int BKE = BK / 2;    // bfloat16 contraction elements per stage

template <int FOCUS, bool NAT>
__global__ void __launch_bounds__(NTHREADS)
fused_pair_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sA = smem;              // 2 stages x [BM][BKE] codes
  unsigned char* sM = smem + 2 * TILE;   // 2 stages x [BM][BKE] 0/1 mask
  unsigned char* sB = smem + 4 * TILE;   // 2 stages x [BN][BKE]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int v0 = blockIdx.x * BN;
  const long long n_contract = FOCUS == 0 ? a.n1 : a.n0;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * WARP_N;
  const bool raw = v0 + wn >= a.ckp;     // warp-uniform: value columns

  // B rows this thread loads (virtual columns tid/8 + 32i, chunk tid%8)
  const int lch = tid & 7;
  const unsigned char* bsrc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = src_row(a.C + a.K, a.C, a.K, a.ckp, v0 + (tid >> 3) + 32 * i);
    bsrc[i] = s < 0 ? nullptr
                    : static_cast<const unsigned char*>(a.yzt) +
                          2 * static_cast<long long>(s) * n_contract;
  }

  uint4 rb[4];
  uint4 ra[2];

  // k0: first contraction element of the stage
  auto load = [&](long long k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long k = k0 + lch * 8;
      rb[i] = make_uint4(0, 0, 0, 0);
      if (bsrc[i] != nullptr && k < n_contract)
        rb[i] = __ldg(reinterpret_cast<const uint4*>(bsrc[i] + 2 * k));
    }
    if constexpr (FOCUS == 0) {
      // focus rows tid/4 + 64i, contraction elements k0 + 16 (tid%4) ..
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const long long row = m0 + (tid >> 2) + 64 * i;
        const long long k = k0 + (tid & 3) * 16;
        ra[i] = make_uint4(0, 0, 0, 0);
        if (row < a.n0 && k < a.n1)
          ra[i] = __ldg(reinterpret_cast<const uint4*>(a.v8 + row * a.n1 + k));
      }
    } else {
      // contraction rows k0 + 2 (tid/8) + r; focus columns m0 + 16 (tid%8)
      const long long col = m0 + 16 * (tid & 7);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long row = k0 + 2 * (tid >> 3) + r;
        ra[r] = make_uint4(0, 0, 0, 0);
        if (row < a.n0 && col < a.n1)
          ra[r] = __ldg(reinterpret_cast<const uint4*>(a.v8 + row * a.n1 + col));
      }
    }
  };

  auto store = [&](int stage) {
    unsigned char* tA = sA + stage * TILE;
    unsigned char* tM = sM + stage * TILE;
    unsigned char* tB = sB + stage * TILE;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(tB + soff<FOCUS>((tid >> 3) + 32 * i, lch)) = rb[i];
    if constexpr (FOCUS == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = (tid >> 2) + 64 * i;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // codes 8h .. 8h + 7 of the 16: words 2h and 2h + 1
          const uint32_t w0 = word(ra[i], 2 * h), w1 = word(ra[i], 2 * h + 1);
          const int b[8] = {sbyte(w0, 0), sbyte(w0, 1), sbyte(w0, 2), sbyte(w0, 3),
                            sbyte(w1, 0), sbyte(w1, 1), sbyte(w1, 2), sbyte(w1, 3)};
          const int o = soff<FOCUS>(row, 2 * (tid & 3) + h);
          *reinterpret_cast<uint4*>(tA + o) =
              make_uint4(code2(b[0], b[1]), code2(b[2], b[3]),
                         code2(b[4], b[5]), code2(b[6], b[7]));
          *reinterpret_cast<uint4*>(tM + o) =
              make_uint4(mask2(b[0], b[1]), mask2(b[2], b[3]),
                         mask2(b[4], b[5]), mask2(b[6], b[7]));
        }
      }
    } else {
      const int kp = tid >> 3;           // contraction pair 2 kp, 2 kp + 1
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w0 = word(ra[0], q), w1 = word(ra[1], q);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lo = sbyte(w0, j), hi = sbyte(w1, j);
          const int o = soff<FOCUS>(16 * (tid & 7) + 4 * q + j, kp >> 2) + (kp & 3) * 4;
          *reinterpret_cast<uint32_t*>(tA + o) = code2(lo, hi);
          *reinterpret_cast<uint32_t*>(tM + o) = mask2(lo, hi);
        }
      }
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  const int nk = static_cast<int>((n_contract + BKE - 1) / BKE);
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    store(stage);
    __syncthreads();
    if (kt + 1 < nk) load(static_cast<long long>(kt + 1) * BKE);
    const unsigned char* tA = (raw ? sA : sM) + stage * TILE;
    const unsigned char* tB = sB + stage * TILE;
    float part[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mi][ni][e] = 0.0f;
#pragma unroll
    for (int s = 0; s < BKE / 16; ++s) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(tA + soff<FOCUS>(r, 2 * s) + tig * 4);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(tA + soff<FOCUS>(r + 8, 2 * s) + tig * 4);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(tA + soff<FOCUS>(r, 2 * s + 1) + tig * 4);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(tA + soff<FOCUS>(r + 8, 2 * s + 1) + tig * 4);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn + ni * 8 + g;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(tB + soff<FOCUS>(c, 2 * s) + tig * 4);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(tB + soff<FOCUS>(c, 2 * s + 1) + tig * 4);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(part[mi][ni], af[mi], b0, b1);
      }
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] += part[mi][ni][e];
  }

  // epilogue: sum (row g + 8h, column 2 tig + e) of each 16 x 8 tile
  const int ck = a.C + a.K;
  float* pm = static_cast<float*>(a.pm);
  float* bv = static_cast<float*>(a.bv);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + wm + mi * 16 + g + 8 * h;
      if (m >= a.nf) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + wn + ni * 8 + 2 * tig + e;
          const float val = acc[mi][ni][2 * h + e];
          if (v < ck) {
            if constexpr (NAT) pm[m * ck + v] = val;
            else pm[v * a.nf + m] = val;
          } else if (v >= a.ckp && v - a.ckp < a.K) {
            const int k = v - a.ckp;
            if constexpr (NAT) bv[m * a.K + k] = val;
            else bv[k * a.nf + m] = val;
          }
        }
      }
    }
  }
}

// ---- float32 / float64 operands: tiled FMA --------------------------------

constexpr int FT = 64;         // focus rows and virtual columns per CTA
constexpr int FK = 16;         // contraction elements per step

template <typename T, int FOCUS, bool NAT>
__global__ void __launch_bounds__(256)
fused_pair_fma_kernel(const Args a) {
  __shared__ T sA[FK][FT + 1];   // mask or codes, by the CTA's columns
  __shared__ T sB[FK][FT + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = static_cast<long long>(blockIdx.y) * FT;
  const int v0 = blockIdx.x * FT;
  const long long n_contract = FOCUS == 0 ? a.n1 : a.n0;
  const bool raw = v0 >= a.ckp;        // CTA-uniform: ckp is a multiple of FT
  const T* yzt = static_cast<const T*>(a.yzt);

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (long long k0 = 0; k0 < n_contract; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + 256 * i;
      // neighbouring threads along V8's contiguous axis
      const int k = FOCUS == 0 ? e & (FK - 1) : e >> 6;
      const int m = FOCUS == 0 ? e >> 4 : e & (FT - 1);
      const long long row = FOCUS == 0 ? m0 + m : k0 + k;
      const long long col = FOCUS == 0 ? k0 + k : m0 + m;
      int c = 0;
      if (row < a.n0 && col < a.n1) c = a.v8[row * a.n1 + col];
      sA[k][m] = raw ? static_cast<T>(c) : static_cast<T>(c != 0);
      const int kb = e & (FK - 1), vb = e >> 4;
      const int s = src_row(a.C + a.K, a.C, a.K, a.ckp, v0 + vb);
      T b = T(0);
      if (s >= 0 && k0 + kb < n_contract)
        b = yzt[static_cast<long long>(s) * n_contract + k0 + kb];
      sB[kb][vb] = b;
    }
    __syncthreads();
    // each step's 16 products are summed from zero and then added to the
    // running sums: a blocked sum, whose rounding error grows with the
    // number of steps and not with the length of the contraction
    T part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = T(0);
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      T x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] += x[i] * y[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  const int ck = a.C + a.K;
  T* pm = static_cast<T*>(a.pm);
  T* bv = static_cast<T*>(a.bv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= a.nf) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx + 16 * j;
      if (v < ck) {
        if constexpr (NAT) pm[m * ck + v] = acc[i][j];
        else pm[v * a.nf + m] = acc[i][j];
      } else if (v >= a.ckp && v - a.ckp < a.K) {
        const int k = v - a.ckp;
        if constexpr (NAT) bv[m * a.K + k] = acc[i][j];
        else bv[k * a.nf + m] = acc[i][j];
      }
    }
  }
}

// grid of `tile`-sized CTAs over (virtual columns, focus rows), or an error
int grid_for(const Args& a, int focus, int tile, dim3* grid) {
  const long long n_focus = focus == 0 ? a.n0 : a.n1;
  const long long tiles = (a.nf + tile - 1) / tile;
  if (tiles > 65535 || a.nf > n_focus) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3((a.ckp + a.K + tile - 1) / tile, static_cast<unsigned>(tiles));
  return 0;
}

template <int FOCUS, bool NAT>
int launch_bf16(Args a, void* stream) {
  a.ckp = (a.C + a.K + WARP_N - 1) / WARP_N * WARP_N;
  const int smem = 6 * TILE;
  auto kern = fused_pair_bf16_kernel<FOCUS, NAT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid;
  if (int rc = grid_for(a, FOCUS, BM, &grid)) return rc;
  if (a.nf == 0) return 0;
  kern<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int FOCUS, bool NAT>
int launch_fma(Args a, void* stream) {
  a.ckp = (a.C + a.K + FT - 1) / FT * FT;
  dim3 grid;
  if (int rc = grid_for(a, FOCUS, FT, &grid)) return rc;
  if (a.nf == 0) return 0;
  fused_pair_fma_kernel<T, FOCUS, NAT>
      <<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int FOCUS, bool NAT>
int launch_any(const Args& a, int dtype, void* stream) {
  if (dtype == 0) return launch_bf16<FOCUS, NAT>(a, stream);
  if (dtype == 1) return launch_fma<float, FOCUS, NAT>(a, stream);
  return launch_fma<double, FOCUS, NAT>(a, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes).  v8 is contiguous [n0, n1] int8
// with n0 and n1 multiples of 16; yzt is contiguous [C + K, n_contract]
// (n_contract = n1 for focus 0, n0 for focus 1) of bfloat16 (dtype 0),
// float32 (1) or float64 (2); nf <= the focus extent.  pm and bv are float32
// (float64 for dtype 2): [C + K, nf] and [K, nf], or with nat = 1 [nf, C + K]
// and [nf, K].  Returns the launch's CUDA error (0 on success).
extern "C" int bdf_fused_pair_f(const void* v8, long long n0, long long n1,
                                int focus, const void* yzt, int dtype, int C,
                                int K, long long nf, int nat, void* pm,
                                void* bv, void* stream) {
  if (n0 % 16 || n1 % 16 || C < 1 || K < 1 || (focus != 0 && focus != 1) ||
      dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.v8 = static_cast<const int8_t*>(v8);
  a.n0 = n0;
  a.n1 = n1;
  a.yzt = yzt;
  a.C = C;
  a.K = K;
  a.ckp = 0;
  a.nf = nf;
  a.pm = pm;
  a.bv = bv;
  if (focus == 0)
    return nat ? launch_any<0, true>(a, dtype, stream)
               : launch_any<0, false>(a, dtype, stream);
  return nat ? launch_any<1, true>(a, dtype, stream)
             : launch_any<1, false>(a, dtype, stream);
}
