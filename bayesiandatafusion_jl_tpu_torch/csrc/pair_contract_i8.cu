// The int8 pair contraction on int8 tensor cores (K6): both Gramian
// orientations of the int8 pair path from ONE stored pair (M8, W8).
//
// Replaces the TPU kernels of bayesiandatafusion_jl_tpu/ops/pallas_pair.py
// `pair_contract_pallas` (:137): `_kern_pair_rows_tq` (:75, focus rows) and
// `_kern_pair_cols_tq` (:105, focus columns).  With M8 [n0, n1] the int8
// observation counts, W8 [n0, n1] the statically quantized centered values
// (pad cells 0) and YZ8T [C+K, n_contract] the partner table
// [Ypack | U] quantized per row (K7's layout), it computes for the focus
// mode f (f = 0: the rows, contracting n1; f = 1: the columns,
// contracting n0)
//
//     PM[c, i] = sum_p M8_f[i, p] * YZ8T[c, p]        c < C
//     BV[k, i] = sum_p W8_f[i, p] * YZ8T[C + k, p]    k < K
//
// exactly in int32 (s8 x s8 -> s32; the caller's `int8_pair_ok` keeps
// every sum below 2^31), written in the packed sampler's [., n_focus]
// layout: raw int32 PM [C, nf] and BV [K, nf], or the float32 dequant
// epilogue Pt = PM * syz[c], b = BV * sz[k] (one int32 -> float32
// conversion and one float32 multiply per element, as the plain version
// does).  Unlike the TPU kernel it computes no "count" columns (table rows
// C .. C+K-1 against M8), which that kernel sliced away.
//
// What bounds it on an H100: its bytes.  It reads M8 and W8 once (1.53 GB
// at ML-10M, 71,568 x 10,688 each), the table, and writes the float32
// outputs: 0.50 ms at 3.35 TB/s at K = 32, mode 0.  The operations its
// data needs (a multiply-add into each of the C + K outputs for each
// observed cell) are far fewer; its dense design multiplies every stored
// cell, 2 n0 n1 (C + K) operations, 0.43 ms at the 1,979 TOP/s dense int8
// peak at K = 32, 1.66 ms at K = 64.
//
// Design: a plain GEMM on `mma.sync.m16n8k32.s8` (csrc/fused_pair.cuh:
// the 128 x 128 CTA tile, 8 warps of 64 x 32 int32 sums, two shared-memory
// stages of 128-byte rows, the XOR swizzles).  Virtual columns [0, cp)
// run M8 against table rows 0 .. C-1, [cp, cp + K) run W8 against rows
// C .. C+K-1; cp is C rounded up to 32, so a warp is all-M or all-W.  Each
// stage holds an M8 tile and a W8 tile; a CTA whose columns are all
// M-columns loads only M8, one whose columns are all W-columns only W8.
// The one CTA column that holds both (when cp is not a multiple of 128)
// loads its second operand after storing the first, without overlap, so
// that no CTA holds more staging registers than K8a's.  Warps whose 32
// columns are all padding skip the products.  int8 mma takes both
// operands K-major (contiguous along the contraction):
//   - mode 0: a tile of the store is K-major as stored, copied as is;
//   - mode 1: the store is strided along the contraction, and Hopper's
//     8-bit mma has no transposed operand.  Each thread loads 16 bytes
//     (16 focus columns) of each of 4 contraction rows and transposes the
//     four 4 x 4-byte blocks in registers with __byte_perm before the
//     store (K8a's scheme), so no transposed copy of the pair is made.
#include "fused_pair.cuh"

namespace {

using namespace fused_pair;

struct Args {
  const int8_t* m8;      // [n0, n1], n0 and n1 multiples of 16
  const int8_t* w8;      // [n0, n1]
  long long n0, n1;
  const int8_t* yzt;     // [C + K, n_contract]
  int C, K, cp;          // cp: first W column (C rounded up to WARP_N)
  long long nf;          // focus rows written (<= stored focus extent)
  int* pm;               // raw: [C, nf]
  int* bv;               // raw: [K, nf]
  const float* syz;      // dq: [C] scales of the M columns
  const float* sz;       // dq: [K] scales of the W columns
  float* pt;             // dq: [C, nf]
  float* bq;             // dq: [K, nf]
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int FOCUS, bool DQ>
__global__ void __launch_bounds__(NTHREADS)
pair_contract_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sM = smem;              // 2 stages x [BM][BK] M8 tile
  unsigned char* sW = smem + 2 * TILE;   // 2 stages x [BM][BK] W8 tile
  unsigned char* sB = smem + 4 * TILE;   // 2 stages x [BN][BK]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int v0 = blockIdx.x * BN;
  const long long n_contract = FOCUS == 0 ? a.n1 : a.n0;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * WARP_N;
  // CTA-uniform: which stored operands this column tile needs
  const bool has_m = v0 < a.cp;
  const bool has_w = v0 + BN > a.cp && v0 < a.cp + a.K;
  const int8_t* first = has_m ? a.m8 : a.w8;
  unsigned char* s_first = has_m ? sM : sW;
  // warp-uniform: the W8 tile feeds this warp; all its columns are pads
  const bool w_warp = v0 + wn >= a.cp;
  const bool idle = v0 + wn >= a.cp + a.K;

  // B rows this thread loads (virtual columns tid/8 + 32i, chunk tid%8)
  const int lch = tid & 7;
  const int8_t* bsrc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = src_row(a.C, a.C, a.K, a.cp, v0 + (tid >> 3) + 32 * i);
    bsrc[i] = s < 0 ? nullptr : a.yzt + static_cast<long long>(s) * n_contract;
  }

  uint4 rb[4];
  uint4 ra[4];    // mode 0: 4 tile rows; mode 1: 4 contraction rows

  auto load_b = [&](long long k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long k = k0 + lch * 16;
      rb[i] = make_uint4(0, 0, 0, 0);
      if (bsrc[i] != nullptr && k < n_contract)
        rb[i] = __ldg(reinterpret_cast<const uint4*>(bsrc[i] + k));
    }
  };

  auto load_a = [&](const int8_t* src, long long k0) {
    if constexpr (FOCUS == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = m0 + (tid >> 3) + 32 * i;
        const long long k = k0 + lch * 16;
        ra[i] = make_uint4(0, 0, 0, 0);
        if (row < a.n0 && k < a.n1)
          ra[i] = __ldg(reinterpret_cast<const uint4*>(src + row * a.n1 + k));
      }
    } else {
      // contraction rows k0 + 4 kw + r, kw = 4 warp + lane / 8; focus
      // columns m0 + 16 (lane % 8) .. + 15
      const int kw = 4 * warp + (lane >> 3);
      const long long col = m0 + 16 * (lane & 7);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long row = k0 + 4 * kw + r;
        ra[r] = make_uint4(0, 0, 0, 0);
        if (row < a.n0 && col < a.n1)
          ra[r] = __ldg(reinterpret_cast<const uint4*>(src + row * a.n1 + col));
      }
    }
  };

  auto store_b = [&](int stage) {
    unsigned char* tB = sB + stage * TILE;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint4*>(tB + soff<FOCUS>((tid >> 3) + 32 * i, lch)) = rb[i];
  };

  auto store_a = [&](unsigned char* base, int stage) {
    unsigned char* tA = base + stage * TILE;
    if constexpr (FOCUS == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint4*>(tA + soff<FOCUS>((tid >> 3) + 32 * i, lch)) = ra[i];
    } else {
      const int kw = 4 * warp + (lane >> 3);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // word q of each row: focus columns 4q .. 4q + 3 of the 16
        const uint32_t w0 = word(ra[0], q), w1 = word(ra[1], q);
        const uint32_t w2 = word(ra[2], q), w3 = word(ra[3], q);
        // byte j of word r is (contraction row r, focus column j)
        const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
        const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
        const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
        const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
        const uint32_t out[4] = {__byte_perm(t0, t2, 0x5410),
                                 __byte_perm(t0, t2, 0x7632),
                                 __byte_perm(t1, t3, 0x5410),
                                 __byte_perm(t1, t3, 0x7632)};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = soff<FOCUS>(16 * (lane & 7) + 4 * q + j, kw >> 2) + (kw & 3) * 4;
          *reinterpret_cast<uint32_t*>(tA + o) = out[j];
        }
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  const int nk = static_cast<int>((n_contract + BK - 1) / BK);
  load_b(0);
  load_a(first, 0);
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    store_b(stage);
    store_a(s_first, stage);
    if (has_m && has_w) {
      // the column tile that holds both operands: W8 after M8, unoverlapped
      load_a(a.w8, static_cast<long long>(kt) * BK);
      store_a(sW, stage);
    }
    __syncthreads();
    if (kt + 1 < nk) {
      load_b(static_cast<long long>(kt + 1) * BK);
      load_a(first, static_cast<long long>(kt + 1) * BK);
    }
    if (idle) continue;
    const unsigned char* tA = (w_warp ? sW : sM) + stage * TILE;
    const unsigned char* tB = sB + stage * TILE;
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
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
        for (int mi = 0; mi < 4; ++mi) mma_s8(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }
  if (idle) return;

  // epilogue: sum (row g + 8h, column 2 tig + e) of each 16 x 8 tile
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
          const int val = acc[mi][ni][2 * h + e];
          if (v < a.C) {
            if constexpr (DQ) a.pt[v * a.nf + m] = static_cast<float>(val) * a.syz[v];
            else a.pm[v * a.nf + m] = val;
          } else if (v >= a.cp && v - a.cp < a.K) {
            const int k = v - a.cp;
            if constexpr (DQ) a.bq[k * a.nf + m] = static_cast<float>(val) * a.sz[k];
            else a.bv[k * a.nf + m] = val;
          }
        }
      }
    }
  }
}

template <int FOCUS, bool DQ>
int launch(const Args& a, void* stream) {
  const int smem = 6 * TILE;
  auto kern = pair_contract_kernel<FOCUS, DQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_focus = FOCUS == 0 ? a.n0 : a.n1;
  const long long tiles = (a.nf + BM - 1) / BM;
  if (tiles == 0) return 0;
  if (tiles > 65535 || a.nf > n_focus) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.cp + a.K + BN - 1) / BN, static_cast<unsigned>(tiles));
  kern<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  m8 and w8 are contiguous
// [n0, n1] int8 with n0 and n1 multiples of 16; yzt is contiguous
// [C + K, n_contract] int8 (n_contract = n1 for focus 0, n0 for focus 1);
// nf <= the focus extent.  dq = 0: pm [C, nf] and bv [K, nf] int32;
// dq = 1: syz [C] and sz [K] float32 scales, pt [C, nf] and bq [K, nf]
// float32.  Returns the launch's CUDA error (0 on success).
extern "C" int bdf_pair_contract_i8(const void* m8, const void* w8,
                                    long long n0, long long n1, int focus,
                                    const void* yzt, int C, int K,
                                    long long nf, int dq, void* pm, void* bv,
                                    const void* syz, const void* sz, void* pt,
                                    void* bq, void* stream) {
  if (n0 % 16 || n1 % 16 || C < 1 || K < 1 || (focus != 0 && focus != 1) ||
      dq < 0 || dq > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.m8 = static_cast<const int8_t*>(m8);
  a.w8 = static_cast<const int8_t*>(w8);
  a.n0 = n0;
  a.n1 = n1;
  a.yzt = static_cast<const int8_t*>(yzt);
  a.C = C;
  a.K = K;
  a.cp = (C + WARP_N - 1) / WARP_N * WARP_N;
  a.nf = nf;
  a.pm = static_cast<int*>(pm);
  a.bv = static_cast<int*>(bv);
  a.syz = static_cast<const float*>(syz);
  a.sz = static_cast<const float*>(sz);
  a.pt = static_cast<float*>(pt);
  a.bq = static_cast<float*>(bq);
  if (focus == 0)
    return dq ? launch<0, true>(a, stream) : launch<0, false>(a, stream);
  return dq ? launch<1, true>(a, stream) : launch<1, false>(a, stream);
}
