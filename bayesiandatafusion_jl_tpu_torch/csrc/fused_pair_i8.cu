// Fused masked-pair contraction on int8 tensor cores (K8): both Gramian
// orientations of the fused sparse regime from ONE stored int8 value array.
//
// Replaces the TPU kernels of bayesiandatafusion_jl_tpu/ops/pallas_fused.py
// `fused_pair_pallas` (:345) in its s8 variants: flip_out raw int32
// `_kern_focus_rows_i8_t` (:127) / `_kern_focus_cols_i8_t` (:158), the
// dequantizing `_kern_focus_rows_i8_tq` (:182) / `_kern_focus_cols_i8_tq`
// (:218), and the natural layout `_kern_focus_rows_i8` (:83) /
// `_kern_focus_cols_i8` (:106).  With V8 [n0, n1] the stored codes (0 = unobserved) and YZ8T
// [C+K, n_contract] the partner table [Ypack | U] quantized per row (K7),
// it computes for the focus mode f (f = 0: V8's rows, contracting n1;
// f = 1: V8's columns, contracting n0)
//
//     PM[c, i] = sum_p (V8_f[i, p] != 0) * YZ8T[c, p]      c < C + K
//     BV[k, i] = sum_p  V8_f[i, p]       * YZ8T[C + k, p]  k < K
//
// exactly in int32 (s8 x s8 -> s32, no saturation; the caller's per-fiber
// bound `fused_int8_ok` keeps every sum below 2^31), written in the packed
// sampler's [., n_focus] layout: raw int32 PM and BV, or the float32
// dequant epilogue Pt = PM[:C] * syz[:C], PMm = PM[C:] * syz[C:],
// BVf = BV * sz (one int32 -> float32 conversion and one float32 multiply
// per element, as the plain version does); or raw int32 in the natural
// layout PM [n_focus, C + K], BV [n_focus, K], which the full-P branch
// (K > 96) finishes and expands to [n_focus, K, K].  There each thread's
// two adjacent sums of an mma tile land side by side in memory.
//
// What bounds it on an H100: 2 n0 n1 (C + 2K) int8 operations, 1.01e13 at
// the Netflix shape (480,189 x 17,770, K = 32), 5.1 ms at the 1,979 TOP/s
// dense int8 peak; its bytes (V8 8.5 GB once, the f32 outputs 1.1 GB) are
// 2.9 ms at 3.35 TB/s.  So the tensor cores are the floor.
//
// Design: a plain GEMM on `mma.sync.m16n8k32.s8`, the mask made on chip.
// A CTA of 8 warps computes 128 focus rows x 128 "virtual" output columns:
// [0, ckp) are the mask columns (YZ8T rows 0..C+K-1, padded to a multiple
// of 32 so each warp's 32 columns are all mask or all value columns),
// [ckp, ckp + K) the value columns (YZ8T rows C..C+K-1 again, against the
// raw codes).  Each warp holds 64 x 32 int32 sums.  The contraction runs in
// 128-byte steps through two shared-memory stages, loaded through
// registers while the other stage is multiplied.  Each stage holds the V8
// tile twice, as codes and as its 0/1 mask (__vcmpne4(w, 0) & 0x01010101
// per 32-bit word), made once per element when the tile is stored rather
// than by each of the 4 warps that read an A row; the mask warps read the
// one, the value warps the other.  int8 mma takes both operands K-major
// (contiguous along the contraction):
//   - focus rows (mode 0): a V8 tile is K-major as stored, copied as is;
//   - focus columns (mode 1): V8 is strided along the contraction, and
//     Hopper's 8-bit mma has no transposed operand.  Each thread loads
//     16 bytes (16 focus columns) of each of 4 contraction rows and
//     transposes the four 4 x 4-byte blocks in registers with __byte_perm
//     before the store, so no transposed copy of V8 (8.5 GB more) is ever
//     made.
// Shared tiles are 128-byte rows with an XOR swizzle of the 16-byte chunks,
// chunk ^ ((row ^ row >> 2) & 7), and in mode 1 chunk ^ ((row ^ row >> 2
// ^ row >> 4) & 7): both keep the fragment loads free of bank conflicts,
// and the longer one also mode 1's transposed stores (mode 0 keeps the
// shorter one, whose address arithmetic is cheaper).  V8 is read once per
// column tile: 5 times a mode at K = 32 (608 virtual columns), mostly from
// L2, since the column tiles of one focus tile are neighbours in the grid.
#include "fused_pair.cuh"

namespace {

using namespace fused_pair;

struct Args {
  const int8_t* v8;      // [n0, n1], n0 and n1 multiples of 16
  long long n0, n1;
  const int8_t* yzt;     // [C + K, n_contract]
  int C, K, ckp;         // ckp: first value column (C + K rounded up)
  long long nf;          // focus rows written (<= stored focus extent)
  int* pm;               // raw: [C + K, nf], natural layout [nf, C + K]
  int* bv;               // raw: [K, nf], natural layout [nf, K]
  const float* syz;      // dq: [C + K] scales of the mask columns
  const float* sz;       // dq: [K] scales of the value columns
  float* pt;             // dq: [C, nf]
  float* pmm;            // dq: [K, nf]
  float* bvf;            // dq: [K, nf]
};

__device__ __forceinline__ uint32_t mask4(uint32_t w) {
  return __vcmpne4(w, 0u) & 0x01010101u;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// DQ: the dequant epilogue; NAT (raw only): the natural output layout
template <int FOCUS, bool DQ, bool NAT>
__global__ void __launch_bounds__(NTHREADS)
fused_pair_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* sA = smem;              // 2 stages x [BM][BK] codes
  unsigned char* sM = smem + 2 * TILE;   // 2 stages x [BM][BK] 0/1 mask
  unsigned char* sB = smem + 4 * TILE;   // 2 stages x [BN][BK]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int v0 = blockIdx.x * BN;
  const long long n_contract = FOCUS == 0 ? a.n1 : a.n0;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * WARP_N;
  const bool raw = v0 + wn >= a.ckp;     // warp-uniform: value columns

  // B rows this thread loads (virtual columns tid/8 + 32i, chunk tid%8)
  const int lch = tid & 7;
  const int8_t* bsrc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = src_row(a.C + a.K, a.C, a.K, a.ckp, v0 + (tid >> 3) + 32 * i);
    bsrc[i] = s < 0 ? nullptr : a.yzt + static_cast<long long>(s) * n_contract;
  }

  uint4 rb[4];
  uint4 ra[FOCUS == 0 ? 4 : 1];
  uint4 rt[FOCUS == 0 ? 1 : 4];

  auto load = [&](long long k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long k = k0 + lch * 16;
      rb[i] = make_uint4(0, 0, 0, 0);
      if (bsrc[i] != nullptr && k < n_contract)
        rb[i] = __ldg(reinterpret_cast<const uint4*>(bsrc[i] + k));
    }
    if constexpr (FOCUS == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = m0 + (tid >> 3) + 32 * i;
        const long long k = k0 + lch * 16;
        ra[i] = make_uint4(0, 0, 0, 0);
        if (row < a.n0 && k < a.n1)
          ra[i] = __ldg(reinterpret_cast<const uint4*>(a.v8 + row * a.n1 + k));
      }
    } else {
      // contraction rows k0 + 4 kw + r, kw = 4 warp + lane / 8; focus
      // columns m0 + 16 (lane % 8) .. + 15
      const int kw = 4 * warp + (lane >> 3);
      const long long col = m0 + 16 * (lane & 7);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const long long row = k0 + 4 * kw + r;
        rt[r] = make_uint4(0, 0, 0, 0);
        if (row < a.n0 && col < a.n1)
          rt[r] = __ldg(reinterpret_cast<const uint4*>(a.v8 + row * a.n1 + col));
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
      for (int i = 0; i < 4; ++i) {
        const int o = soff<FOCUS>((tid >> 3) + 32 * i, lch);
        *reinterpret_cast<uint4*>(tA + o) = ra[i];
        *reinterpret_cast<uint4*>(tM + o) =
            make_uint4(mask4(ra[i].x), mask4(ra[i].y), mask4(ra[i].z),
                       mask4(ra[i].w));
      }
    } else {
      const int kw = 4 * warp + (lane >> 3);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // word q of each row: focus columns 4q .. 4q + 3 of the 16
        const uint32_t w0 = word(rt[0], q), w1 = word(rt[1], q);
        const uint32_t w2 = word(rt[2], q), w3 = word(rt[3], q);
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
          *reinterpret_cast<uint32_t*>(tM + o) = mask4(out[j]);
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
  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    const int stage = kt & 1;
    store(stage);
    __syncthreads();
    if (kt + 1 < nk) load(static_cast<long long>(kt + 1) * BK);
    const unsigned char* tA = (raw ? sA : sM) + stage * TILE;
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

  // epilogue: sum (row g + 8h, column 2 tig + e) of each 16 x 8 tile
  const int ck = a.C + a.K;
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
          if (v < ck) {
            if constexpr (DQ) {
              const float f = static_cast<float>(val) * a.syz[v];
              if (v < a.C) a.pt[v * a.nf + m] = f;
              else a.pmm[(v - a.C) * a.nf + m] = f;
            } else if constexpr (NAT) {
              a.pm[m * ck + v] = val;
            } else {
              a.pm[v * a.nf + m] = val;
            }
          } else if (v >= a.ckp && v - a.ckp < a.K) {
            const int k = v - a.ckp;
            if constexpr (DQ) a.bvf[k * a.nf + m] = static_cast<float>(val) * a.sz[k];
            else if constexpr (NAT) a.bv[m * a.K + k] = val;
            else a.bv[k * a.nf + m] = val;
          }
        }
      }
    }
  }
}

template <int FOCUS, bool DQ, bool NAT>
int launch(const Args& a, void* stream) {
  const int smem = 6 * TILE;
  auto kern = fused_pair_kernel<FOCUS, DQ, NAT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_focus = FOCUS == 0 ? a.n0 : a.n1;
  const long long tiles = (a.nf + BM - 1) / BM;
  if (tiles == 0) return 0;
  if (tiles > 65535 || a.nf > n_focus) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((a.ckp + a.K + BN - 1) / BN, static_cast<unsigned>(tiles));
  kern<<<grid, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  v8 is contiguous [n0, n1] int8
// with n0 and n1 multiples of 16; yzt is contiguous [C + K, n_contract]
// int8 (n_contract = n1 for focus 0, n0 for focus 1); nf <= the focus
// extent.  dq = 0: pm [C + K, nf] and bv [K, nf] int32; dq = 1: syz [C + K]
// and sz [K] float32 scales, pt [C, nf], pmm and bvf [K, nf] float32;
// dq = 2: the natural layout, pm [nf, C + K] and bv [nf, K] int32.
// Returns the launch's CUDA error (0 on success).
extern "C" int bdf_fused_pair_i8(const void* v8, long long n0, long long n1,
                                 int focus, const void* yzt, int C, int K,
                                 long long nf, int dq, void* pm, void* bv,
                                 const void* syz, const void* sz, void* pt,
                                 void* pmm, void* bvf, void* stream) {
  if (n0 % 16 || n1 % 16 || C < 1 || K < 1 || (focus != 0 && focus != 1) ||
      dq < 0 || dq > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.v8 = static_cast<const int8_t*>(v8);
  a.n0 = n0;
  a.n1 = n1;
  a.yzt = static_cast<const int8_t*>(yzt);
  a.C = C;
  a.K = K;
  a.ckp = (C + K + WARP_N - 1) / WARP_N * WARP_N;
  a.nf = nf;
  a.pm = static_cast<int*>(pm);
  a.bv = static_cast<int*>(bv);
  a.syz = static_cast<const float*>(syz);
  a.sz = static_cast<const float*>(sz);
  a.pt = static_cast<float*>(pt);
  a.pmm = static_cast<float*>(pmm);
  a.bvf = static_cast<float*>(bvf);
  if (focus == 0)
    return dq == 1   ? launch<0, true, false>(a, stream)
           : dq == 2 ? launch<0, false, true>(a, stream)
                     : launch<0, false, false>(a, stream);
  return dq == 1   ? launch<1, true, false>(a, stream)
         : dq == 2 ? launch<1, false, true>(a, stream)
                   : launch<1, false, false>(a, stream);
}
