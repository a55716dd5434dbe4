// The gather path's per-row Gramian in one pass: each bucket row's partner
// rows gathered into shared memory and contracted into z^T z and z^T v on
// the tensor cores.
//
// Replaces no TPU kernel: the JAX package forms these Gramians with XLA
// (bayesiandatafusion_jl_tpu/ops/gramian.py `bucket_gramian` :38, a gather
// and two einsums), and the port's torch version (ops/gramian.py
// `gather_gram_plain`) ran the same chain, an `index_select` of every
// slot's partner row into a [rows, W, K] block, the mask, float32 copies
// and two `bmm`s, writing and reading the block three times.  For every row
// r of a bucket of width W (one focus piece) it writes
//
//     z_s  = bf16(U0[part0[r, s]] (* U1[part1[r, s]]))      (arity 2 (3))
//     zm_s = bf16(z_s * bf16(mask[r, s])),   v_s = bf16(val[r, s])
//     P[r] = alpha * sum_s zm_s zm_s^T,      b[r] = alpha * sum_s zm_s v_s
//
// with every rounding of the torch chain kept (bf16 products round to
// nearest even; a product of two bf16 values is exact in float32) and the
// sums in float32: only their order differs.  A row's sums run in one
// fixed order on one warp (no atomics), so two runs give the same bits;
// P is mirrored from its upper triangle, so it is symmetric bit for bit.
//
// What bounds it on an H100: its bytes.  Per slot it reads the layout (part,
// val and mask: 12 bytes at arity 2) and gathers one partner row (2K bytes,
// 64 at K = 32) that mostly comes from the 50 MB L2 (the partner tables are
// small); per row it writes K*K + K floats.  At Netflix's ladder (~219M
// slots, ~534k rows at K = 32) that is ~2.6 GB of layout and ~2.2 GB of P:
// ~1.45 ms at 3.35 TB/s, beside ~14 GB of gathered rows from L2.  The
// products, 2 * 219M * 32 * 32 flops, take ~0.45 ms on the bf16 tensor
// cores.
//
// Design: one warp walks a few consecutive rows (several narrow rows, one
// wide one), 16 slots a step, the steps of its rows in one pipeline:
//  - the step's indices, values and mask come into a ring of shared memory
//    by 4-byte cp.async (zero beyond W) 2 * kLag steps ahead;
//  - the step's partner rows are gathered by 16-byte cp.async into a ring
//    of kStages tiles [16 slots][K] (16-byte chunks XOR-swizzled so that
//    the ldmatrix reads hit distinct banks) kLag steps ahead, from the
//    indices already in shared memory; a slot with mask 0 is zero-filled,
//    not read;
//  - ldmatrix.trans of a tile gives the z^T fragments of mma.m16n8k16 for
//    A and B at once (A = z^T, B = z, the slots the contraction), which the
//    lane multiplies by its slots' mask (and the second table's fragments)
//    in bf16 pairs; one mma tile per 16 x 8 block of P's upper triangle,
//    and one for z^T v with v in column 0 of B;
//  - at a row's last step the warp stages its accumulators in shared
//    memory, both (i, j) and (j, i) from i <= j, and writes alpha * P and
//    alpha * b in 16-byte stores, while the next row's loads are in flight:
//    at the row's own index, or, with a destination map (``dest``, built
//    once from the layout), at its instance's row of the [n, K*K] output
//    or at a slot of the overflow after it, so that no per-sweep pass
//    reorders the rows into instances (ops/gramian.py
//    ``assemble_precision``).  The map is a template flag, so that the
//    kernel without it runs the code it ran before the map.
// Measured at Netflix's buckets (PERF.md; NVIDIA H100 80GB HBM3, 700 W, one
// process, builds in turns, the same bits): the step counters in place of
// a division by the row's steps took the kernel from 5.47 to 4.40 ms a
// sweep; 3 stages ran 4.25, 4 stages 4.40 and 6 stages 4.76 (fewer warps
// a SM), 2 stages 4.62; 16-byte index loads gained nothing; gathering the
// mask-0 slots (all index 0) instead of zero-filling them ran 5.37.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStep = 16;                 // slots a step (the mma's depth)
constexpr int kStages = 3;                // gathered tiles in the ring
constexpr int kLag = kStages - 1;         // steps a gather is issued ahead
constexpr int kMetaAhead = 2 * kLag;      // steps an index load is ahead
constexpr int kMetaSlots = kMetaAhead + 1;
constexpr int kWarps = 4;                 // warps a block

// Shared memory of one warp, in bytes, for K and NT partner tables.
template <int K, int NT>
struct Layout {
  static constexpr int kChunks = K / 8;                    // 16 B a row
  static constexpr int kTile = kStep * K * 2;              // one table
  static constexpr int kData = kStages * NT * kTile;
  static constexpr int kMetaStep = (NT + 2) * kStep * 4;   // parts, val, mask
  static constexpr int kMeta = kMetaSlots * kMetaStep;
  static constexpr int kLd = K + 4;                        // staging stride
  static constexpr int kStage = (K * kLd + K) * 4;
  static constexpr int kWarp = kData + kMeta + kStage;
  static_assert(kData % 16 == 0 && kMeta % 16 == 0 && kStage % 16 == 0,
                "16-byte aligned parts");
};

// The 16-byte chunk of (slot s, column chunk c) in a tile: rows of K/8
// chunks, XOR-swizzled so that the 8 slots one ldmatrix matrix reads fall in
// 8 distinct bank groups (K a power of two times 8; K = 48 keeps its rows
// plain, a 2-way conflict).
template <int K>
__device__ __forceinline__ int chunk_at(int s, int c) {
  constexpr int kC = K / 8;
  if constexpr ((kC & (kC - 1)) == 0) {
    constexpr int kRowsAGroup = kC >= 8 ? 1 : 8 / kC;
    constexpr int kMask = (kC >= 8 ? 8 : kC) - 1;
    return s * kC + (c ^ ((s / kRowsAGroup) & kMask));
  } else {
    return s * kC + c;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool on) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(on ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b, m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 products, each rounded to nearest even (the torch bf16 multiply)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&x);
}

// (lo, hi) rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float2 v) {
  __nv_bfloat162 x = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&x);
}

template <int K, int NT, bool kDest>
__global__ void __launch_bounds__(kWarps * 32)
gather_gram_kernel(const __nv_bfloat16* __restrict__ u0, long long n0,
                   const __nv_bfloat16* __restrict__ u1, long long n1,
                   const int* __restrict__ part0, const int* __restrict__ part1,
                   const float* __restrict__ val, const float* __restrict__ mask,
                   long long rows, int W, int rows_per_warp,
                   const float* __restrict__ alpha, float* __restrict__ P,
                   float* __restrict__ b, const int* __restrict__ dest,
                   long long out_rows) {
  using L = Layout<K, NT>;
  constexpr int kGroups = K / 16;     // 16-latent groups: mma row tiles
  constexpr int kCols = K / 8;        // 8-latent column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* base = smem + warp * L::kWarp;
  const uint32_t data_s = smem_addr(base);
  const uint32_t meta_s = data_s + L::kData;
  const int* meta = reinterpret_cast<const int*>(base + L::kData);
  float* stage = reinterpret_cast<float*>(base + L::kData + L::kMeta);

  const long long r0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * rows_per_warp;
  if (r0 >= rows) return;  // the whole warp leaves; no block-wide sync
  const int n_rows = static_cast<int>(min(rows - r0, (long long)rows_per_warp));
  const int n_steps = (W + kStep - 1) / kStep;
  const int Q = n_rows * n_steps;     // the warp's steps, its rows in turn
  const float a = __ldg(alpha);

  // the next step's parts, values and mask into meta slot q % kMetaSlots:
  // array j of the step (parts of table 0 (and 1), val, mask) at
  // [j * 16, j * 16 + 16); (m_row, m_s0) walks the warp's steps in turn
  int m_row = 0, m_s0 = 0;
  auto issue_meta = [&](int q) {
    if (m_row >= n_rows) return;
    const long long row = r0 + m_row;
    const int s0 = m_s0;
    m_s0 += kStep;
    if (m_s0 >= W) {
      m_s0 = 0;
      ++m_row;
    }
    const uint32_t dst = meta_s + (q % kMetaSlots) * L::kMetaStep;
#pragma unroll
    for (int e = lane; e < (NT + 2) * kStep; e += 32) {
      const int j = e / kStep, s = e % kStep;
      const bool on = s0 + s < W;
      const long long off = on ? row * W + s0 + s : 0;
      const void* src = j == 0 ? static_cast<const void*>(part0 + off)
                        : (NT == 2 && j == 1)
                            ? static_cast<const void*>(part1 + off)
                        : j == NT ? static_cast<const void*>(val + off)
                                  : static_cast<const void*>(mask + off);
      cp_async4(dst + e * 4, src, on);
    }
  };

  // step q's partner rows into tile q % kStages, from its indices in meta
  auto issue_gather = [&](int q) {
    if (q < 0 || q >= Q) return;
    const int* mp = meta + (q % kMetaSlots) * (L::kMetaStep / 4);
    const float* mk = reinterpret_cast<const float*>(mp + (NT + 1) * kStep);
    const uint32_t tile = data_s + (q % kStages) * NT * L::kTile;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const __nv_bfloat16* u = t == 0 ? u0 : u1;
      const long long n = t == 0 ? n0 : n1;
#pragma unroll
      for (int c = lane; c < kStep * L::kChunks; c += 32) {
        const int s = c / L::kChunks, cc = c % L::kChunks;
        const int p = mp[t * kStep + s];
        const bool on = mk[s] != 0.0f && p >= 0 && p < n;
        const __nv_bfloat16* src = u + (on ? static_cast<long long>(p) * K + cc * 8 : 0);
        cp_async16(tile + t * L::kTile + chunk_at<K>(s, cc) * 16, src, on);
      }
    }
  };

  // the upper triangle's tiles (row tile mi, column tile nj >= 2 mi), and
  // z^T v, a tile a row tile
  float acc[kGroups][kCols][4];
  float accv[kGroups][4];
#pragma unroll
  for (int mi = 0; mi < kGroups; ++mi) {
#pragma unroll
    for (int nj = 0; nj < kCols; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.0f;
#pragma unroll
    for (int e = 0; e < 4; ++e) accv[mi][e] = 0.0f;
  }

  const int g = lane >> 2, t4 = lane & 3;
  // this lane's ldmatrix row: matrix lane / 8 is (slots 0-7 or 8-15) x
  // (the group's first or second 8 latents)
  const int ld_slot = (lane & 7) + 8 * (lane >> 4);
  const int ld_half = (lane >> 3) & 1;
  int c_row = 0, c_left = n_steps;   // the row being summed, its steps left

  for (int it = -kMetaAhead; it < Q; ++it) {
    // the loads of step it (and the indices of step it + kLag) have landed
    // once at most kLag - 1 newer groups are pending
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kLag - 1) : "memory");
    __syncwarp();
    issue_meta(it + kMetaAhead);
    issue_gather(it + kLag);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    if (it < 0) continue;

    const float* mp = reinterpret_cast<const float*>(
        meta + (it % kMetaSlots) * (L::kMetaStep / 4));
    const float* vv = mp + NT * kStep;
    const float* mk = vv + kStep;
    // this lane's slots in every fragment: 2 t4, 2 t4 + 1 (and + 8)
    const uint32_t m_lo = pack_bf16x2(*reinterpret_cast<const float2*>(mk + 2 * t4));
    const uint32_t m_hi = pack_bf16x2(*reinterpret_cast<const float2*>(mk + 8 + 2 * t4));
    uint32_t v_lo = 0, v_hi = 0;      // column 0 of B: lanes with g == 0
    if (g == 0) {
      v_lo = pack_bf16x2(*reinterpret_cast<const float2*>(vv + 2 * t4));
      v_hi = pack_bf16x2(*reinterpret_cast<const float2*>(vv + 8 + 2 * t4));
    }
    const uint32_t tile = data_s + (it % kStages) * NT * L::kTile;
    uint32_t f[kGroups][4];
#pragma unroll
    for (int kg = 0; kg < kGroups; ++kg) {
      const uint32_t off = chunk_at<K>(ld_slot, 2 * kg + ld_half) * 16;
      ldsm_x4_trans(tile + off, f[kg]);
      if constexpr (NT == 2) {
        uint32_t h[4];
        ldsm_x4_trans(tile + L::kTile + off, h);
#pragma unroll
        for (int e = 0; e < 4; ++e) f[kg][e] = mul_bf16x2(f[kg][e], h[e]);
      }
      f[kg][0] = mul_bf16x2(f[kg][0], m_lo);
      f[kg][1] = mul_bf16x2(f[kg][1], m_lo);
      f[kg][2] = mul_bf16x2(f[kg][2], m_hi);
      f[kg][3] = mul_bf16x2(f[kg][3], m_hi);
    }
    // A of row tile mi is f[mi]; B of column tile nj is (f[nj / 2][nj % 2],
    // f[nj / 2][2 + nj % 2])
#pragma unroll
    for (int mi = 0; mi < kGroups; ++mi) {
#pragma unroll
      for (int nj = 2 * mi; nj < kCols; ++nj)
        mma_bf16(acc[mi][nj], f[mi], f[nj / 2][nj % 2], f[nj / 2][2 + nj % 2]);
      mma_bf16(accv[mi], f[mi], v_lo, v_hi);
    }

    if (--c_left != 0) continue;
    // the row's last step: stage (i, j) and (j, i) from every i <= j
    const long long row = r0 + c_row;
    ++c_row;
    c_left = n_steps;
    // the output row: the row itself, or its destination (none outside
    // [0, out_rows))
    long long o = row;
    if constexpr (kDest) o = __ldg(dest + row);
    float* sb = stage + K * L::kLd;
#pragma unroll
    for (int mi = 0; mi < kGroups; ++mi) {
#pragma unroll
      for (int nj = 2 * mi; nj < kCols; ++nj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 16 * mi + g + 8 * (e >> 1);
          const int j = 8 * nj + 2 * t4 + (e & 1);
          if (i <= j) {
            stage[i * L::kLd + j] = acc[mi][nj][e];
            stage[j * L::kLd + i] = acc[mi][nj][e];
          }
          acc[mi][nj][e] = 0.0f;
        }
      }
      if (t4 == 0) {
        sb[16 * mi + g] = accv[mi][0];
        sb[16 * mi + 8 + g] = accv[mi][2];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) accv[mi][e] = 0.0f;
    }
    __syncwarp();
    if (!kDest || (o >= 0 && o < out_rows)) {
      float4* po = reinterpret_cast<float4*>(P + o * (K * K));
#pragma unroll
      for (int q = lane; q < K * K / 4; q += 32) {
        const int i = q / (K / 4), j = 4 * (q % (K / 4));
        float4 x = *reinterpret_cast<const float4*>(stage + i * L::kLd + j);
        x.x *= a; x.y *= a; x.z *= a; x.w *= a;
        po[q] = x;
      }
      if (lane < K / 4) {
        float4 x = reinterpret_cast<const float4*>(sb)[lane];
        x.x *= a; x.y *= a; x.z *= a; x.w *= a;
        reinterpret_cast<float4*>(b + o * K)[lane] = x;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int K, int NT, bool kDest>
int launch(const void* u0, long long n0, const void* u1, long long n1,
           const void* part0, const void* part1, const void* val,
           const void* mask, long long rows, int W, int rows_per_warp,
           const void* alpha, void* P, void* b, const void* dest,
           long long out_rows, cudaStream_t stream) {
  const int smem = kWarps * Layout<K, NT>::kWarp;
  auto kern = gather_gram_kernel<K, NT, kDest>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = (rows + rows_per_warp - 1) / rows_per_warp;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(u0), n0,
      static_cast<const __nv_bfloat16*>(u1), n1,
      static_cast<const int*>(part0), static_cast<const int*>(part1),
      static_cast<const float*>(val), static_cast<const float*>(mask), rows, W,
      rows_per_warp, static_cast<const float*>(alpha),
      static_cast<float*>(P), static_cast<float*>(b),
      static_cast<const int*>(dest), out_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int NT, bool kDest>
int launch_k(int K, const void* u0, long long n0, const void* u1, long long n1,
             const void* part0, const void* part1, const void* val,
             const void* mask, long long rows, int W, int rows_per_warp,
             const void* alpha, void* P, void* b, const void* dest,
             long long out_rows, cudaStream_t st) {
  switch (K) {
    case 16:
      return launch<16, NT, kDest>(u0, n0, u1, n1, part0, part1, val, mask,
                                   rows, W, rows_per_warp, alpha, P, b, dest,
                                   out_rows, st);
    case 32:
      return launch<32, NT, kDest>(u0, n0, u1, n1, part0, part1, val, mask,
                                   rows, W, rows_per_warp, alpha, P, b, dest,
                                   out_rows, st);
    case 48:
      return launch<48, NT, kDest>(u0, n0, u1, n1, part0, part1, val, mask,
                                   rows, W, rows_per_warp, alpha, P, b, dest,
                                   out_rows, st);
    case 64:
      return launch<64, NT, kDest>(u0, n0, u1, n1, part0, part1, val, mask,
                                   rows, W, rows_per_warp, alpha, P, b, dest,
                                   out_rows, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  u0 [n0, K] (and, with nt = 2,
// u1 [n1, K]) contiguous bfloat16 partner tables, 16-byte aligned; part0
// (part1) int32, val and mask float32, each contiguous [rows, W]; alpha one
// float32 on the device; P [out_rows, K * K] and b [out_rows, K] contiguous
// float32, 16-byte aligned.  Without dest (null) row r goes to output row r
// (out_rows = rows); with dest (int32 [rows] on the device) to output row
// dest[r], and nowhere where dest[r] is outside [0, out_rows).  K is 16,
// 32, 48 or 64; an index outside its table reads as a zero row.  Returns
// the launch's CUDA error (0 on success).
extern "C" int bdf_gather_gram(const void* u0, long long n0, const void* u1,
                               long long n1, int K, int nt, const void* part0,
                               const void* part1, const void* val,
                               const void* mask, long long rows, int W,
                               int rows_per_warp, const void* alpha, void* P,
                               void* b, const void* dest, long long out_rows,
                               void* stream) {
  if (rows < 1 || W < 1 || rows_per_warp < 1 || n0 < 1 ||
      (dest == nullptr && out_rows != rows) ||
      (nt == 2 && n1 < 1) ||
      static_cast<long long>(rows_per_warp) *
              ((W + kStep - 1) / kStep) > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nt == 1 && dest == nullptr)
    return launch_k<1, false>(K, u0, n0, u0, n0, part0, part0, val, mask,
                              rows, W, rows_per_warp, alpha, P, b, dest,
                              out_rows, st);
  if (nt == 2 && dest == nullptr)
    return launch_k<2, false>(K, u0, n0, u1, n1, part0, part1, val, mask,
                              rows, W, rows_per_warp, alpha, P, b, dest,
                              out_rows, st);
  if (nt == 1)
    return launch_k<1, true>(K, u0, n0, u0, n0, part0, part0, val, mask, rows,
                             W, rows_per_warp, alpha, P, b, dest, out_rows,
                             st);
  if (nt == 2)
    return launch_k<2, true>(K, u0, n0, u1, n1, part0, part1, val, mask, rows,
                             W, rows_per_warp, alpha, P, b, dest, out_rows,
                             st);
  return static_cast<int>(cudaErrorInvalidValue);
}
