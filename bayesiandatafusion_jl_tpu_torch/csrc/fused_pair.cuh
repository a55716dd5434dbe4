// The int8 pair contraction's (pair_contract_i8.cu) CTA tile, swizzled
// shared-memory layout and "virtual column" map; the float32 / float64
// fused kernel (fused_pair_f.cu) takes the map.  (The int8 and bfloat16
// fused kernels run TMA rings on hopper_ring.cuh.)
//
// K6 computes, for a CTA, 128 focus rows x 128 virtual output columns from
// shared-memory tiles with 128-byte rows (128 int8 contraction elements a
// stage).  The virtual columns are [0, ckp) the first operand's columns
// (partner-table rows 0 .. n_first-1, padded up to ckp: the mask columns
// of the fused kernels, n_first = C + K; the M8 columns of the pair,
// n_first = C) and [ckp, ckp + K) the value columns (table rows C ..
// C+K-1, against the raw codes or W8).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace fused_pair {

constexpr int BM = 128;        // focus rows per CTA
constexpr int BN = 128;        // virtual output columns per CTA
constexpr int BK = 128;        // contraction bytes per tile row and stage
constexpr int WARP_N = 32;     // columns per warp; the value columns start
                               // at a multiple of it
constexpr int NTHREADS = 256;
constexpr int TILE = BM * BK;  // bytes of one stage of A (mask and B the
                               // same)

// XOR swizzle of the 16-byte chunks of a 128-byte tile row: chunk ^
// ((row ^ row >> 2) & 7), and for focus columns (FOCUS 1, whose tiles are
// stored transposed, 16 rows apart per lane) also ^ row >> 4.  Both keep
// the mma fragment loads free of bank conflicts, the longer one also the
// transposed stores.
template <int FOCUS>
__device__ __forceinline__ int swz(int row) {
  return FOCUS == 0 ? (row ^ (row >> 2)) & 7
                    : (row ^ (row >> 2) ^ (row >> 4)) & 7;
}

// byte offset of 16-byte chunk `ch` of tile row `row`
template <int FOCUS>
__device__ __forceinline__ int soff(int row, int ch) {
  return row * BK + ((ch ^ swz<FOCUS>(row)) << 4);
}

// word q of a 16-byte vector (q a compile-time constant once unrolled)
__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// partner-table row feeding virtual column v, or -1 for a pad column: the
// first n_first columns read rows 0 .. n_first-1, the K value columns from
// ckp on read rows C .. C+K-1
__device__ __forceinline__ int src_row(int n_first, int C, int K, int ckp,
                                       int v) {
  if (v < n_first) return v;
  if (v >= ckp && v - ckp < K) return C + (v - ckp);
  return -1;
}

}  // namespace fused_pair
