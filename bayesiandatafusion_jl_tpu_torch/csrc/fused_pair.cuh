// The "virtual column" map of the float64 fused kernel (fused_pair_f.cu's
// FMA variant).  (The int8, bfloat16 and float32 fused kernels and the
// int8 pair contraction run TMA rings on hopper_ring.cuh.)
//
// The virtual columns are [0, ckp) the mask columns (partner-table rows
// 0 .. n_first-1, n_first = C + K, padded up to ckp) and [ckp, ckp + K)
// the value columns (table rows C .. C+K-1, against the raw codes).
#pragma once
#include <cuda_runtime.h>

namespace fused_pair {

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
