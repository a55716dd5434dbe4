// One warp factors one packed triangle in shared memory: the right-looking
// column-slab Cholesky recurrence of the TPU kernels
// `_chol_sample_packed_slab_kernel` (pallas_chol.py:281-292) and
// `_chol_inv_slab_kernel` (:402-410), shared by chol_sample_packed_slab.cu
// (K2) and chol_inv.cu (K5).
//
// A holds the lower triangle column by column (the np.triu_indices packing
// read under symmetry): entry (m, k), m >= k, at tri_off(k, K) + m - k.
// For each pivot column j: d = sqrt(A[j][j]), inv = 1 / d, the column below
// the pivot scaled by inv, then the trailing columns k > j updated as
// A[m][k] -= L[m][j] L[k][j].  Lane l owns the rows m = l + 32 t: it keeps
// their L[m][j] in registers, so each update is one shared load and one
// shared store, at consecutive addresses across the warp (no bank
// conflicts); L[k][j] is one broadcast read per column.
#pragma once

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ int tri_off(int j, int K) {
  return j * K - j * (j - 1) / 2;
}

template <typename T, int kMaxT>
__device__ __forceinline__ void warp_chol_packed(T* A, int K, int lane) {
  for (int j = 0; j < K; ++j) {
    const int oj = tri_off(j, K);
    const T d = sqrt(A[oj]);
    const T inv = T(1) / d;
    __syncwarp();
    if (lane == 0) A[oj] = d;
    T lm[kMaxT];   // L[m][j] for the lane's rows m
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int m = lane + 32 * t;
      lm[t] = T(0);
      if (m > j && m < K) {
        lm[t] = A[oj + m - j] * inv;
        A[oj + m - j] = lm[t];
      }
    }
    __syncwarp();
    for (int k = j + 1; k < K; ++k) {
      const int ok = tri_off(k, K);
      const T lkj = A[oj + k - j];
      const int t0 = k / 32;   // rows below 32 t0 lie above the diagonal
#pragma unroll
      for (int t = 0; t < kMaxT; ++t) {
        const int m = lane + 32 * t;
        if (t >= t0 && m >= k && m < K) {
          A[ok + m - k] = A[ok + m - k] - lm[t] * lkj;
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace
