// One warp factors, solves and samples one row's K x K precision: the
// Cholesky recurrences of the TPU kernels in pallas_chol.py, shared by the
// sampler kernels and by chol_inv.cu (K5).
//
// Two storage schemes:
//
// - Registers, K <= 32 (`lane_chol_sample`; K1 chol_sample_packed.cu and
//   K3 chol_sample_full.cu): lane i holds row i of the lower triangle,
//   a[k] = P'[i][k] for k <= i, and the pivot column is broadcast with
//   __shfl_sync.  This is `_chol_solve_sample` (pallas_chol.py:44) with its
//   operation order: right-looking factorization (d = sqrt, inv = 1/d,
//   column scaled by inv, trailing update), then forward and backward
//   substitution with a true division by the diagonal.
//
// - Shared memory, K <= 96 (`warp_chol_packed`, `warp_packed_solve_sample`;
//   K2 chol_sample_packed_slab.cu, K4 chol_sample_full_slab.cu, K5): A holds
//   the lower triangle column by column (the np.triu_indices packing read
//   under symmetry): entry (m, k), m >= k, at tri_off(k, K) + m - k.  This
//   is the column-slab recurrence of `_chol_sample_slab_kernel` (:77) and
//   `_chol_sample_packed_slab_kernel` (:281-292): for each pivot column j,
//   d = sqrt(A[j][j]), inv = 1 / d, the column below the pivot scaled by
//   inv, then the trailing columns k > j updated as
//   A[m][k] -= L[m][j] L[k][j].  Lane l owns the rows m = l + 32 t: it keeps
//   their L[m][j] in registers, so each update is one shared load and one
//   shared store, at consecutive addresses across the warp (no bank
//   conflicts); L[k][j] is one broadcast read per column.
#pragma once

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

// Factor, solve and sample with row `lane` of the lower triangle in a[]
// (a[k] = P'[lane][k], k <= lane; lanes >= K hold zeros): returns
// u[lane] = (L^-T (L^-1 b + xi))[lane], with b_lane = b[lane] and
// xi_lane = xi[lane] (0 on lanes >= K).  Every lane of the warp must call.
template <typename T, int kMaxK>
__device__ __forceinline__ T lane_chol_sample(T (&a)[kMaxK], T b_lane,
                                              T xi_lane, int K, int lane) {
  // right-looking factorization: after step j, lane i > j holds L[i][j]
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    if (j < K) {
      const T d = sqrt(__shfl_sync(kFullMask, a[j], j));
      const T inv = T(1) / d;
      if (lane == j) {
        a[j] = d;
      } else if (lane > j) {
        a[j] = a[j] * inv;
      }
      const T lij = a[j];
#pragma unroll
      for (int k = j + 1; k < kMaxK; ++k) {
        if (k < K) {
          const T lkj = __shfl_sync(kFullMask, a[j], k);
          if (lane >= k) a[k] = a[k] - lij * lkj;
        }
      }
    }
  }

  // forward solve L y = b: lane i subtracts L[i][k] y[k] in ascending k
  T s = b_lane;
  T y = T(0);
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < K) {
      const T yk = __shfl_sync(kFullMask, s / a[k], k);
      if (lane == k) y = yk;
      if (lane > k) s = s - a[k] * yk;
    }
  }

  // backward solve L^T u = y + xi: L[k][i] lives on lane k, so lane k sends
  // its product L[k][i] u[k] and lane i subtracts them in ascending k
  const T v = y + xi_lane;
  T uval = T(0);
#pragma unroll
  for (int i = kMaxK - 1; i >= 0; --i) {
    if (i < K) {
      const T prod = a[i] * uval;
      T t = v;
#pragma unroll
      for (int k = i + 1; k < kMaxK; ++k) {
        if (k < K) t = t - __shfl_sync(kFullMask, prod, k);
      }
      if (lane == i) uval = t / a[i];
    }
  }
  return uval;
}

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

// The whole draw on one row staged in shared memory: A the packed
// triangle of P' (L overwrites it), R = b (K values), U scratch (K values);
// xi_row and u_row are the row's [K] slices in device memory.  Factor
// (warp_chol_packed), forward solve with a true division by the diagonal,
// then the column-oriented backward solve
// u_i = (v_i - sum_{k > i} L[k][i] u_k) / L[i][i], whose column sum is a
// warp reduction.  K4 calls it; K2 keeps the same code inline, because the
// two kernels' times move in opposite directions with it (PERF.md):
// on an H100, K4 ran 5.26 / 20.44 ms at K = 64 / 96 through this function
// and 5.87 / 22.57 ms inline, K2 5.45 / 21.93 ms inline and 5.78 / 26.75
// through it.
template <typename T, int kMaxT>
__device__ __forceinline__ void warp_packed_solve_sample(
    T* A, T* R, T* U, const T* __restrict__ xi_row, T* __restrict__ u_row,
    int K, int lane) {
  warp_chol_packed<T, kMaxT>(A, K, lane);

  // forward solve L y = b (y overwrites R); L[m][k] = A[off(k) + m - k]
  for (int k = 0; k < K; ++k) {
    const int ok = tri_off(k, K);
    const T yk = R[k] / A[ok];
    __syncwarp();
    if (lane == 0) R[k] = yk;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int m = lane + 32 * t;
      if (m > k && m < K) R[m] = R[m] - A[ok + m - k] * yk;
    }
    __syncwarp();
  }

  // backward solve L^T u = y + xi
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    const int m = lane + 32 * t;
    if (m < K) R[m] = R[m] + xi_row[m];
  }
  __syncwarp();
  for (int i = K - 1; i >= 0; --i) {
    const int oi = tri_off(i, K);
    T part = T(0);
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int k = lane + 32 * t;
      if (k > i && k < K) part = part + A[oi + k - i] * U[k];
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      part += __shfl_xor_sync(kFullMask, part, s);
    }
    if (lane == 0) U[i] = (R[i] - part) / A[oi];
    __syncwarp();
  }
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    const int m = lane + 32 * t;
    if (m < K) u_row[m] = U[m];
  }
}

}  // namespace
