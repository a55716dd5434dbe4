// One warp factors, solves and samples K x K precisions: the Cholesky
// recurrences of the TPU kernels in pallas_chol.py, shared by the sampler
// kernels and by chol_inv.cu (K5).
//
// Two storage schemes:
//
// - Registers, K <= 32 (`half_chol_sample`; K1 chol_sample_packed.cu and
//   K3 chol_sample_full.cu): a warp holds two matrices, one a half-warp,
//   each padded to 32 x 32 with identity rows.  Lane l of a half holds the
//   rows l and 31 - l of the lower triangle in registers (a[16] and c[32]),
//   so its two rows together are 33 entries long.  Right-looking
//   factorization: at step j every lane stores its rows' entries of column
//   j, unscaled, into a per-warp column buffer in shared memory, and reads
//   the column back as broadcast 16-byte loads; one load serves both
//   matrices, and one sqrt and one IEEE reciprocal a step serve both
//   pivots.  With d = sqrt(A[j][j]) and inv = 1 / d, L[i][j] = A[i][j] inv
//   and the trailing update A[i][k] -= (L[i][j] inv) A[k][j] needs no
//   scaled copy of the column.  inv stays in a register of the lane that
//   owns row j, and both solves multiply by it: no division in a solve.
//   The forward solve broadcasts y[k] with one 16-wide shuffle a step
//   (both matrices at once).  The backward solve reads L's column through
//   shared memory: each lane stores its rows of L packed row by row
//   (row i at i(i + 1)/2), so step i's L[i][k] for all k are consecutive
//   words, and u[i] comes by one shuffle.  Same arithmetic as
//   `_chol_solve_sample` (pallas_chol.py:44), in another rounding order:
//   L[i][j] L[k][j] as (L[i][j] inv) A[k][j], y[k] and u[k] as products
//   with inv instead of quotients.  At K = 32 K1's kernel is 3,752 SASS
//   instructions a warp for its two rows (64 shuffles, 69 MUFU; K3's
//   4,232), where with the shuffle-per-pivot-pair core it replaced (lane
//   i held row i and took every L[k][j] by __shfl_sync) it was 7,944 for
//   one (1,056 shuffles, ~96 IEEE divisions).  On an NVIDIA H100 80GB HBM3 at 700 W, K1 at
//   B = 71,567 runs 0.2904 ms on it (0.9115 on the old core) and K3 0.2855
//   (1.1588); PERF.md has the rest.
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

// the register core's shapes: matrices padded to kRegK, kHalf lanes each,
// kTri words of packed L each
constexpr int kRegK = 32;
constexpr int kHalf = 16;
constexpr int kTri = kRegK * (kRegK + 1) / 2;

// K1's and K3's loaders: copy N bytes from device to shared memory
// without a register, in flight until cp.async.wait_all
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(N));
}

// four consecutive values from 16-byte aligned shared memory
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const double* p, double* v) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  const double2 y = *reinterpret_cast<const double2*>(p + 2);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = y.x;
  v[3] = y.y;
}

// Rows l and 31 - l of P' in the layout half_chol_sample takes: entry
// (i, k), k <= i, is at(i, k); identity rows for the rows >= K, and for
// every row when !live.
template <typename T, typename At>
__device__ __forceinline__ void fill_rows(T (&a)[kHalf], T (&c)[kRegK],
                                          int l, int K, bool live, At at) {
  const int rb = kRegK - 1 - l;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    a[k] = T(k == l);
    if (live && k <= l && l < K) a[k] = at(l, k);
  }
#pragma unroll
  for (int k = 0; k < kRegK; ++k) {
    c[k] = T(k == rb);
    if (live && k <= rb && rb < K) c[k] = at(rb, k);
  }
}

// Factor, solve and sample the matrix of this half-warp.  In: a[k] =
// P'[l][k] (k <= l) and c[k] = P'[rb][k] (k <= rb), rb = 31 - l, with
// identity rows for l, rb >= K, zeros above the diagonal; b and xi of both
// rows (0 past K).  col: the warp's column buffers, 2 x 2 x kRegK values,
// 16-byte aligned, offset by kRegK for the upper half; lr: kTri values of
// shared memory for this matrix's L, whose words sit 16 banks apart from
// the other half's.  Out: u of both rows.  Every lane of the warp calls,
// with the same K.  a and c are overwritten (with L, and garbage above
// the diagonal: finite, never read).
template <typename T>
__device__ __forceinline__ void half_chol_sample(
    T (&a)[kHalf], T (&c)[kRegK], T b_a, T b_c, T xi_a, T xi_c, int K,
    int l, T* col, T* lr, T& u_a, T& u_c) {
  const int rb = kRegK - 1 - l;
  T inv_a = T(1), inv_c = T(1);
#pragma unroll
  for (int j = 0; j < kRegK; ++j) {
    if (j < K) {
      T* cb = col + (j & 1) * 2 * kRegK;   // two buffers: one sync a step
      if (j < kHalf) cb[l] = a[j];
      cb[rb] = c[j];
      __syncwarp();
      T v[kRegK];
#pragma unroll
      for (int g = j / 4; g < kRegK / 4; ++g) load4(cb + 4 * g, v + 4 * g);
      const T d = sqrt(v[j]);
      const T inv = T(1) / d;
      if (j < kHalf) {
        const T lij = a[j] * inv;
        const T t = lij * inv;
        a[j] = lij;
#pragma unroll
        for (int k = j + 1; k < kHalf; ++k) a[k] -= t * v[k];
        if (l == j) inv_a = inv;
      }
      const T lij = c[j] * inv;
      const T t = lij * inv;
      c[j] = lij;
#pragma unroll
      for (int k = j + 1; k < kRegK; ++k) c[k] -= t * v[k];
      if (rb == j) inv_c = inv;
    }
  }

  // forward solve L y = b: y[k] = s[k] inv[k] from the lane that owns
  // row k, then every row subtracts L[i][k] y[k] (rows at or above k
  // update a value they no longer need)
  T s_a = b_a, s_c = b_c, y_a = T(0), y_c = T(0);
#pragma unroll
  for (int k = 0; k < kRegK; ++k) {
    if (k < K) {
      const bool lo = k < kHalf;
      const T yk = __shfl_sync(kFullMask, lo ? s_a * inv_a : s_c * inv_c,
                               lo ? k : kRegK - 1 - k, kHalf);
      if (lo) {
        if (l == k) y_a = yk;
        s_a -= a[lo ? k : 0] * yk;
      } else if (rb == k) {
        y_c = yk;
      }
      s_c -= c[k] * yk;
    }
  }

  // L to shared memory, row i at i (i + 1) / 2
  const int oa = l * (l + 1) / 2, oc = rb * (rb + 1) / 2;
#pragma unroll
  for (int k = 0; k < kHalf; ++k) {
    if (k <= l) lr[oa + k] = a[k];
  }
#pragma unroll
  for (int k = 0; k < kRegK; ++k) {
    if (k <= rb) lr[oc + k] = c[k];
  }
  __syncwarp();

  // backward solve L^T u = y + xi: u[i] = v[i] inv[i] from the lane that
  // owns row i, then every row k < i subtracts L[i][k] u[i]; the reads
  // stay inside the matrix's kTri words
  T v_a = y_a + xi_a, v_c = y_c + xi_c;
  u_a = T(0);
  u_c = T(0);
#pragma unroll
  for (int i = kRegK - 1; i >= 0; --i) {
    if (i < K) {
      const bool lo = i < kHalf;
      const T ui = __shfl_sync(kFullMask, lo ? v_a * inv_a : v_c * inv_c,
                               lo ? i : kRegK - 1 - i, kHalf);
      if (lo) {
        if (l == i) u_a = ui;
      } else if (rb == i) {
        u_c = ui;
      }
      const T* row = lr + i * (i + 1) / 2;
      v_a -= row[l] * ui;
      v_c -= row[rb] * ui;
    }
  }
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
