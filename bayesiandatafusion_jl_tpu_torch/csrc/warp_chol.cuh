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
// - Shared memory in 32 x 32 blocks, 32 < K <= 96 (`panel_chol_sample`;
//   K2 chol_sample_packed_slab.cu and K4 chol_sample_full_slab.cu, each
//   with its own loader): one warp a matrix, K padded to 32 NB (64 or 96)
//   with identity rows, so every panel loop runs whole.  A blocked
//   right-looking Cholesky over 32-wide panels: the diagonal block factored
//   in registers with half_chol_sample's mechanisms (the column broadcast
//   from a buffer, one IEEE reciprocal a pivot kept for both solves), the
//   blocks below solved against it one row a lane (TRSM), the trailing
//   blocks updated with the lane's row of the block in registers and
//   4-value broadcast chunks of L (SYRK), so a trailing entry is read and
//   written once a panel instead of once a pivot; the forward solve rides
//   in the factorization, the backward solve runs by panels.
//   Same arithmetic as the column-slab recurrence of
//   `_chol_sample_slab_kernel` (:77) and `_chol_sample_packed_slab_kernel`
//   (:281-292), in another rounding order.  On an NVIDIA H100 80GB HBM3 at
//   700 W, K2 at B = 71,567 runs 1.13 / 3.41 ms at K = 64 / 96 on it and
//   5.45 / 21.94 on the column-slab core it replaced, timed in turns
//   (PERF.md).  K5 (chol_inv.cu) runs the same factorization without the
//   solves (`panel_factor`), then inverts L by panels with the core's
//   TRSM step (`panel_trsm`).
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

// K2's packed column order: column j of the lower triangle (the
// np.triu_indices packing read under symmetry) starts at tri_off(j, K)
__device__ __forceinline__ int tri_off(int j, int K) {
  return j * K - j * (j - 1) / 2;
}

// ---- The panel core: K2, K4 (32 < K <= 96) and K5 (K <= 64) ----------

constexpr int kPanel = 32;                  // rows and columns of a panel
constexpr int kBlk = kPanel * kPanel;       // words of a stored 32 x 32 block

// A 32 x 32 block is stored column by column, each column in 16-byte
// chunks of G = 16 / sizeof(T) consecutive rows, chunk g of column c at
// position g ^ (c & 7): lane i reading row i of one column, a broadcast
// read of one chunk of a column, and lane c reading a chunk of its own
// column c (8 lanes a 16-byte phase) all fall in distinct banks.
template <typename T>
__device__ __forceinline__ int blk_off(int i, int c) {
  constexpr int G = 16 / sizeof(T);
  return c * kPanel + (((i / G) ^ (c & 7)) * G) + i % G;
}

template <typename T>
__device__ __forceinline__ int chunk_off(int g, int c) {
  constexpr int G = 16 / sizeof(T);
  return c * kPanel + ((g ^ (c & 7)) * G);
}

// block (q, r), q >= r, of the lower triangle, stored block row by block row
__device__ __forceinline__ int blk_base(int q, int r) {
  return (q * (q + 1) / 2 + r) * kBlk;
}

// entry (m, k), m >= k, of the lower triangle
template <typename T>
__device__ __forceinline__ int tri_at(int m, int k) {
  return blk_base(m / kPanel, k / kPanel) + blk_off<T>(m % kPanel, k % kPanel);
}

// one 16-byte chunk from shared memory
__device__ __forceinline__ void load_chunk(const float* p, float* v) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load_chunk(const double* p, double* v) {
  const double2 x = *reinterpret_cast<const double2*>(p);
  v[0] = x.x;
  v[1] = x.y;
}

// A warp's shared memory for one matrix of NB panels (K <= 32 NB): the
// lower triangle's NB (NB + 1) / 2 blocks, then vec (32 NB values: b, then
// y, then u), inv (32 NB reciprocals of L's diagonal) and two column
// buffers of 32 + G values.  All four parts start 16-byte aligned.
template <typename T, int NB>
__host__ __device__ constexpr int panel_words() {
  return NB * (NB + 1) / 2 * kBlk + 2 * kPanel * NB + 2 * (kPanel + 16 / sizeof(T));
}

// Rows a block of K2 and K4: one 32-byte sector of K2's [C, B] reads a row
// group, 8 float or 4 double rows, one warp each
template <typename T>
__host__ __device__ constexpr int panel_rows() {
  return 32 / static_cast<int>(sizeof(T));
}

// A float block also holds Lambda padded to 32 NB, its lower triangle
// packed column by column, which every row reads: from device memory its
// latency cost a third of the kernel's time at K = 96 (PERF.md).  A double
// block of four rows at K = 96 has no room for it and reads Lambda from
// device memory.
template <typename T, int NB>
__host__ __device__ constexpr int panel_lam_words() {
  return sizeof(T) == 4 ? (kPanel * NB * (kPanel * NB + 1) / 2 + 3) / 4 * 4
                        : 0;
}

// Dynamic shared memory of a block of `warps` rows, in bytes
template <typename T, int NB>
__host__ __device__ constexpr int panel_smem(int warps) {
  return (warps * panel_words<T, NB>() + panel_lam_words<T, NB>()) *
         static_cast<int>(sizeof(T));
}

// Blocks a SM that shared memory allows: the kernels' __launch_bounds__
// minimum, so that registers never cut the occupancy below it (227 KB a
// SM, 1 KB of it reserved a block)
template <typename T, int NB>
__host__ __device__ constexpr int panel_blocks(int warps) {
  return 232448 / (panel_smem<T, NB>(warps) + 1024);
}

// Start copying Lambda into the float block's padded copy, entry (m, k),
// m >= k, at k Kp - k (k + 1) / 2 + m with Kp = 32 NB, zeros past K and
// for no Lambda; warp w of `warps` takes the columns w, w + warps, ...
template <typename T, int NB>
__device__ __forceinline__ void panel_stage_lam(T* lam_s,
                                                const T* __restrict__ lam,
                                                int K, int w, int warps,
                                                int lane) {
  if (panel_lam_words<T, NB>() == 0) return;
  constexpr int Kp = kPanel * NB;
  for (int k = w; k < Kp; k += warps) {
    T* const col = lam_s + k * Kp - k * (k + 1) / 2;
    for (int m = k + lane; m < Kp; m += 32) {
      if (lam != nullptr && m < K) {
        cp_async<sizeof(T)>(col + m, lam + k * K + m);
      } else {
        col[m] = T(0);
      }
    }
  }
}

template <int NB>
__device__ __forceinline__ int panel_vec() {
  return NB * (NB + 1) / 2 * kBlk;
}

// Fill the warp's triangle for the rows K <= m < 32 NB with identity rows
// and vec's tail with zeros.  The real entries are the loader's.
template <typename T, int NB>
__device__ __forceinline__ void panel_pad(T* W, int K, int lane) {
  for (int m = K; m < kPanel * NB; ++m) {
    for (int k = lane; k <= m; k += 32) W[tri_at<T>(m, k)] = T(m == k);
    if (lane == 0) W[panel_vec<NB>() + m] = T(0);
  }
}

// (Lambda + jitter I)(m, k) for m >= k.  float: lam is the block's padded
// copy (panel_stage_lam); the jitter also lands on the padded diagonal,
// which scales identity rows only and leaves u alone.  double: lam is
// [K, K] in device memory (or null), read at its upper triangle, and the
// sum is 0 past K.
template <typename T, int NB>
struct LamJitter {
  static constexpr bool kAdds = true;
  const T* lam;
  T jitter;
  int K;
  __device__ __forceinline__ T operator()(int m, int k) const {
    if (panel_lam_words<T, NB>() > 0) {
      constexpr int Kp = kPanel * NB;
      const T v = lam[k * Kp - k * (k + 1) / 2 + m];
      return m == k ? v + jitter : v;
    }
    T v = T(0);
    if (m < K && k < K) {
      if (lam != nullptr) v = lam[k * K + m];
      if (m == k) v = v + jitter;
    }
    return v;
  }
};

// Nothing to add: K5 factors P as it is
struct NoLam {
  static constexpr bool kAdds = false;
};

// TRSM for one lane: a := L^-1 a, L the factored diagonal block D (its
// columns below the diagonal read as broadcast chunks) with the kept
// reciprocals of its diagonal in rinv; forward substitution, a[j] times
// rinv[j], then a[k] -= a[j] L[k][j] for k > j.  With a = row i of a block
// below, this is row i of that block times L^-T; with a = e_i, column i of
// L^-1.
template <typename T>
__device__ __forceinline__ void panel_trsm(const T* D, const T* rinv,
                                           T (&a)[kPanel]) {
  constexpr int G = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    T w[kPanel];
#pragma unroll
    for (int g = (j + 1) / G; g < kPanel / G; ++g) {
      load_chunk(D + chunk_off<T>(g, j), w + g * G);
    }
    a[j] = a[j] * rinv[j];
#pragma unroll
    for (int k = j + 1; k < kPanel; ++k) a[k] -= a[j] * w[k];
  }
}

// Factor one matrix of NB panels in place with one warp.  In: W
// (panel_words) holds P's lower triangle (tri_at; identity rows past K)
// and, with kSolve, b in vec (zeros past K); lam is added to each entry
// where it is first read (when Lam::kAdds).  Out: L in the blocks, the
// reciprocals of its diagonal in inv and, with kSolve, y = L^-1 b in vec.
// Every lane calls.
//
// Blocked right-looking Cholesky over 32-wide panels; lane i owns row i of
// every 32-row block it works on and keeps it in registers.  For panel p:
// the diagonal block is factored as in half_chol_sample (the column
// broadcast from a buffer, one sqrt and one IEEE reciprocal a pivot, kept
// in inv: the solves multiply by it), with the forward solve's panel
// folded in when kSolve (b[j] rides in the column buffer: y[j] = b[j]
// inv[j], b[i] -= L[i][j] y[j]); each block below is solved against it
// (panel_trsm, one row a lane) and takes the forward solve's update
// b[q] -= L[q][p] y[p]; each trailing block then takes
// A[q][r] -= L[q][p] L[r][p]^T (SYRK): the lane accumulates its row of
// the block in registers, reads its own L[q][p][i][j] back one a step,
// and every broadcast chunk of L[r][p] feeds G multiply-adds, so the
// block's row is read and written once a panel (once a pivot in the
// column-slab core this replaced).  Entries above the diagonal of a
// diagonal block hold garbage and are never read into a result.
template <typename T, int NB, bool kSolve, typename Lam>
__device__ __forceinline__ void panel_factor(T* W, Lam lam, int lane) {
  constexpr int G = 16 / sizeof(T);
  constexpr int kCol = kPanel + G;
  constexpr int kRead = kSolve ? kCol : kPanel;   // column buffer words read
  T* const A = W;
  T* const vec = W + panel_vec<NB>();
  T* const inv = vec + kPanel * NB;
  T* const col = inv + kPanel * NB;
  const int i = lane;

#pragma unroll 1
  for (int p = 0; p < NB; ++p) {
    // the diagonal block and the forward solve's panel
    T* const D = A + blk_base(p, p);
    T a[kPanel];
#pragma unroll
    for (int k = 0; k < kPanel; ++k) a[k] = D[blk_off<T>(i, k)];
    if constexpr (Lam::kAdds) {
      if (p == 0) {
#pragma unroll
        for (int k = 0; k < kPanel; ++k) a[k] = a[k] + lam(i, k);
      }
    }
    T s = T(0), y = T(0);
    if constexpr (kSolve) s = vec[kPanel * p + i];
#pragma unroll
    for (int j = 0; j < kPanel; ++j) {
      T* const cb = col + (j & 1) * kCol;   // two buffers: one sync a step
      cb[i] = a[j];
      if (kSolve && i == j) cb[kPanel] = s;
      __syncwarp();
      T v[kCol];
#pragma unroll
      for (int g = j / G; g < kRead / G; ++g) {
        load_chunk(cb + g * G, v + g * G);
      }
      const T r = T(1) / sqrt(v[j]);
      const T lij = a[j] * r;
      const T t = lij * r;
      a[j] = lij;
#pragma unroll
      for (int k = j + 1; k < kPanel; ++k) a[k] -= t * v[k];
      if (i == j) {
        if constexpr (kSolve) y = v[kPanel] * r;
        inv[kPanel * p + j] = r;
      }
      if constexpr (kSolve) s -= t * v[kPanel];
    }
    if constexpr (kSolve) vec[kPanel * p + i] = y;
#pragma unroll
    for (int k = 0; k < kPanel; ++k) D[blk_off<T>(i, k)] = a[k];
    __syncwarp();

#pragma unroll 1
    for (int q = p + 1; q < NB; ++q) {
      // TRSM: row i of L[q][p] = A[q][p] L[p][p]^-T
      T* const E = A + blk_base(q, p);
#pragma unroll
      for (int k = 0; k < kPanel; ++k) a[k] = E[blk_off<T>(i, k)];
      if constexpr (Lam::kAdds) {
        if (p == 0) {
#pragma unroll
          for (int k = 0; k < kPanel; ++k) {
            a[k] = a[k] + lam(kPanel * q + i, k);
          }
        }
      }
      panel_trsm<T>(D, inv + kPanel * p, a);
      if constexpr (kSolve) {
        // the forward solve: b[q] -= L[q][p] y[p]
        T sq = vec[kPanel * q + i];
#pragma unroll
        for (int g = 0; g < kPanel / G; ++g) {
          T yv[G];
          load_chunk(vec + kPanel * p + g * G, yv);
#pragma unroll
          for (int h = 0; h < G; ++h) sq -= a[g * G + h] * yv[h];
        }
        vec[kPanel * q + i] = sq;
      }
#pragma unroll
      for (int k = 0; k < kPanel; ++k) E[blk_off<T>(i, k)] = a[k];
      __syncwarp();

      // SYRK: A[q][r] -= L[q][p] L[r][p]^T for p < r <= q, L[q][p][i][j]
      // read back from the lane's own row (a rolled loop: less code and
      // fewer live registers)
#pragma unroll 1
      for (int rr = p + 1; rr <= q; ++rr) {
        T* const F = A + blk_base(q, rr);
        const T* const Lr = A + blk_base(rr, p);
        T acc[kPanel];
#pragma unroll
        for (int k = 0; k < kPanel; ++k) acc[k] = F[blk_off<T>(i, k)];
        if constexpr (Lam::kAdds) {
          if (p == 0) {
#pragma unroll
            for (int k = 0; k < kPanel; ++k) {
              acc[k] = acc[k] + lam(kPanel * q + i, kPanel * rr + k);
            }
          }
        }
#pragma unroll 2
        for (int j = 0; j < kPanel; ++j) {
          const T lij = E[blk_off<T>(i, j)];
#pragma unroll
          for (int g = 0; g < kPanel / G; ++g) {
            T w[G];
            load_chunk(Lr + chunk_off<T>(g, j), w);
#pragma unroll
            for (int h = 0; h < G; ++h) acc[g * G + h] -= lij * w[h];
          }
        }
#pragma unroll
        for (int k = 0; k < kPanel; ++k) F[blk_off<T>(i, k)] = acc[k];
      }
    }
  }
}

// Factor, solve and sample one matrix of NB panels with one warp.  In: W
// (panel_words) holds P's lower triangle (tri_at; identity rows past K)
// and b in vec (zeros past K); lam is added to each entry where it is
// first read.  Out: u_row[m] for m < K.  Every lane calls, with the same
// K.
//
// panel_factor with the forward solve folded in, then the backward solve
// by panels from the last: each lane subtracts L[q][p]^T u[q] for its
// column from chunks of its own column, then the diagonal block's chain
// multiplies by the kept reciprocals, u[j] broadcast by one shuffle a
// step.
template <typename T, int NB>
__device__ __forceinline__ void panel_chol_sample(
    T* W, LamJitter<T, NB> lam, const T* __restrict__ xi_row,
    T* __restrict__ u_row, int K, int lane) {
  constexpr int G = 16 / sizeof(T);
  T* const A = W;
  T* const vec = W + panel_vec<NB>();
  T* const inv = vec + kPanel * NB;
  const int i = lane;

  panel_factor<T, NB, true>(W, lam, lane);

  // backward solve L^T u = y + xi by panels from the last; u overwrites y
#pragma unroll 1
  for (int p = NB - 1; p >= 0; --p) {
    const int m = kPanel * p + i;
    T v = vec[m] + (m < K ? xi_row[m] : T(0));
#pragma unroll 1
    for (int q = NB - 1; q > p; --q) {
      // column i of L[q][p] from the lane's own chunks, u[q] broadcast
      const T* const E = A + blk_base(q, p);
#pragma unroll
      for (int g = 0; g < kPanel / G; ++g) {
        T w[G], uq[G];
        load_chunk(E + chunk_off<T>(g, i), w);
        load_chunk(vec + kPanel * q + g * G, uq);
#pragma unroll
        for (int h = 0; h < G; ++h) v -= w[h] * uq[h];
      }
    }
    const T* const D = A + blk_base(p, p);
    const T ri = inv[m];
    T u = T(0);
    T w[G];
#pragma unroll
    for (int j = kPanel - 1; j >= 0; --j) {
      if (j % G == G - 1) load_chunk(D + chunk_off<T>(j / G, i), w);
      const T uj = __shfl_sync(kFullMask, v * ri, j);
      if (i == j) u = uj;
      v -= w[j % G] * uj;
    }
    vec[m] = u;
    if (m < K) u_row[m] = u;
    __syncwarp();
  }
}

}  // namespace
