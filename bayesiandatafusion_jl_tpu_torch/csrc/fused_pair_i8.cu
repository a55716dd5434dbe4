// Fused masked-pair contraction on int8 tensor cores (K8a, K8b): both
// Gramian orientations of the fused sparse regime from ONE stored int8
// value array.
//
// Replaces the TPU kernels of bayesiandatafusion_jl_tpu/ops/pallas_fused.py
// `fused_pair_pallas` (:345) in its s8 variants: flip_out raw int32
// `_kern_focus_rows_i8_t` (:127) / `_kern_focus_cols_i8_t` (:158), the
// dequantizing `_kern_focus_rows_i8_tq` (:182) / `_kern_focus_cols_i8_tq`
// (:218) (K8a), and the natural layout `_kern_focus_rows_i8` (:83) /
// `_kern_focus_cols_i8` (:106) (K8b).  With V8 [n0, n1] the stored codes
// (0 = unobserved) and YZ8T [C+K, n_contract] the partner table [Ypack | U]
// quantized per row (K7), it computes for the focus mode f (f = 0: V8's
// rows, contracting n1; f = 1: V8's columns, contracting n0)
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
// layout PM [n_focus, C + K], BV [n_focus, K] (K8b: the full-P branch,
// K > 96).
//
// What bounds it on an H100: the design multiplies every cell of the
// extent on the tensor cores, 2 n0 n1 (C + 2K) int8 operations: 1.01e13
// at Netflix (480,189 x 17,770, K = 32), 5.1 ms at the 1,979 TOP/s dense
// int8 peak, and 1.30e13 at ML-10M K = 128, 6.6 ms; the bytes (V8 once,
// the outputs once) take 2.9 and 1.0 ms at 3.35 TB/s.  So the tensor
// cores are the floor, and the design answers what held the first
// version (a 2-stage register-staged GEMM on mma.sync) below a fifth of it:
//
// - Loads: an asynchronous ring of STAGES = 4 stages, each one TMA box of
//   V8 (128 focus x 128 contraction bytes) and up to four 64-row boxes of
//   YZ8T, filled by one producer thread and completing on an mbarrier; two
//   consumer warpgroups release a stage through a second mbarrier.  The
//   producer warpgroup gives up registers (setmaxnreg: 40) so that the
//   consumers can hold 232 (ptxas allots a wgmma kernel's registers by
//   warpgroups: 168 each at launch).  TMA's zero fill makes the
//   ragged edges: a zero code is a zero mask, and YZ8T rows past C + K
//   (pad columns) and contraction bytes past the extent read 0.
// - One int8 copy of the V8 tile a stage.  Each consumer loads its A
//   fragments (the codes) from it into registers and makes the 0/1 mask
//   there (__vcmpne4), so no mask tile is stored.
// - Tensor cores: wgmma.mma_async m64nNk32 s32.s8.s8, A (codes or mask)
//   from registers, B the YZ8T rows, K-major as stored, through a
//   descriptor of the 128-byte-swizzled tile.  A consumer warpgroup holds
//   128 focus rows x two 64-column chunks (4 x 32 int32 accumulators a
//   thread): one N = 128 product a 64-row block for a pair, N = 64 for a
//   lone chunk.  Each k32 step's products run while the next step's
//   operand loads.  No product sits in a branch of its mainloop: ptxas
//   serializes every wgmma of a kernel that has one, so each chunk count
//   (two, one, none) has a mainloop of its own, chosen once a tile; and a
//   pair never needs both operands at once, which would leave too few
//   registers to pipeline the products.  8-bit wgmma takes only K-major
//   operands, so focus columns (mode 1: the tile is [contraction x focus])
//   transpose in registers: each thread reads 32-bit words of 4
//   contraction rows and transposes them with __byte_perm into the A
//   fragments of 4 adjacent focus columns, which it owns as its 4 MMA rows
//   (rows g, g + 8 of both 64-row blocks); the epilogue writes each row
//   back to its column.
// - Tiles and order: a CTA tile is 128 focus rows x 4 chunks of 64
//   virtual columns (256).  The virtual columns are [0, ckp) the mask
//   columns (YZ8T rows 0 .. C+K-1, ckp = C + K rounded up to 64) and
//   [ckp, ckp + K) the value columns (YZ8T rows C .. C+K-1 against the raw
//   codes); a chunk is all of one kind, and where both fall in one tile
//   they are made from the same codes tile.  The chunks pair up, the mask
//   chunks two by two and then the value chunks, so no pair mixes the
//   kinds; a tile is two pairs, one for each consumer.
//   One CTA per SM walks the tiles persistently in a grouped order: groups
//   of G focus tiles, column tiles outer within a group, so the 132 CTAs
//   in flight share each V8 strip (its column tiles) and each YZ8T panel
//   (its group's focus tiles) through L2 as they stream the contraction
//   together.  G is 16 in mode 0 and 2 in mode 1: on the H100 each was
//   the fastest G of 1, 2, 4, 16, or within 2% of it, at every shape
//   timed in its mode (Netflix K = 32 and ML-10M K = 128, both modes;
//   ML-10M K = 32 and 64, mode 1), where 16 in mode 1 ran up to 1.13x
//   slower and 2 in mode 0 up to 1.08x (PERF.md §6).  The loads carry no
//   L2 eviction hints: evict_last on YZ8T and evict_first on V8 ran
//   slower at every mode-1 shape but K = 128 with G = 16, and that was
//   slower than G = 2 without them.
// - Epilogue: a consumer stages 32 columns x 128 focus rows of int32 sums
//   in its own 16 KB of shared memory (outside the ring, which already
//   holds the next tile's loads), then writes the flip_out layouts as
//   coalesced rows along n_focus and the natural layout as 16-byte stores
//   along C + K, all streaming stores (no later read in this kernel).
//
// The int8 pair contraction (K6) runs on the same ring.  It replaces
// bayesiandatafusion_jl_tpu/ops/pallas_pair.py `pair_contract_pallas`
// (:137; `_kern_pair_rows_tq` :75, focus rows, and `_kern_pair_cols_tq`
// :105, focus columns).  With M8 [n0, n1] the int8 observation counts,
// W8 [n0, n1] the statically quantized centered values (pad cells 0) and
// YZ8T [C+K, n_contract] the same partner table, it computes
//
//     PM[c, i] = sum_p M8_f[i, p] * YZ8T[c, p]        c < C
//     BV[k, i] = sum_p W8_f[i, p] * YZ8T[C + k, p]    k < K
//
// exactly in int32 (the caller's `int8_pair_ok` keeps every sum below
// 2^31), raw or through the dequant epilogue Pt = PM * syz[c], b = BV *
// sz[k], in the packed sampler's [., n_focus] layout.  Unlike the TPU
// kernel it computes no "count" columns (table rows C .. C+K-1 against
// M8), which that kernel sliced away.  Its bound is K8a's: every cell of
// the extent on the tensor cores, 2 n0 n1 (C + K) operations, 0.43 ms at
// ML-10M K = 32 and 6.5 ms at K = 128; the bytes (M8 and W8 once, the
// float32 outputs once) 0.51 and 1.20 ms.  What changes against K8a is
// the A operand: the mask columns are [0, ckp), ckp = C rounded up to 64,
// against M8's counts as stored (no __vcmpne4: M8 holds counts, not 0/1),
// and the value columns [ckp, ckp + K) against W8.  A tile's two pairs
// are of one kind and its stages hold one box of M8 or of W8, except in
// the one column tile a focus tile has whose first pair is the last mask
// pair and whose second is the first value pair (the mask pairs are odd in
// number at every K the pair path runs: K = 32, 64, 96, 128 give 5, 17,
// 37, 65).  So a K6 stage has two A slots, 64 KB in all, and the ring 3
// stages: the mixed tile's stages hold W8's box beside M8's (both counted
// in the stage's expected bytes) and its second consumer reads the second
// slot, an address chosen once a tile.  K8a's 4 stages of 48 KB, with the
// mixed tile run as two tiles and one consumer idle in each, ran 1.05-1.19x
// slower at ML-10M K = 32 to 128 (PERF.md §6).  In both kernels every
// consumer thread releases a stage (256 arrivals; see `release`).
#include <algorithm>

#include "hopper_ring.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;                  // focus rows (mode 1: columns) a tile
constexpr int BK = 128;                  // contraction bytes a stage
constexpr int CH = 64;                   // virtual columns a chunk (wgmma N)
constexpr int SLOTS = 4;                 // chunks a CTA tile
constexpr int GROUP0 = 16, GROUP1 = 2;   // focus tiles a group, by mode
constexpr int A_BYTES = BM * BK;         // one box of V8 (M8, W8)
constexpr int B_BYTES = CH * BK;         // one chunk's YZ8T box
constexpr int STAGING = 32 * BM * 4;     // a consumer's epilogue tile
constexpr int NTHREADS = 384;            // producer warpgroup + 2 consumers

// The ring's stages by operand source: K8 (PAIR false) one V8 box and
// four YZ8T boxes a stage, 4 stages; K6 (PAIR true) two A slots (M8 or
// W8, and W8 beside M8 in the mixed tile) and four YZ8T boxes, 3 stages.
template <bool PAIR>
struct Ring {
  static constexpr int ASLOTS = PAIR ? 2 : 1;
  static constexpr int STAGES = PAIR ? 3 : 4;
  static constexpr int STAGE_BYTES = ASLOTS * A_BYTES + SLOTS * B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGING +
                              2 * STAGES * 8 + 1024;  // + alignment slack
};

struct Args {
  long long nf;          // focus rows written (<= stored focus extent)
  int C, K;
  int cm, ckp;           // mask columns (C + K for K8, C for K6); ckp: cm
                         // rounded up to CH, the first value column
  int nmask, mp, np;     // mask chunks, mask pairs, pairs (value pairs last)
  int n_ct, n_ft;        // column tiles (two pairs each), focus tiles
  int nk;                // contraction stages
  long long tiles;       // n_ft * n_ct
  int* pm;               // raw: [cm, nf], natural layout [nf, cm]
  int* bv;               // raw: [K, nf], natural layout [nf, K]
  const float* syz;      // dq: [cm] scales of the mask columns
  const float* sz;       // dq: [K] scales of the value columns
  float* pt;             // dq: [C, nf]
  float* pmm;            // dq: [K, nf] (K8 only: mask columns C .. C+K-1)
  float* bvf;            // dq: [K, nf]
};

// tile u in the grouped order: groups of G focus tiles (the last one
// shorter), column tiles outer within a group
template <int FOCUS>
__device__ __forceinline__ void tile_of(const Args& a, long long u, int& ft,
                                        int& ct) {
  constexpr int G = FOCUS == 0 ? GROUP0 : GROUP1;
  const long long per = static_cast<long long>(G) * a.n_ct;
  const int grp = static_cast<int>(u / per);
  const int w = static_cast<int>(u - grp * per);
  const int gs = min(G, a.n_ft - grp * G);
  ct = w / gs;
  ft = grp * G + w % gs;
}

// Pair p of chunks, a consumer warpgroup's share of a tile: the mask
// chunks two by two, then the value chunks two by two, so no pair mixes
// the kinds.  Its first chunk, its chunk count (0 past the last pair) and
// whether it holds value chunks.
__device__ __forceinline__ void chunk_pair(const Args& a, int p, int& first,
                                           int& count, bool& val) {
  val = p >= a.mp;
  const int q = val ? p - a.mp : p;
  const int n = val ? (a.K + CH - 1) / CH : a.nmask;
  first = (val ? a.nmask : 0) + 2 * q;
  count = p < a.np ? min(2, n - 2 * q) : 0;
}

__device__ __forceinline__ uint32_t lds(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// byte j of out[r'] <- byte r' of w[j]: 4 x 4 byte transpose
__device__ __forceinline__ void transpose4(uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  w[0] = __byte_perm(t0, t2, 0x5410);
  w[1] = __byte_perm(t0, t2, 0x7632);
  w[2] = __byte_perm(t1, t3, 0x5410);
  w[3] = __byte_perm(t1, t3, 0x7632);
}

// The tile row (0..127) that MMA row (block b, g + 8h) of warp w holds:
// mode 0 the plain order; mode 1 the 4 adjacent focus columns 4q .. 4q+3
// (q = 8w + g) whose transposed words the thread reads.
template <int FOCUS>
__device__ __forceinline__ int tile_row(int b, int w, int g, int h) {
  return FOCUS == 0 ? 64 * b + 16 * w + g + 8 * h
                    : 4 * (8 * w + g) + 2 * b + h;
}

// A fragments (codes) of k32 step s for both 64-row blocks from a stage's
// V8 box, 128-byte rows in the 128-byte swizzle (16-byte chunk ch of row r
// at ch ^ (r & 7)).  Register layout: mma.m16n8k32's A fragment of the
// warp's 16 rows, a[b] = {(g, k 4t..), (g+8, k 4t..), (g, k 16+4t..),
// (g+8, k 16+4t..)}.
template <int FOCUS>
__device__ __forceinline__ void load_a(const unsigned char* sa, int s, int w,
                                       int g, int t, uint32_t (&a)[2][4]) {
  if constexpr (FOCUS == 0) {
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int r = 64 * b + 16 * w + g;
      const unsigned char* row = sa + r * BK + 4 * t;
      const int lo = ((2 * s) ^ (r & 7)) << 4, hi = ((2 * s + 1) ^ (r & 7)) << 4;
      a[b][0] = lds(row + lo);
      a[b][1] = lds(row + 8 * BK + lo);
      a[b][2] = lds(row + hi);
      a[b][3] = lds(row + 8 * BK + hi);
    }
  } else {
    // the box is [contraction p][focus column]; this thread's focus
    // columns 4q .. 4q+3, contraction rows 32s + 4t + r (and + 16)
    const int q = 8 * w + g, cq = q >> 2, off = 4 * (q & 3);
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = 32 * s + 4 * t + r;     // (p + 16) & 7 == p & 7
      const int o = ((cq ^ (p & 7)) << 4) + off;
      lo[r] = lds(sa + p * BK + o);
      hi[r] = lds(sa + (p + 16) * BK + o);
    }
    transpose4(lo);
    transpose4(hi);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      a[b][0] = lo[2 * b];
      a[b][1] = lo[2 * b + 1];
      a[b][2] = hi[2 * b];
      a[b][3] = hi[2 * b + 1];
    }
  }
}

// One k32 step's A operand for both 64-row blocks: the codes, or their
// 0/1 mask against mask chunks
struct Frag {
  uint32_t a[2][4];
};

__device__ __forceinline__ void fence_frag(Frag& f) {
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i) fence_operand(f.a[b][i]);
}

// the mask of 4 codes: 0x01 in each nonzero byte
__device__ __forceinline__ uint32_t mask4(uint32_t w) {
  return __vcmpne4(w, 0u) & 0x01010101u;
}

// Every consumer thread releases a stage (256 arrivals): an arrival by one
// lane a warp sat in a branch between two products in flight, and ptxas
// serialized every wgmma of K6 for it (C7513).
__device__ __forceinline__ void release(uint64_t* bar) { mbar_arrive(bar); }

// The chunks a consumer warpgroup holds in a tile, each count a mainloop
// of its own so that no tensor-core product sits in a branch within it
// (ptxas serializes every wgmma of a kernel that has one): two (one N =
// 128 product a block and step), one, none.
enum Kind { WIDE, NARROW, NONE };

// k32 step S of a stage: acc[b][j] += A_b . B(chunk slot j)^T; K8: A the
// codes against value chunks and their mask against mask chunks (`keep`:
// all ones for value chunks, else 0); K6 (PAIR): A the box's codes as
// stored, M8's or W8's.  The step's products run while the next
// step's operand loads: `prev` (the previous step's operand) stays
// untouched until its products are done.  In step 0 the previous stage
// `pend` is released once its last products are done.
template <int FOCUS, Kind KIND, bool PAIR, int S>
__device__ __forceinline__ void mma_step(int (&acc)[2][2][32], Frag& cur,
                                         Frag& prev, const unsigned char* st,
                                         uint64_t db, uint32_t keep,
                                         bool first_stage, int w, int g,
                                         int t, uint64_t* pend) {
  // the tile's first step sets the sums; the others add to them
  const bool first = S == 0 && first_stage;
  load_a<FOCUS>(st, S, w, g, t, cur.a);
  if constexpr (!PAIR) {
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cur.a[b][i] = (cur.a[b][i] & keep) | (mask4(cur.a[b][i]) & ~keep);
  }
  fence_frag(cur);
  wgmma_fence();
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    if constexpr (KIND == WIDE)
      wgmma_s8_m64n128k32(acc[b][0], acc[b][1], cur.a[b], db + 2 * S, first);
    else
      wgmma_s8_m64n64k32(acc[b][0], cur.a[b], db + 2 * S, first);
  }
  wgmma_commit();
  wgmma_wait<1>();                       // the previous step's products
  fence_frag(prev);
  if (S == 0 && pend != nullptr) release(pend);
}  // mma_step

// One tile's contraction stages [0, nk) for consumer warpgroup c (its
// chunk pair in shared slots 2c and 2c + 1; its A box `aoff` bytes into
// the stage), 4 k32 steps a stage (BK = 128) alternating two operand sets;
// each stage is released one step after its last products issue.
template <int FOCUS, Kind KIND, bool PAIR>
__device__ __forceinline__ void mainloop(int (&acc)[2][2][32], Frag& f0,
                                         Frag& f1, unsigned char* smem,
                                         uint64_t* full, uint64_t* empty,
                                         int& stage, unsigned& phase, int nk,
                                         int c, uint32_t keep, int aoff,
                                         int w, int g, int t) {
  using R = Ring<PAIR>;
  uint64_t* pend = nullptr;              // the stage to release
  for (int kt = 0; kt < nk; ++kt) {
    mbar_wait(&full[stage], phase);
    const unsigned char* st = smem + stage * R::STAGE_BYTES;
    if constexpr (KIND == NONE) {
      release(&empty[stage]);
    } else {
      const uint64_t db =
          desc_sw128(st + R::ASLOTS * A_BYTES + 2 * c * B_BYTES);
      const unsigned char* sa = PAIR ? st + aoff : st;
      mma_step<FOCUS, KIND, PAIR, 0>(acc, f0, f1, sa, db, keep, kt == 0, w,
                                     g, t, pend);
      mma_step<FOCUS, KIND, PAIR, 1>(acc, f1, f0, sa, db, keep, kt == 0, w,
                                     g, t, pend);
      mma_step<FOCUS, KIND, PAIR, 2>(acc, f0, f1, sa, db, keep, kt == 0, w,
                                     g, t, pend);
      mma_step<FOCUS, KIND, PAIR, 3>(acc, f1, f0, sa, db, keep, kt == 0, w,
                                     g, t, pend);
      pend = &empty[stage];
    }
    if (++stage == R::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if constexpr (KIND != NONE) {
    wgmma_wait<0>();
    release(pend);
  }
}

// flip_out staging [32 columns][128 rows] int32: row m of column v at
// m ^ swf(v), conflict-free for both the fragment writes and the row reads
template <int FOCUS>
__device__ __forceinline__ int swf(int v) {
  return FOCUS == 0 ? 8 * ((v >> 1) & 3) : (v >> 1) & 3;
}

// natural staging [128 rows][32 columns] int32: 16-byte chunk ch of row m
// at ch ^ swn(m)
template <int FOCUS>
__device__ __forceinline__ int swn(int m) {
  return FOCUS == 0 ? m & 7 : (m >> 2) & 7;
}

// EPI: 0 raw flip_out, 1 dq flip_out, 2 raw natural layout
template <int FOCUS, int EPI>
__device__ __forceinline__ void epilogue(const Args& a, int (&acc)[2][2][32],
                                         int* stg, int c, int cg0, int nj,
                                         long long m0, int w, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int rows = static_cast<int>(min(static_cast<long long>(BM), a.nf - m0));
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (j >= nj) continue;
    const int cg = cg0 + j;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      named_barrier(1 + c, 128);         // the staging tile is free
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int m = tile_row<FOCUS>(b, w, g, h);
            const int* d = &acc[b][j][4 * (4 * half + nn) + 2 * h];
            const int v = 8 * nn + 2 * t;
            if constexpr (EPI == 2) {
              const int ch = v >> 2;
              *reinterpret_cast<int2*>(
                  stg + m * 32 + ((ch ^ swn<FOCUS>(m)) << 2) + (v & 3)) =
                  make_int2(d[0], d[1]);
            } else {
              stg[v * BM + (m ^ swf<FOCUS>(v))] = d[0];
              stg[(v + 1) * BM + (m ^ swf<FOCUS>(v + 1))] = d[1];
            }
          }
      named_barrier(1 + c, 128);
      const int vb = cg * CH + 32 * half;  // virtual column of staging column 0
      if constexpr (EPI == 2) {
        const bool vec = a.cm % 4 == 0 && a.K % 4 == 0;
#pragma unroll 2
        for (int i = 0; i < 8; ++i) {
          const int m = 32 * w + 4 * i + (lane >> 3), ch = lane & 7;
          if (m >= rows) continue;
          const long long mg = m0 + m;
          const int4 x = *reinterpret_cast<const int4*>(
              stg + m * 32 + ((ch ^ swn<FOCUS>(m)) << 2));
          const int v = vb + 4 * ch;
          int* dst;
          int lim;
          if (v < a.ckp) {
            dst = a.pm + mg * a.cm + v;
            lim = a.cm - v;
          } else {
            dst = a.bv + mg * a.K + (v - a.ckp);
            lim = a.K - (v - a.ckp);
          }
          if (lim >= 4 && vec) {
            __stcs(reinterpret_cast<int4*>(dst), x);
          } else {
            if (lim > 0) __stcs(dst, x.x);
            if (lim > 1) __stcs(dst + 1, x.y);
            if (lim > 2) __stcs(dst + 2, x.z);
            if (lim > 3) __stcs(dst + 3, x.w);
          }
        }
      } else {
#pragma unroll 2
        for (int i = 0; i < 8; ++i) {
          const int vr = 8 * w + i, v = vb + vr;
          const int* row = stg + vr * BM;
          const int sw = swf<FOCUS>(vr);
          // the row's first element of this tile: Pt / PMm (scale syz) or
          // BVf (sz) with dq, else PM or BV
          int* dst;
          float scale = 0.f;
          if (v < a.ckp) {
            if (v >= a.cm) continue;
            if constexpr (EPI == 1) {
              dst = reinterpret_cast<int*>(v < a.C ? a.pt + v * a.nf
                                                   : a.pmm + (v - a.C) * a.nf);
              scale = a.syz[v];
            } else {
              dst = a.pm + v * a.nf;
            }
          } else {
            const int k = v - a.ckp;
            if (k >= a.K) continue;
            if constexpr (EPI == 1) {
              dst = reinterpret_cast<int*>(a.bvf + k * a.nf);
              scale = a.sz[k];
            } else {
              dst = a.bv + k * a.nf;
            }
          }
          dst += m0;
          for (int mm = lane; mm < rows; mm += 32) {
            const int val = row[mm ^ sw];
            if constexpr (EPI == 1)
              __stcs(reinterpret_cast<float*>(dst) + mm,
                     static_cast<float>(val) * scale);
            else
              __stcs(dst + mm, val);
          }
        }
      }
    }
  }
}

// The ring kernel's body: K8a/K8b (PAIR false: amap0 = amap1 = V8's map)
// or K6 (PAIR true: amap0 M8's, amap1 W8's).
template <int FOCUS, int EPI, bool PAIR>
__device__ __forceinline__ void ring(const CUtensorMap* amap0,
                                     const CUtensorMap* amap1,
                                     const CUtensorMap* yzmap,
                                     const Args& a) {
  using R = Ring<PAIR>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + R::STAGES * R::STAGE_BYTES + 2 * STAGING);
  uint64_t* empty = full + R::STAGES;
  // the warp index, read through a shuffle so the compiler knows it is
  // warp-uniform: the tensor-core products sit in branches on it
  const int tid = threadIdx.x, warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  if (tid == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);  // see release
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {                       // producer: one thread
    setmaxnreg_dec<40>();
    if (tid != 256) return;
    int stage = 0;
    unsigned phase = 0;
    for (long long u = blockIdx.x; u < a.tiles; u += gridDim.x) {
      int ft, ct;
      tile_of<FOCUS>(a, u, ft, ct);
      const int m0 = ft * BM;
      // the tile's YZ8T boxes, worked out once: slot 2c + j (consumer c's
      // pair) reads YZ8T rows row[2c + j].. (a mask chunk v.., a value
      // chunk C + (v - ckp)..), or nothing (-1).  The stage loop below is
      // on the ring's critical path in mode 1, so it only issues loads
      // (with the boxes worked out in it, Netflix mode 1 ran 1.24x slower;
      // PERF.md §6).
      int row[4], nbox = 0;
      bool val[2];
      int count[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int first;
        chunk_pair(a, 2 * ct + c, first, count[c], val[c]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int v = (first + j) * CH;
          row[2 * c + j] =
              j >= count[c] ? -1 : v < a.ckp ? v : a.C + (v - a.ckp);
          nbox += j < count[c];
        }
      }
      // the A boxes: K8 V8's; K6 M8's for a mask tile, W8's for a value
      // tile, and in the mixed tile (two A slots) W8's in the second slot
      const CUtensorMap* am = PAIR && val[0] ? amap1 : amap0;
      const bool mixed = PAIR && !val[0] && val[1] && count[1] > 0;
      const unsigned tx = (mixed ? 2 : 1) * A_BYTES + nbox * B_BYTES;
      for (int kt = 0; kt < a.nk; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * R::STAGE_BYTES;
        mbar_expect_tx(&full[stage], tx);
        const int k0 = kt * BK;
        const int x = FOCUS == 0 ? k0 : m0, y = FOCUS == 0 ? m0 : k0;
        tma_load_2d(st, am, x, y, &full[stage]);
        if (mixed) tma_load_2d(st + A_BYTES, amap1, x, y, &full[stage]);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (row[b] >= 0)
            tma_load_2d(st + R::ASLOTS * A_BYTES + b * B_BYTES, yzmap, k0,
                        row[b], &full[stage]);
        if (++stage == R::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup c = warps 4c .. 4c + 3
  setmaxnreg_inc<232>();
  const int c = warp >> 2, w = warp & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  int* stg = reinterpret_cast<int*>(smem + R::STAGES * R::STAGE_BYTES +
                                    c * STAGING);
  int acc[2][2][32] = {};               // set by each tile's first step
  Frag f0 = {}, f1 = {};                 // operands of alternate steps
  int stage = 0;
  unsigned phase = 0;
  for (long long u = blockIdx.x; u < a.tiles; u += gridDim.x) {
    int ft, ct;
    tile_of<FOCUS>(a, u, ft, ct);
    int cg0, nj;                         // chunk j: cg0 + j
    bool val;
    chunk_pair(a, 2 * ct + c, cg0, nj, val);
    const uint32_t keep = val ? 0xffffffffu : 0u;
    // the second consumer's value pair in the mixed tile reads the second
    // A slot (an address chosen once a tile: no branch around a product)
    const int aoff = PAIR && c == 1 && val && 2 * ct < a.mp ? A_BYTES : 0;
    if (nj == 2)
      mainloop<FOCUS, WIDE, PAIR>(acc, f0, f1, smem, full, empty, stage,
                                  phase, a.nk, c, keep, aoff, w, g, t);
    else if (nj == 1)
      mainloop<FOCUS, NARROW, PAIR>(acc, f0, f1, smem, full, empty, stage,
                                    phase, a.nk, c, keep, aoff, w, g, t);
    else
      mainloop<FOCUS, NONE, PAIR>(acc, f0, f1, smem, full, empty, stage,
                                  phase, a.nk, c, keep, aoff, w, g, t);
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) fence_operand(acc[b][j][e]);
    epilogue<FOCUS, EPI>(a, acc, stg, c, cg0, nj,
                         static_cast<long long>(ft) * BM, w, lane);
  }
}

template <int FOCUS, int EPI>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_pair_kernel(__grid_constant__ const CUtensorMap v8map,
                  __grid_constant__ const CUtensorMap yzmap, const Args a) {
  ring<FOCUS, EPI, false>(&v8map, &v8map, &yzmap, a);
}

template <int FOCUS, bool DQ>
__global__ void __launch_bounds__(NTHREADS, 1)
pair_contract_kernel(__grid_constant__ const CUtensorMap m8map,
                     __grid_constant__ const CUtensorMap w8map,
                     __grid_constant__ const CUtensorMap yzmap,
                     const Args a) {
  ring<FOCUS, DQ ? 1 : 0, true>(&m8map, &w8map, &yzmap, a);
}

// Maps the operands, completes `a` (a.cm set by the caller) and launches
// K8 (src1 null: src0 is V8) or K6 (src0 M8, src1 W8), all [n0, n1].
template <int FOCUS, int EPI, bool PAIR>
int launch(Args a, const void* src0, const void* src1, long long n0,
           long long n1, const void* yzt, void* stream) {
  using R = Ring<PAIR>;
  const void* kern;
  if constexpr (PAIR) kern = reinterpret_cast<const void*>(
      pair_contract_kernel<FOCUS, EPI == 1>);
  else kern = reinterpret_cast<const void*>(fused_pair_kernel<FOCUS, EPI>);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_focus = FOCUS == 0 ? n0 : n1;
  const long long n_contract = FOCUS == 0 ? n1 : n0;
  if (a.nf > n_focus) return static_cast<int>(cudaErrorInvalidValue);
  if (a.nf == 0) return 0;
  if (n_contract > (1ll << 31) - BK || n_focus > (1ll << 31) - BM)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map0, map1, yzmap;
  if (!map_bytes_2d(&map0, src0, n0, n1, 128) ||
      (PAIR && !map_bytes_2d(&map1, src1, n0, n1, 128)) ||
      !map_bytes_2d(&yzmap, yzt, a.C + a.K, n_contract, CH))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ckp = (a.cm + CH - 1) / CH * CH;
  a.nmask = a.ckp / CH;
  a.mp = (a.nmask + 1) / 2;
  a.np = a.mp + ((a.K + CH - 1) / CH + 1) / 2;
  a.n_ct = (a.np + 1) / 2;
  a.n_ft = static_cast<int>((a.nf + BM - 1) / BM);
  a.nk = static_cast<int>((n_contract + BK - 1) / BK);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  a.tiles = static_cast<long long>(a.n_ft) * a.n_ct;
  const long long grid = std::min<long long>(sms, a.tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (PAIR)
    pair_contract_kernel<FOCUS, EPI == 1>
        <<<static_cast<unsigned>(grid), NTHREADS, R::SMEM, st>>>(
            map0, map1, yzmap, a);
  else
    fused_pair_kernel<FOCUS, EPI>
        <<<static_cast<unsigned>(grid), NTHREADS, R::SMEM, st>>>(
            map0, yzmap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point of K8a/K8b (loaded with ctypes).  v8 is contiguous
// [n0, n1] int8 with n0 and n1 multiples of 16; yzt is contiguous
// [C + K, n_contract] int8 (n_contract = n1 for focus 0, n0 for focus 1);
// nf <= the focus extent.  dq = 0: pm [C + K, nf] and bv [K, nf] int32;
// dq = 1: syz [C + K] and sz [K] float32 scales, pt [C, nf], pmm and bvf
// [K, nf] float32; dq = 2: the natural layout, pm [nf, C + K] and bv
// [nf, K] int32.  Returns the launch's CUDA error (0 on success).
extern "C" int bdf_fused_pair_i8(const void* v8, long long n0, long long n1,
                                 int focus, const void* yzt, int C, int K,
                                 long long nf, int dq, void* pm, void* bv,
                                 const void* syz, const void* sz, void* pt,
                                 void* pmm, void* bvf, void* stream) {
  if (n0 % 16 || n1 % 16 || C < 1 || K < 1 || (focus != 0 && focus != 1) ||
      dq < 0 || dq > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.nf = nf;
  a.C = C;
  a.K = K;
  a.cm = C + K;
  a.pm = static_cast<int*>(pm);
  a.bv = static_cast<int*>(bv);
  a.syz = static_cast<const float*>(syz);
  a.sz = static_cast<const float*>(sz);
  a.pt = static_cast<float*>(pt);
  a.pmm = static_cast<float*>(pmm);
  a.bvf = static_cast<float*>(bvf);
  if (focus == 0)
    return dq == 1   ? launch<0, 1, false>(a, v8, nullptr, n0, n1, yzt, stream)
           : dq == 2 ? launch<0, 2, false>(a, v8, nullptr, n0, n1, yzt, stream)
                     : launch<0, 0, false>(a, v8, nullptr, n0, n1, yzt, stream);
  return dq == 1   ? launch<1, 1, false>(a, v8, nullptr, n0, n1, yzt, stream)
         : dq == 2 ? launch<1, 2, false>(a, v8, nullptr, n0, n1, yzt, stream)
                   : launch<1, 0, false>(a, v8, nullptr, n0, n1, yzt, stream);
}

// Plain C entry point of K6 (loaded with ctypes).  m8 and w8 are
// contiguous [n0, n1] int8 with n0 and n1 multiples of 16 and 16-byte
// aligned bases; yzt is contiguous [C + K, n_contract] int8 (n_contract =
// n1 for focus 0, n0 for focus 1); nf <= the focus extent.  dq = 0: pm
// [C, nf] and bv [K, nf] int32; dq = 1: syz [C] and sz [K] float32 scales,
// pt [C, nf] and bq [K, nf] float32.  Returns the launch's CUDA error (0
// on success).
extern "C" int bdf_pair_contract_i8(const void* m8, const void* w8,
                                    long long n0, long long n1, int focus,
                                    const void* yzt, int C, int K,
                                    long long nf, int dq, void* pm, void* bv,
                                    const void* syz, const void* sz, void* pt,
                                    void* bq, void* stream) {
  if (n0 % 16 || n1 % 16 || C < 1 || K < 1 || (focus != 0 && focus != 1) ||
      dq < 0 || dq > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.nf = nf;
  a.C = C;
  a.K = K;
  a.cm = C;
  a.pm = static_cast<int*>(pm);
  a.bv = static_cast<int*>(bv);
  a.syz = static_cast<const float*>(syz);
  a.sz = static_cast<const float*>(sz);
  a.pt = static_cast<float*>(pt);
  a.bvf = static_cast<float*>(bq);
  if (focus == 0)
    return dq ? launch<0, 1, true>(a, m8, w8, n0, n1, yzt, stream)
              : launch<0, 0, true>(a, m8, w8, n0, n1, yzt, stream);
  return dq ? launch<1, 1, true>(a, m8, w8, n0, n1, yzt, stream)
            : launch<1, 0, true>(a, m8, w8, n0, n1, yzt, stream);
}
