// Fused masked-pair contraction with float operands (K8c, K8d): both
// Gramian orientations of the fused sparse regime from the ONE stored
// int8 value array, for a relation that is off the s8 path.
//
// Replaces the TPU kernels of bayesiandatafusion_jl_tpu/ops/pallas_fused.py
// `fused_pair_pallas` (:345) in its float variants: flip_out
// `_kern_focus_rows_t` (:252) / `_kern_focus_cols_t` (:280) (K8c) and the
// natural layout `_kern_focus_rows` (:303) / `_kern_focus_cols` (:322)
// (K8d).  With V8 [n0, n1] the stored codes (0 = unobserved) and YZT
// [C+K, n_contract] the partner table [Ypack | U] in the operand type
// (bfloat16, float32 or float64), transposed so that the contraction axis
// is contiguous, it computes for the focus mode f (f = 0: V8's rows,
// contracting n1; f = 1: V8's columns, contracting n0)
//
//     PM[c, i] = sum_p (V8_f[i, p] != 0) * YZT[c, p]      c < C + K
//     BV[k, i] = sum_p  V8_f[i, p]       * YZT[C + k, p]  k < K
//
// with the 0/1 mask and the codes in the operand type (codes up to 127
// are exact in bfloat16, so every product is exact in float32) and the
// sums in float32 (float64 for float64 operands), written in the packed
// sampler's layout (PM [C+K, n_focus], BV [K, n_focus]) or the natural one
// (PM [n_focus, C+K], BV [n_focus, K]).  No transposed copy of V8 and no
// mask in device memory.
//
// What bounds it on an H100: the bfloat16 design multiplies every cell of
// the extent on the tensor cores, 2 n0 n1 (C + 2K) operations: 10.22 ms at
// the 989 TFLOP/s dense bfloat16 peak at Netflix (480,189 x 17,770, K =
// 32), 13.16 ms at ML-10M K = 128 and 3.41 ms at K = 64; the bytes (V8
// once, the float32 outputs once) take 2.89 and 1.01 ms at 3.35 TB/s.  So
// the tensor cores are the floor.  The first version ran at 7-9% of it: a
// 2-stage register-staged loop with one __syncthreads a step, the V8 tile
// written to shared memory twice, widened to bfloat16 as codes and as mask
// (4x the bytes of one int8 copy), and mma.sync fed by 32-bit shared
// loads.  This one runs on K8a/K8b's TMA ring (hopper_ring.cuh) at
// 39-59% of it (PERF.md §6), a float32 table at 67-70% of its own:
//
// - Loads: an asynchronous ring of STAGES = 4 stages of 128 contraction
//   elements, each one TMA box of V8 (128 focus x 128 contraction bytes)
//   and up to four 64-row boxes of YZT (two chunks x two 64-element
//   halves), filled by one producer thread that works out a tile's boxes
//   once, and completing on an mbarrier; every consumer thread releases a
//   stage through a second mbarrier.  setmaxnreg gives the consumers 232
//   registers, the producer 40.  TMA's zero fill makes the ragged edges: a
//   zero code is a zero mask, and YZT rows past C + K and contraction
//   elements past the extent read 0.
// - One int8 copy of the V8 tile a stage.  Each consumer reads 16-bit
//   words of it (two codes) and widens them in registers to packed
//   bfloat16 pairs, the codes or their 0/1 mask (code2, mask2: integer
//   ops and one bf16x2 FMA, exact); no bfloat16 or mask tile is stored.
//   Mode 1's tile is [contraction x focus] and a register A has no
//   transpose: each thread's two MMA rows are two adjacent focus columns,
//   read as one 16-bit word from each of the step's contraction rows and
//   transposed with __byte_perm; the epilogue writes each row back to its
//   column.  Both modes read 4 words a step, conflict-free, and run within
//   1.2x of each other.
// - Tensor cores: wgmma.mma_async m64nNk16 f32.bf16.bf16, A from
//   registers, B the YZT rows, K-major as stored (a 128-byte box row is 64
//   elements), through a descriptor of the 128-byte-swizzled tile.  Each
//   step's products run while the next step's operand is made.  No
//   product sits in a branch of its mainloop: each chunk kind (mask,
//   value) and count (two: N = 128; one: N = 64) has a mainloop of its
//   own, chosen once a tile.  `mma.sync.m16n8k16` on the same ring (B by
//   ldmatrix) ran 1.25-1.65x slower.
// - The float32 sums: wgmma adds each step into its accumulator with
//   truncation, so one long chain biases a one-sign sum low (2.7e-3 of
//   the largest sum over Netflix's 480,189-element contraction, measured
//   on this card).  Each 1,024 contraction elements (8 stages) are summed
//   from zero and added into float32 totals by ordinary adds: 2.8e-6 at
//   the worst reading there, 1.0e-5 at 4,096.  The totals are a second
//   accumulator set as large as the first, so a consumer warpgroup holds
//   64 focus rows x 128 virtual columns (64 + 64 floats a thread) and a
//   CTA tile is 128 x 128, not K8a's 128 x 256: a stage draws 48 KB from
//   L2 for 4.2 MFLOP, ~11 TB/s at the bfloat16 peak.
// - Tiles and order: the virtual columns are [0, ckp) the mask columns
//   (YZT rows 0 .. C+K-1, ckp = C + K rounded up to 64) and [ckp, ckp + K)
//   the value columns (YZT rows C .. C+K-1 against the raw codes), in
//   chunks of 64 paired by kind; a tile is 128 focus rows x one pair.  One
//   CTA per SM walks the tiles persistently in a grouped order: groups of
//   G focus tiles, pairs outer within a group.  G is K8a's, 16 in mode 0
//   and 2 in mode 1: 4 in mode 0 ran within 2% of 16, 8 in mode 1 1.3x
//   slower.
// - Epilogue: a consumer stages 64 focus rows x 64 columns of totals in
//   its own 16 KB of shared memory (outside the ring, which already holds
//   the next tile's loads), then writes the flip_out layouts as coalesced
//   rows along n_focus and the natural layout as 16-byte stores along
//   C + K, all streaming stores.
//
// - A float32 table (the default configuration's, e.g. at Netflix scale)
//   runs on the same ring as its three exact bfloat16 pieces: t = h + m +
//   l, each piece the next 8 significant bits of t (h = t with its low 16
//   bits cleared, m the same of t - h, l = t - h - m; all three exact for
//   |t| >= 2^-110, never overflowing, unlike a rounded h near FLT_MAX).
//   The codes and the mask are exact in bfloat16, so every product is
//   exact in float32, and the sums meet the float32 tolerance where TF32
//   (11 bits, 5e-4 a product) cannot.  A stage's V8 box is widened once
//   into A registers and feeds the products with all three pieces: 3x the
//   tensor work of a bfloat16 table (2.75 ms a mode at ML-10M K = 32, 30.7
//   at Netflix), against 13.5 / 151 ms for the float32 FMA units.  Three
//   pieces at two chunks would need 112 KB a stage, so a float32 tile is
//   one chunk (128 focus rows x 64 columns) and a stage holds the V8 box
//   and each half's three piece boxes (one 3-D TMA box a half), 64 KB, 3
//   stages.  h adds into one accumulator set and m and l into a second: the
//   truncation of a wgmma add is relative to its accumulator, so h's sums
//   see the bfloat16 table's 1,024-element promotion error and m's and l's
//   2^-7 of it; the two are added, smallest first, into the float32
//   totals.  Over a one-sign 480,192-element contraction this reached
//   2.7e-6 of the largest sum; one set for all three pieces reached
//   1.15e-5 (promoted every 8 stages) or 4.4e-6 at 10-16% more time (every
//   2), and two sets promoted every 32 stages 1.0e-5.  Against the simpler
//   choice, the pieces through the bfloat16 ring in three launches and
//   their sums added, it runs 1.5-1.6x faster at ML-10M K = 32 and
//   1.2-1.3x at K = 128 (PERF.md §6).  The pieces are made by one
//   elementwise pass (split_f32_kernel, 4 bytes read and 6 written an
//   element).
//
// The float64 operands run a tiled FMA kernel (64 x 64 outputs a CTA, 4 x
// 4 a thread, 16 contraction elements a step): float64 sums are what
// float64 asks for, which no tensor-core type gives.  It is the card's
// parity seam with the reference (float64 chains in the tests), on no
// planned configuration, and was not redesigned.
#include <algorithm>

#include "fused_pair.cuh"
#include "hopper_ring.cuh"

namespace {

// ---- bfloat16 products: the TMA ring ------------------------------------

namespace ring {

using namespace hopper;

constexpr int BM = 128;                  // focus rows (mode 1: columns) a tile
constexpr int BK = 128;                  // contraction elements a stage
constexpr int CH = 64;                   // virtual columns a chunk
constexpr int GROUP0 = 16, GROUP1 = 2;   // focus tiles a group, by mode
constexpr int PROMOTE = 8;               // stages a partial sum spans
constexpr int A_BYTES = BM * BK;         // the V8 box (int8)
constexpr int B_BYTES = CH * 128;        // a chunk's YZT box: 64 elements
constexpr int STAGING = 64 * 64 * 4;     // a consumer's epilogue tile
constexpr int NTHREADS = 384;            // producer warpgroup + 2 consumers

// The ring of a table of NP bfloat16 pieces: 1 (a bfloat16 table: a tile
// is two chunks, and a stage's half holds both chunks' boxes) or 3 (a
// float32 table's pieces: a tile is one chunk, and a half holds its three
// pieces' boxes)
template <int NP>
struct Ring {
  static constexpr int NB = NP == 1 ? 2 : 3;     // YZT boxes a half-stage
  static constexpr int PER = NP == 1 ? 2 : 1;    // chunks a tile
  static constexpr int STAGES = NP == 1 ? 4 : 3;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * NB * B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * STAGING +
                              2 * STAGES * 8 + 1024;  // + alignment slack
};

// a tile's products: one bfloat16 chunk (N = 64), two (N = 128), or one
// chunk of a float32 table's three pieces (3 x N = 64)
enum { ONE = 0, TWO = 1, SPLIT = 2 };

struct Args {
  long long nf;          // focus rows written (<= stored focus extent)
  int C, K, ck, ckp;     // ck = C + K; ckp: first value column
  int nmask, mp, np;     // mask chunks, mask tiles, tiles a focus tile
  int n_ft, nk;          // focus tiles, contraction stages
  long long tiles;       // n_ft * np
  float* pm;             // [C + K, nf], natural layout [nf, C + K]
  float* bv;             // [K, nf], natural layout [nf, K]
};

// tile u in the grouped order: groups of G focus tiles (the last one
// shorter), column tiles outer within a group
template <int FOCUS>
__device__ __forceinline__ void tile_of(const Args& a, long long u, int& ft,
                                        int& p) {
  constexpr int G = FOCUS == 0 ? GROUP0 : GROUP1;
  const long long per = static_cast<long long>(G) * a.np;
  const int grp = static_cast<int>(u / per);
  const int w = static_cast<int>(u - grp * per);
  const int gs = min(G, a.n_ft - grp * G);
  p = w / gs;
  ft = grp * G + w % gs;
}

// Column tile p, PER chunks at most: the mask chunks PER by PER, then the
// value chunks PER by PER, so no tile mixes the kinds.  Its first chunk,
// its chunk count and whether it holds value chunks.
template <int PER>
__device__ __forceinline__ void tile_chunks(const Args& a, int p, int& first,
                                            int& count, bool& val) {
  val = p >= a.mp;
  const int q = val ? p - a.mp : p;
  const int n = val ? (a.K + CH - 1) / CH : a.nmask;
  first = (val ? a.nmask : 0) + PER * q;
  count = min(PER, n - PER * q);
}

__device__ __forceinline__ uint32_t lds16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// The int8 codes in bytes 0 and 2 of w (bytes 1 and 3 zero) as a packed
// bfloat16 pair: 0x4300 | low 7 bits is 128 + low7, 0x4300 | sign bit is
// 128 or 256, and their difference, the code, is exact in bfloat16
__device__ __forceinline__ uint32_t code2(uint32_t w) {
  const uint32_t p = (w & 0x007F007Fu) | 0x43004300u;
  const uint32_t q = (w & 0x00800080u) | 0x43004300u;
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d) : "r"(q), "r"(0xBF80BF80u), "r"(p));
  return d;
}

// their 0/1 mask as a packed bfloat16 pair (1.0 = 0x3f80): byte + 255
// carries into bit 8 of its half iff the byte is nonzero
__device__ __forceinline__ uint32_t mask2(uint32_t w) {
  return (((w + 0x00FF00FFu) >> 8) & 0x00010001u) * 0x3F80u;
}

// The A fragment (mma.m16n8k16's, the warp's 16 MMA rows) of k16 step s
// of a stage's V8 box, 128-byte rows in the 128-byte swizzle (16-byte
// chunk ch of row r at ch ^ (r & 7)): {(g, k 2t, 2t+1), (g+8, ..), (g,
// k 2t+8, 2t+9), (g+8, ..)}, the codes (VAL) or their mask.  Mode 0: MMA
// rows are tile rows 64c + 16w + g (+ 8), whose chunk s holds the step.
// Mode 1 (the box is [contraction p][focus column]): MMA rows 16w + g and
// 16w + g + 8 are focus columns 64c + 16w + 2g and + 1, read as one 16-bit
// word from each of the step's contraction rows and transposed with
// __byte_perm.
template <int FOCUS, bool VAL>
__device__ __forceinline__ void load_a(const unsigned char* sa, int s, int c,
                                       int w, int g, int t,
                                       uint32_t (&a)[4]) {
  uint32_t x[4];
  if constexpr (FOCUS == 0) {
    const unsigned char* row =
        sa + (64 * c + 16 * w + g) * BK + ((s ^ g) << 4) + 2 * t;
    x[0] = __byte_perm(lds16(row), 0, 0x4140);
    x[1] = __byte_perm(lds16(row + 8 * BK), 0, 0x4140);
    x[2] = __byte_perm(lds16(row + 8), 0, 0x4140);
    x[3] = __byte_perm(lds16(row + 8 * BK + 8), 0, 0x4140);
  } else {
    const int p = 16 * s + 2 * t, cq = 4 * c + w;   // p & 7 == 2t
    const unsigned char* col = sa + 2 * g;
    const uint32_t h0 = lds16(col + p * BK + ((cq ^ (2 * t)) << 4));
    const uint32_t h1 = lds16(col + (p + 1) * BK + ((cq ^ (2 * t + 1)) << 4));
    const uint32_t h8 = lds16(col + (p + 8) * BK + ((cq ^ (2 * t)) << 4));
    const uint32_t h9 = lds16(col + (p + 9) * BK + ((cq ^ (2 * t + 1)) << 4));
    x[0] = __byte_perm(h0, h1, 0x2420);
    x[1] = __byte_perm(h0, h1, 0x2521);
    x[2] = __byte_perm(h8, h9, 0x2420);
    x[3] = __byte_perm(h8, h9, 0x2521);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = VAL ? code2(x[i]) : mask2(x[i]);
}

// Every consumer thread releases the stage itself: an arrival by one lane
// of a warp sits in a branch or a predicate between two products in
// flight, and ptxas then serializes every wgmma of the kernel (C7513).
__device__ __forceinline__ void release(uint64_t* bar) { mbar_arrive(bar); }

// k16 step S of a stage: acc += A . B^T, A the codes (VAL) or their mask
// in registers, B through the descriptor of the stage's half S / 4: the
// tile's YZT rows (TWO: both chunks, N = 128), or the three pieces' rows
// (SPLIT: h into acc[0], m and l into acc[1]).  The step's products run
// while the next step's operand is made: `prev` stays untouched until
// they are done.  In step 0 the previous stage `pend` is released once
// its last products are done.
template <int FOCUS, bool VAL, int KIND, int S>
__device__ __forceinline__ void mma_step(float (&acc)[2][32],
                                         uint32_t (&cur)[4],
                                         uint32_t (&prev)[4],
                                         const unsigned char* st, uint64_t db,
                                         int c, int w, int g, int t,
                                         uint64_t* pend) {
  constexpr int NB = Ring<KIND == SPLIT ? 3 : 1>::NB;
  load_a<FOCUS, VAL>(st, S, c, w, g, t, cur);
#pragma unroll
  for (int i = 0; i < 4; ++i) fence_operand(cur[i]);
  wgmma_fence();
  const uint64_t d = db + (S >> 2) * (NB * B_BYTES >> 4) + 2 * (S & 3);
  if constexpr (KIND == TWO) {
    wgmma_bf16_m64n128k16(acc[0], acc[1], cur, d);
  } else if constexpr (KIND == ONE) {
    wgmma_bf16_m64n64k16(acc[0], cur, d);
  } else {
    wgmma_bf16_m64n64k16(acc[0], cur, d);
    wgmma_bf16_m64n64k16(acc[1], cur, d + (B_BYTES >> 4));
    wgmma_bf16_m64n64k16(acc[1], cur, d + 2 * (B_BYTES >> 4));
  }
  wgmma_commit();
  wgmma_wait<1>();                       // the previous step's products
#pragma unroll
  for (int i = 0; i < 4; ++i) fence_operand(prev[i]);
  if (S == 0 && pend != nullptr) release(pend);
}

// One tile's contraction stages [0, nk) for a consumer warpgroup, 8 k16
// steps a stage alternating two operand sets, the partial sums `acc` added
// into the float32 totals `tot` and set to zero every PROMOTE stages, once
// their products are done (every product accumulates; SPLIT: acc[1], the
// smaller, first).  No product sits in a branch: the kind (VAL) and the
// products (KIND) are template arguments, chosen once a tile.
template <int FOCUS, bool VAL, int KIND>
__device__ __forceinline__ void mainloop(float (&acc)[2][32],
                                         float (&tot)[2][32],
                                         uint32_t (&f0)[4], uint32_t (&f1)[4],
                                         unsigned char* smem, uint64_t* full,
                                         uint64_t* empty, int& stage,
                                         unsigned& phase, int nk, int c,
                                         int w, int g, int t) {
  using R = Ring<KIND == SPLIT ? 3 : 1>;
  constexpr int NA = KIND == ONE ? 1 : 2;    // partial sum sets
  constexpr int NT = KIND == TWO ? 2 : 1;    // total sets
#pragma unroll
  for (int j = 0; j < NA; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) tot[j][e] = 0.f;
  for (int k0 = 0; k0 < nk; k0 += PROMOTE) {
    const int k1 = min(nk, k0 + PROMOTE);
    uint64_t* pend = nullptr;            // the stage to release
    for (int kt = k0; kt < k1; ++kt) {
      mbar_wait(&full[stage], phase);
      const unsigned char* st = smem + stage * R::STAGE_BYTES;
      const uint64_t db = desc_sw128(st + A_BYTES);
      mma_step<FOCUS, VAL, KIND, 0>(acc, f0, f1, st, db, c, w, g, t, pend);
      mma_step<FOCUS, VAL, KIND, 1>(acc, f1, f0, st, db, c, w, g, t, pend);
      mma_step<FOCUS, VAL, KIND, 2>(acc, f0, f1, st, db, c, w, g, t, pend);
      mma_step<FOCUS, VAL, KIND, 3>(acc, f1, f0, st, db, c, w, g, t, pend);
      mma_step<FOCUS, VAL, KIND, 4>(acc, f0, f1, st, db, c, w, g, t, pend);
      mma_step<FOCUS, VAL, KIND, 5>(acc, f1, f0, st, db, c, w, g, t, pend);
      mma_step<FOCUS, VAL, KIND, 6>(acc, f0, f1, st, db, c, w, g, t, pend);
      mma_step<FOCUS, VAL, KIND, 7>(acc, f1, f0, st, db, c, w, g, t, pend);
      pend = &empty[stage];
      if (++stage == R::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    release(pend);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
#pragma unroll
      for (int j = 0; j < NA; ++j) fence_operand(acc[j][e]);
      if constexpr (KIND == SPLIT) {
        tot[0][e] += acc[1][e] + acc[0][e];
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) tot[j][e] += acc[j][e];
      }
#pragma unroll
      for (int j = 0; j < NA; ++j) acc[j][e] = 0.f;
    }
  }
}

// flip_out staging [64 columns][64 rows] float32: row m of column v at
// m ^ swf(v), conflict-free for the fragment writes and the row reads
template <int FOCUS>
__device__ __forceinline__ int swf(int v) {
  const int t = (v >> 1) & 3;
  return FOCUS == 0 ? 8 * t : (t & 1) | ((t >> 1) << 4);
}

// natural staging [64 rows][64 columns] float32: 16-byte chunk ch of row
// m at ch ^ swn(m)
template <int FOCUS>
__device__ __forceinline__ int swn(int m) {
  return FOCUS == 0 ? m & 7 : (m >> 1) & 7;
}

// A consumer's 64 focus rows x (nj <= NJ chunks) of totals, one chunk at a
// time through its staging tile: flip_out as coalesced rows along n_focus,
// the natural layout as 16-byte stores along C + K, streaming stores.
template <int FOCUS, bool NAT, int NJ>
__device__ __forceinline__ void epilogue(const Args& a, float (&tot)[2][32],
                                         float* stg, int c, int cg0, int nj,
                                         long long m0, int w, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const long long mc = m0 + 64 * c;      // the consumer's first focus row
  const int rows = static_cast<int>(
      max(0LL, min(64LL, a.nf - mc)));
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (j >= nj) continue;
    named_barrier(1 + c, 128);           // the staging tile is free
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the sums of MMA row 16w + g + 8h, columns 8nn + 2t, + 1
        const int m = FOCUS == 0 ? 16 * w + g + 8 * h : 16 * w + 2 * g + h;
        const float* d = &tot[j][4 * nn + 2 * h];
        const int v = 8 * nn + 2 * t;
        if constexpr (NAT) {
          *reinterpret_cast<float2*>(
              stg + m * 64 + (((v >> 2) ^ swn<FOCUS>(m)) << 2) + (v & 3)) =
              make_float2(d[0], d[1]);
        } else {
          stg[v * 64 + (m ^ swf<FOCUS>(v))] = d[0];
          stg[(v + 1) * 64 + (m ^ swf<FOCUS>(v + 1))] = d[1];
        }
      }
    named_barrier(1 + c, 128);
    const int vb = (cg0 + j) * CH;       // virtual column of staging column 0
    if constexpr (NAT) {
      const bool vec = a.ck % 4 == 0 && a.K % 4 == 0;
#pragma unroll 2
      for (int i = 0; i < 8; ++i) {
        const int m = 16 * w + 2 * i + (lane >> 4), ch = lane & 15;
        if (m >= rows) continue;
        const float4 x = *reinterpret_cast<const float4*>(
            stg + m * 64 + ((ch ^ swn<FOCUS>(m)) << 2));
        const long long mg = mc + m;
        const int v = vb + 4 * ch;
        float* dst;
        int lim;
        if (v < a.ckp) {
          dst = a.pm + mg * a.ck + v;
          lim = a.ck - v;
        } else {
          dst = a.bv + mg * a.K + (v - a.ckp);
          lim = a.K - (v - a.ckp);
        }
        if (lim >= 4 && vec) {
          __stcs(reinterpret_cast<float4*>(dst), x);
        } else {
          if (lim > 0) __stcs(dst, x.x);
          if (lim > 1) __stcs(dst + 1, x.y);
          if (lim > 2) __stcs(dst + 2, x.z);
          if (lim > 3) __stcs(dst + 3, x.w);
        }
      }
    } else {
#pragma unroll 2
      for (int i = 0; i < 16; ++i) {
        const int vr = 16 * w + i, v = vb + vr;
        const float* row = stg + vr * 64;
        const int sw = swf<FOCUS>(vr);
        float* dst;
        if (v < a.ckp) {
          if (v >= a.ck) continue;
          dst = a.pm + v * a.nf;
        } else {
          const int k = v - a.ckp;
          if (k >= a.K) continue;
          dst = a.bv + k * a.nf;
        }
        dst += mc;
        for (int mm = lane; mm < rows; mm += 32) __stcs(dst + mm, row[mm ^ sw]);
      }
    }
  }
}

// The kernel body for a table of NP pieces (Ring<NP>).  yzmap reads YZT
// [C + K, n_contract] bfloat16 as a byte matrix (NP = 1) or the pieces
// [3, C + K, n_contract] as three (NP = 3).
template <int FOCUS, bool NAT, int NP>
__device__ __forceinline__ void ring_body(const CUtensorMap* v8map,
                                          const CUtensorMap* yzmap,
                                          const Args& a) {
  using R = Ring<NP>;
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
      mbar_init(&empty[s], 256);         // one arrival per consumer thread
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
      int ft, p, first, count;
      bool val;
      tile_of<FOCUS>(a, u, ft, p);
      tile_chunks<R::PER>(a, p, first, count, val);
      // the tile's YZT boxes, worked out once: chunk j reads YZT rows
      // row[j].. (a mask chunk v.., a value chunk C + (v - ckp)..), or
      // nothing (-1); the stage loop only issues loads
      int row[R::PER];
#pragma unroll
      for (int j = 0; j < R::PER; ++j) {
        const int v = (first + j) * CH;
        row[j] = j >= count ? -1 : v < a.ckp ? v : a.C + (v - a.ckp);
      }
      const unsigned bytes = A_BYTES + 2 * count * NP * B_BYTES;
      const int m0 = ft * BM;
      for (int kt = 0; kt < a.nk; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = smem + stage * R::STAGE_BYTES;
        mbar_expect_tx(&full[stage], bytes);
        const int k0 = kt * BK;
        if (FOCUS == 0) tma_load_2d(st, v8map, k0, m0, &full[stage]);
        else tma_load_2d(st, v8map, m0, k0, &full[stage]);
        // half h of the stage (elements k0 + 64h ..): a bfloat16 table's
        // chunk j at box 2h + j (a half's two chunks are one 128-row
        // operand); a float32 table's pieces at boxes 3h .. 3h + 2, one
        // 3-D box
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          unsigned char* dst = st + A_BYTES + h * R::NB * B_BYTES;
          if constexpr (NP == 1) {
#pragma unroll
            for (int j = 0; j < 2; ++j)
              if (row[j] >= 0)
                tma_load_2d(dst + j * B_BYTES, yzmap, 2 * (k0 + 64 * h),
                            row[j], &full[stage]);
          } else {
            tma_load_3d(dst, yzmap, 2 * (k0 + 64 * h), row[0], 0,
                        &full[stage]);
          }
        }
        if (++stage == R::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup c = warps 4c .. 4c + 3, focus rows 64c .. 64c + 63
  setmaxnreg_inc<232>();
  const int c = warp >> 2, w = warp & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  float* stg = reinterpret_cast<float*>(smem + R::STAGES * R::STAGE_BYTES +
                                        c * STAGING);
  float acc[2][32], tot[2][32];          // partial sums, totals
  uint32_t f0[4] = {}, f1[4] = {};       // operands of alternate steps
  int stage = 0;
  unsigned phase = 0;
  for (long long u = blockIdx.x; u < a.tiles; u += gridDim.x) {
    int ft, p, cg0, nj;
    bool val;
    tile_of<FOCUS>(a, u, ft, p);
    tile_chunks<R::PER>(a, p, cg0, nj, val);
    const long long m0 = static_cast<long long>(ft) * BM;
    if constexpr (NP == 1) {
      if (nj == 2) {
        if (val)
          mainloop<FOCUS, true, TWO>(acc, tot, f0, f1, smem, full, empty,
                                     stage, phase, a.nk, c, w, g, t);
        else
          mainloop<FOCUS, false, TWO>(acc, tot, f0, f1, smem, full, empty,
                                      stage, phase, a.nk, c, w, g, t);
      } else {
        if (val)
          mainloop<FOCUS, true, ONE>(acc, tot, f0, f1, smem, full, empty,
                                     stage, phase, a.nk, c, w, g, t);
        else
          mainloop<FOCUS, false, ONE>(acc, tot, f0, f1, smem, full, empty,
                                      stage, phase, a.nk, c, w, g, t);
      }
      epilogue<FOCUS, NAT, 2>(a, tot, stg, c, cg0, nj, m0, w, lane);
    } else {
      if (val)
        mainloop<FOCUS, true, SPLIT>(acc, tot, f0, f1, smem, full, empty,
                                     stage, phase, a.nk, c, w, g, t);
      else
        mainloop<FOCUS, false, SPLIT>(acc, tot, f0, f1, smem, full, empty,
                                      stage, phase, a.nk, c, w, g, t);
      epilogue<FOCUS, NAT, 1>(a, tot, stg, c, cg0, 1, m0, w, lane);
    }
  }
}

// a bfloat16 table
template <int FOCUS, bool NAT>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_pair_bf16_kernel(__grid_constant__ const CUtensorMap v8map,
                       __grid_constant__ const CUtensorMap yzmap,
                       const Args a) {
  ring_body<FOCUS, NAT, 1>(&v8map, &yzmap, a);
}

// a float32 table as its three bfloat16 pieces
template <int FOCUS, bool NAT>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_pair_f32x3_kernel(__grid_constant__ const CUtensorMap v8map,
                        __grid_constant__ const CUtensorMap yzmap,
                        const Args a) {
  ring_body<FOCUS, NAT, 3>(&v8map, &yzmap, a);
}

// NP = 1: yzt is the bfloat16 table [C + K, n_contract]; NP = 3: the
// float32 table's pieces [3, C + K, n_contract] bfloat16 (split_f32_kernel)
template <int FOCUS, bool NAT, int NP>
int launch(const void* v8, long long n0, long long n1, const void* yzt,
           int C, int K, long long nf, void* pm, void* bv, void* stream) {
  using R = Ring<NP>;
  const auto kern = [] {
    if constexpr (NP == 1) return fused_pair_bf16_kernel<FOCUS, NAT>;
    else return fused_pair_f32x3_kernel<FOCUS, NAT>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_focus = FOCUS == 0 ? n0 : n1;
  const long long n_contract = FOCUS == 0 ? n1 : n0;
  if (nf < 0 || nf > n_focus) return static_cast<int>(cudaErrorInvalidValue);
  if (nf == 0) return 0;
  // TMA coordinates are 32-bit: YZT's in bytes
  if (n_contract > (1ll << 30) - BK || n_focus > (1ll << 31) - BM)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.nf = nf;
  a.C = C;
  a.K = K;
  a.ck = C + K;
  a.pm = static_cast<float*>(pm);
  a.bv = static_cast<float*>(bv);
  CUtensorMap v8map, yzmap;
  if (!map_bytes_2d(&v8map, v8, n0, n1, 128) ||
      !(NP == 1 ? map_bytes_2d(&yzmap, yzt, a.ck, 2 * n_contract, CH)
                : map_bytes_3d(&yzmap, yzt, NP, a.ck, 2 * n_contract, CH,
                               NP)))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ckp = (a.ck + CH - 1) / CH * CH;
  a.nmask = a.ckp / CH;
  a.mp = (a.nmask + R::PER - 1) / R::PER;
  a.np = a.mp + ((a.K + CH - 1) / CH + R::PER - 1) / R::PER;
  a.n_ft = static_cast<int>((nf + BM - 1) / BM);
  a.nk = static_cast<int>((n_contract + BK - 1) / BK);
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return static_cast<int>(err);
  a.tiles = static_cast<long long>(a.n_ft) * a.np;
  const long long grid = std::min<long long>(sms, a.tiles);
  kern<<<static_cast<unsigned>(grid), NTHREADS, R::SMEM,
         static_cast<cudaStream_t>(stream)>>>(v8map, yzmap, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ring

// ---- a float32 table's three bfloat16 pieces ------------------------------

// t = h + m + l exactly (|t| >= 2^-110): h is t with its low 16 bits
// cleared, m the same of r = t - h (exact), l = r - m (exact, at most 8
// significant bits); each piece's bfloat16 is its high 16 bits.  Four
// elements a thread: one 16-byte load, one 8-byte store a piece.
__global__ void __launch_bounds__(256)
split_f32_kernel(const float4* __restrict__ src, long long n4,
                 uint2* __restrict__ dst) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float4 v = src[i];
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t q[3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t h = __float_as_uint(x[j]) & 0xFFFF0000u;
      const float r = x[j] - __uint_as_float(h);
      const uint32_t m = __float_as_uint(r) & 0xFFFF0000u;
      const float l = r - __uint_as_float(m);
      q[0][j] = h >> 16;
      q[1][j] = m >> 16;
      q[2][j] = __float_as_uint(l) >> 16;
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
      dst[p * n4 + i] = make_uint2(q[p][0] | (q[p][1] << 16),
                                   q[p][2] | (q[p][3] << 16));
  }
}

// ---- float64 operands: tiled FMA ------------------------------------------

using fused_pair::src_row;

struct Args {
  const int8_t* v8;      // [n0, n1], n0 and n1 multiples of 16
  long long n0, n1;
  const void* yzt;       // [C + K, n_contract] in the operand type
  int C, K, ckp;         // ckp: first value column (C + K rounded up)
  long long nf;          // focus rows written (<= stored focus extent)
  void* pm;              // [C + K, nf], natural layout [nf, C + K]
  void* bv;              // [K, nf], natural layout [nf, K]
};

constexpr int FT = 64;         // focus rows and virtual columns per CTA
constexpr int FK = 16;         // contraction elements per step

template <typename T, int FOCUS, bool NAT>
__global__ void __launch_bounds__(256)
fused_pair_fma_kernel(const Args a) {
  __shared__ T sA[FK][FT + 1];   // mask or codes, by the CTA's columns
  __shared__ T sB[FK][FT + 1];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const long long m0 = static_cast<long long>(blockIdx.y) * FT;
  const int v0 = blockIdx.x * FT;
  const long long n_contract = FOCUS == 0 ? a.n1 : a.n0;
  const bool raw = v0 >= a.ckp;        // CTA-uniform: ckp is a multiple of FT
  const T* yzt = static_cast<const T*>(a.yzt);

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (long long k0 = 0; k0 < n_contract; k0 += FK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + 256 * i;
      // neighbouring threads along V8's contiguous axis
      const int k = FOCUS == 0 ? e & (FK - 1) : e >> 6;
      const int m = FOCUS == 0 ? e >> 4 : e & (FT - 1);
      const long long row = FOCUS == 0 ? m0 + m : k0 + k;
      const long long col = FOCUS == 0 ? k0 + k : m0 + m;
      int c = 0;
      if (row < a.n0 && col < a.n1) c = a.v8[row * a.n1 + col];
      sA[k][m] = raw ? static_cast<T>(c) : static_cast<T>(c != 0);
      const int kb = e & (FK - 1), vb = e >> 4;
      const int s = src_row(a.C + a.K, a.C, a.K, a.ckp, v0 + vb);
      T b = T(0);
      if (s >= 0 && k0 + kb < n_contract)
        b = yzt[static_cast<long long>(s) * n_contract + k0 + kb];
      sB[kb][vb] = b;
    }
    __syncthreads();
    // each step's 16 products are summed from zero and then added to the
    // running sums: a blocked sum, whose rounding error grows with the
    // number of steps and not with the length of the contraction
    T part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = T(0);
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      T x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = sB[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] += x[i] * y[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j];
    __syncthreads();
  }

  const int ck = a.C + a.K;
  T* pm = static_cast<T*>(a.pm);
  T* bv = static_cast<T*>(a.bv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= a.nf) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = v0 + tx + 16 * j;
      if (v < ck) {
        if constexpr (NAT) pm[m * ck + v] = acc[i][j];
        else pm[v * a.nf + m] = acc[i][j];
      } else if (v >= a.ckp && v - a.ckp < a.K) {
        const int k = v - a.ckp;
        if constexpr (NAT) bv[m * a.K + k] = acc[i][j];
        else bv[k * a.nf + m] = acc[i][j];
      }
    }
  }
}

// grid of `tile`-sized CTAs over (virtual columns, focus rows), or an error
int grid_for(const Args& a, int focus, int tile, dim3* grid) {
  const long long n_focus = focus == 0 ? a.n0 : a.n1;
  const long long tiles = (a.nf + tile - 1) / tile;
  if (tiles > 65535 || a.nf > n_focus) return static_cast<int>(cudaErrorInvalidValue);
  *grid = dim3((a.ckp + a.K + tile - 1) / tile, static_cast<unsigned>(tiles));
  return 0;
}

template <typename T, int FOCUS, bool NAT>
int launch_fma(Args a, void* stream) {
  a.ckp = (a.C + a.K + FT - 1) / FT * FT;
  dim3 grid;
  if (int rc = grid_for(a, FOCUS, FT, &grid)) return rc;
  if (a.nf == 0) return 0;
  fused_pair_fma_kernel<T, FOCUS, NAT>
      <<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int FOCUS, bool NAT>
int launch_any(const Args& a, int dtype, void* stream) {
  if (dtype == 0)
    return ring::launch<FOCUS, NAT, 1>(a.v8, a.n0, a.n1, a.yzt, a.C, a.K,
                                       a.nf, a.pm, a.bv, stream);
  if (dtype == 1)
    return ring::launch<FOCUS, NAT, 3>(a.v8, a.n0, a.n1, a.yzt, a.C, a.K,
                                       a.nf, a.pm, a.bv, stream);
  return launch_fma<double, FOCUS, NAT>(a, stream);
}

}  // namespace

// Plain C entry points (loaded with ctypes).
//
// bdf_fused_pair_f: v8 is contiguous [n0, n1] int8 with n0 and n1
// multiples of 16; yzt is contiguous: the table [C + K, n_contract]
// (n_contract = n1 for focus 0, n0 for focus 1) in bfloat16 (dtype 0) or
// float64 (2), or a float32 table's pieces [3, C + K, n_contract] bfloat16
// (dtype 1, from bdf_split_f32); nf <= the focus extent.  pm and bv are
// float32 (float64 for dtype 2): [C + K, nf] and [K, nf], or with nat = 1
// [nf, C + K] and [nf, K].  Returns the launch's CUDA error (0 on success).
extern "C" int bdf_fused_pair_f(const void* v8, long long n0, long long n1,
                                int focus, const void* yzt, int dtype, int C,
                                int K, long long nf, int nat, void* pm,
                                void* bv, void* stream) {
  if (n0 % 16 || n1 % 16 || C < 1 || K < 1 || (focus != 0 && focus != 1) ||
      dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.v8 = static_cast<const int8_t*>(v8);
  a.n0 = n0;
  a.n1 = n1;
  a.yzt = yzt;
  a.C = C;
  a.K = K;
  a.ckp = 0;
  a.nf = nf;
  a.pm = pm;
  a.bv = bv;
  if (focus == 0)
    return nat ? launch_any<0, true>(a, dtype, stream)
               : launch_any<0, false>(a, dtype, stream);
  return nat ? launch_any<1, true>(a, dtype, stream)
             : launch_any<1, false>(a, dtype, stream);
}

// bdf_split_f32: the pieces [3, n] bfloat16 of the float32 array src [n]
// (n a multiple of 4; both 16-byte aligned).  Returns the launch's CUDA
// error (0 on success).
extern "C" int bdf_split_f32(const void* src, long long n, void* dst,
                             void* stream) {
  if (n < 0 || n % 4 || reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long n4 = n / 4;
  const long long blocks = std::min<long long>((n4 + 255) / 256, 1 << 16);
  split_f32_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), n4, static_cast<uint2*>(dst));
  return static_cast<int>(cudaGetLastError());
}
