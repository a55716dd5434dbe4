// The windowed expand (K9): partner rows gathered for observations sorted
// by partner id, a 128-row window of the factor table at a time.
//
// Replaces the TPU kernel of bayesiandatafusion_jl_tpu/ops/pallas_gather.py
// `windowed_expand` (:90; kernel body `_kern` :80, `pallas_call` :106).
// With U [n_table, K] the factor rows (float32 or bfloat16, row-major as
// the port keeps them), a plan from `build_window_plan` (ops/
// gather_expand.py): wmap [n_blocks] the 128-row window of each block of
// 1024 slots and lanes [n_blocks, 1024] the row within that window of each
// slot, it writes
//
//     out[1024 b + s, :] = U[128 wmap[b] + lanes[b, s], :]
//
// the expanded rows in partner-sorted slot order, [n_blocks * 1024, K]
// (the TPU kernel computes the transpose, UT [K, n_table] ->
// [K, n_blocks * 1024], its lane layout).  Rows past the table's end read
// as zeros, as on the zero-padded TPU table; the plan's tail slots repeat
// lane 0.
//
// What bounds it on an H100: its bytes.  It writes the output once
// (1.92 GB at tensor_big's 30M observations in bfloat16 at K = 32), reads
// the lanes once (4 bytes a slot) and one window per block (8 KB there):
// 0.68 ms at 3.35 TB/s.  It does no arithmetic.
//
// Design: one CTA of 256 threads per block of 1024 slots.  The block's
// window (128 x K x itemsize bytes: 16 KB at K = 32 in float32, 64 KB at
// K = 128) and its 1024 lanes are staged in shared memory with coalesced
// vector loads, the widest of 16, 8, 4 or 2 bytes that divides a row.
// The output block is contiguous (1024 rows), so consecutive threads
// write consecutive vectors of it, each read from the staged row its
// slot names: the stores are coalesced and the gather happens in shared
// memory.  Two slots whose rows share banks conflict (a row of 64 bytes,
// bfloat16 at K = 32, fills half the banks): at most a 2-way conflict on
// the shared reads, none on the device-memory traffic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BS = 1024;      // slots per block
constexpr int WIN = 128;      // factor rows per window
constexpr int NTHREADS = 256;

template <typename V>
__global__ void __launch_bounds__(NTHREADS)
windowed_expand_kernel(const unsigned char* __restrict__ u, long long n_table,
                       int row_bytes, const int* __restrict__ lanes,
                       const int* __restrict__ wmap,
                       unsigned char* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_lane = reinterpret_cast<int*>(smem);                    // [BS]
  V* s_win = reinterpret_cast<V*>(smem + BS * sizeof(int));      // [WIN][vpr]
  const long long blk = blockIdx.x;
  const long long r0 = static_cast<long long>(wmap[blk]) * WIN;
  long long nr = n_table - r0;
  nr = nr < 0 ? 0 : (nr > WIN ? WIN : nr);
  const int vpr = row_bytes / static_cast<int>(sizeof(V));       // vectors a row

  // the window's rows (contiguous in U), zeros past the table's end
  const V* src = reinterpret_cast<const V*>(u + r0 * row_bytes);
  const int n_valid = static_cast<int>(nr) * vpr;
  for (int i = threadIdx.x; i < WIN * vpr; i += NTHREADS)
    s_win[i] = i < n_valid ? __ldg(src + i) : V{};
  const int* lsrc = lanes + blk * BS;
  for (int i = threadIdx.x; i < BS; i += NTHREADS)
    s_lane[i] = __ldg(lsrc + i) & (WIN - 1);
  __syncthreads();

  V* o = reinterpret_cast<V*>(out + blk * BS * static_cast<long long>(row_bytes));
  for (int i = threadIdx.x; i < BS * vpr; i += NTHREADS) {
    const int s = i / vpr;
    o[i] = s_win[s_lane[s] * vpr + (i - s * vpr)];
  }
}

template <typename V>
int launch(const void* u, long long n_table, int row_bytes, const int* lanes,
           const int* wmap, long long n_blocks, void* out, cudaStream_t stream) {
  const int smem = BS * static_cast<int>(sizeof(int)) + WIN * row_bytes;
  auto kern = windowed_expand_kernel<V>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<static_cast<unsigned>(n_blocks), NTHREADS, smem, stream>>>(
      static_cast<const unsigned char*>(u), n_table, row_bytes, lanes, wmap,
      static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (loaded with ctypes).  u is contiguous [n_table, K]
// with row_bytes = K * itemsize (a multiple of 2, at most 512); lanes is
// contiguous int32 [n_blocks, 1024], wmap int32 [n_blocks]; out is
// contiguous [n_blocks * 1024, K] of u's type.  u and out are aligned to
// 16 bytes.  Returns the launch's CUDA error (0 on success).
extern "C" int bdf_windowed_expand(const void* u, long long n_table,
                                   int row_bytes, const void* lanes,
                                   const void* wmap, long long n_blocks,
                                   void* out, void* stream) {
  if (n_table < 1 || row_bytes < 2 || row_bytes > 512 || row_bytes % 2 ||
      n_blocks < 1 || n_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* l = static_cast<const int*>(lanes);
  const int* w = static_cast<const int*>(wmap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0)
    return launch<uint4>(u, n_table, row_bytes, l, w, n_blocks, out, st);
  if (row_bytes % 8 == 0)
    return launch<uint2>(u, n_table, row_bytes, l, w, n_blocks, out, st);
  if (row_bytes % 4 == 0)
    return launch<uint32_t>(u, n_table, row_bytes, l, w, n_blocks, out, st);
  return launch<uint16_t>(u, n_table, row_bytes, l, w, n_blocks, out, st);
}
