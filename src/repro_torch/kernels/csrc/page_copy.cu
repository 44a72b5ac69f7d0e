// Page row copies for the MaxMem data plane, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels `page_move` (src/repro/kernels/page_copy.py:34)
// and `page_copy` (src/repro/kernels/page_copy.py:68):
//   page_move:  pool[dst[i]] = pool[src[i]]            (in place, gather semantics)
//   page_copy:  dst_pool[dst[i]] = src_pool[src[i]]    (dst_pool in place)
//
// Bound: bytes. Nothing is computed; each moved row is read once and written
// once, so the least time is 2 * rows * row_bytes over HBM bandwidth
// (3.35 TB/s on an H100 SXM).
//
// Design:
//  * One kernel, `copy_rows`, copies rows as bytes. A warp copies a row at a
//    time (warps grid-stride over the plan); its lanes move 16-byte vectors
//    when the source and destination rows share their alignment modulo 16 (a
//    byte-wise head brings both to a 16-byte boundary, a byte-wise tail ends
//    the row), 4-byte words when they share it modulo 4, and single bytes
//    otherwise. Neighbouring lanes touch neighbouring addresses; a 4 KiB row
//    is eight 16-byte loads and stores per lane. A warp per row (rather than
//    a block) keeps thousands of rows in flight, so the latency of each
//    entry's id read overlaps other warps' copies instead of serialising a
//    block's walk over the plan.
//  * The TPU grid runs in order, so page_move got gather semantics for free:
//    a row is read before any later step writes it. CUDA blocks run in no
//    order, and the data plane relies on write-after-read (a demote vacates a
//    fast frame that a promote of the same sweep fills). So page_move is two
//    launches of `copy_rows` on the same stream: gather every source row into
//    a [M, row] scratch, then scatter the scratch to the destinations. No
//    destination is written before every source has been read.
//  * page_move skips entries with src == dst. Under gather semantics such an
//    entry rewrites a row with its own pre-plan bytes; the data plane pads its
//    fixed-size plans with trash->trash entries, which thus cost one id read.
//  * page_copy is one launch. Its trash padding writes different rows into the
//    trash row from several blocks; the trash row's content is unspecified.
//  * Ids outside [0, rows) are skipped: the kernels never touch memory outside
//    the pools (the contract requires in-range ids; the wrappers do not sync
//    to check them).
//
// C interface (pointers and the stream as void*, loaded with ctypes). Each
// function returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

constexpr int kWarp = 32;

__device__ __forceinline__ void copy_row(const unsigned char* __restrict__ s,
                                         unsigned char* __restrict__ d, long long n,
                                         int lane) {
  const uintptr_t sa = reinterpret_cast<uintptr_t>(s);
  const uintptr_t da = reinterpret_cast<uintptr_t>(d);
  long long i;
  if (((sa ^ da) & 15) == 0) {
    long long head = static_cast<long long>((16 - (sa & 15)) & 15);
    if (head > n) head = n;
    for (i = lane; i < head; i += kWarp) d[i] = s[i];
    const uint4* sv = reinterpret_cast<const uint4*>(s + head);
    uint4* dv = reinterpret_cast<uint4*>(d + head);
    const long long nv = (n - head) >> 4;
#pragma unroll 4
    for (i = lane; i < nv; i += kWarp) dv[i] = sv[i];
    for (i = head + (nv << 4) + lane; i < n; i += kWarp) d[i] = s[i];
  } else if (((sa ^ da) & 3) == 0) {
    long long head = static_cast<long long>((4 - (sa & 3)) & 3);
    if (head > n) head = n;
    for (i = lane; i < head; i += kWarp) d[i] = s[i];
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(s + head);
    uint32_t* dw = reinterpret_cast<uint32_t*>(d + head);
    const long long nw = (n - head) >> 2;
#pragma unroll 4
    for (i = lane; i < nw; i += kWarp) dw[i] = sw[i];
    for (i = head + (nw << 2) + lane; i < n; i += kWarp) d[i] = s[i];
  } else {
    for (i = lane; i < n; i += kWarp) d[i] = s[i];
  }
}

// Entry r of the plan copies src row `src_ids[r]` (or r when src_ids is null)
// to dst row `dst_ids[r]` (or r when dst_ids is null), one warp per entry.
// With `self_src`, entries whose two page_move plan ids (`self_src[r]`,
// `self_dst[r]`) are equal are skipped, in both phases alike.
__global__ void copy_rows(const unsigned char* __restrict__ src, long long src_rows,
                          unsigned char* __restrict__ dst, long long dst_rows,
                          const int* __restrict__ src_ids, const int* __restrict__ dst_ids,
                          const int* __restrict__ self_src, const int* __restrict__ self_dst,
                          int m, long long row_bytes) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) / kWarp;
  for (long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
       r < m; r += warps) {
    if (self_src != nullptr && self_src[r] == self_dst[r]) continue;
    const long long s = src_ids ? static_cast<long long>(src_ids[r]) : r;
    const long long d = dst_ids ? static_cast<long long>(dst_ids[r]) : r;
    if (s < 0 || s >= src_rows || d < 0 || d >= dst_rows) continue;
    copy_row(src + s * row_bytes, dst + d * row_bytes, row_bytes, lane);
  }
}

int grid_for(int m) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int rows_per_block = kThreads / kWarp;
  const int want = (m + rows_per_block - 1) / rows_per_block;
  const int cap = sms * 16;
  return want < cap ? want : cap;
}

}  // namespace

extern "C" {

// page_move: pool[dst[i]] = pool[src[i]] with gather semantics, via scratch
// (an [m, row_bytes] buffer the caller allocates).
int page_move(void* pool, long long rows, const void* src_ids, const void* dst_ids,
              int m, long long row_bytes, void* scratch, void* stream) {
  if (m <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = grid_for(m);
  const int* s = static_cast<const int*>(src_ids);
  const int* d = static_cast<const int*>(dst_ids);
  unsigned char* p = static_cast<unsigned char*>(pool);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  copy_rows<<<grid, kThreads, 0, st>>>(p, rows, sc, m, s, nullptr, s, d, m, row_bytes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_rows<<<grid, kThreads, 0, st>>>(sc, m, p, rows, nullptr, d, s, d, m, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

// page_copy: dst_pool[dst[i]] = src_pool[src[i]], one pass.
int page_copy(const void* src_pool, long long src_rows, void* dst_pool, long long dst_rows,
              const void* src_ids, const void* dst_ids, int m, long long row_bytes,
              void* stream) {
  if (m <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  copy_rows<<<grid_for(m), kThreads, 0, st>>>(
      static_cast<const unsigned char*>(src_pool), src_rows,
      static_cast<unsigned char*>(dst_pool), dst_rows, static_cast<const int*>(src_ids),
      static_cast<const int*>(dst_ids), nullptr, nullptr, m, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
