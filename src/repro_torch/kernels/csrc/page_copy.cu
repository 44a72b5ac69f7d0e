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
//  * `copy_row` copies one row as bytes with the 32 lanes of a warp: 16-byte
//    vectors when the source and destination rows share their alignment
//    modulo 16 (a byte-wise head brings both to a 16-byte boundary, a
//    byte-wise tail ends the row), 4-byte words when they share it modulo 4,
//    and single bytes otherwise. Neighbouring lanes touch neighbouring
//    addresses. The vector loop issues kDepth loads per lane before it
//    stores them, so a warp keeps kDepth * 512 bytes in flight: a 4 KiB row
//    is one such batch, a 16 KiB KV row four.
//  * page_copy (two pools) is one launch of `copy_rows`, a warp per plan
//    entry. Its trash padding writes different rows into the trash row from
//    several warps; the trash row's content is unspecified.
//  * page_move is one pool, and the data plane relies on write-after-read: a
//    demote vacates a fast row that a promote of the same call fills. The TPU
//    grid runs in plan order, so that came for free there; CUDA blocks run in
//    no order. page_move orders the copies without moving any row twice. A
//    *real* entry has src != dst, both in range (the data plane pads its
//    plans with trash->trash entries, which are not real). Three launches:
//     1. `move_mark`, a thread per entry: sets R on each real entry's source
//        row and W on its destination row (a byte each, in a map the wrapper
//        keeps zero between calls), and compacts the real entries into a list
//        (one atomic per warp).
//     2. `move_pass_a`, a warp per real entry, classifies it and stores the
//        class: A when no real entry reads its destination (R unset there):
//        copied now; B when some entry reads its destination and none writes
//        its source (W unset there): copied in pass B; S (staged) otherwise,
//        the inner links of chains of three or more and of cycles: its
//        source is copied now into a scratch slot taken by atomicAdd.
//     3. `move_pass_b`, a warp per real entry: copies B entries from their
//        source and S entries from scratch, and clears the marks the entry
//        set (no entry of this pass reads a mark).
//    Three plain launches: one cooperative kernel with grid barriers between
//    the passes measured 1-2 us slower at the data plane's 4 KiB and the
//    summaries' 2 KiB rows on an H100 and no faster at 16 KiB.
//    Every row pass A writes is read by no entry, and every row pass A reads
//    is written by no entry of pass A; every read of a row that pass B writes
//    happened in pass A, and every source pass B reads is written by no
//    entry. So each entry reads the pre-plan row, whatever the plan. The data
//    plane's and the KV cache's plans have no S entry (demotes are A, their
//    promotes B): each of their rows crosses HBM once.
//  * The real-entry count alternates between two counters: call t counts in
//    counter t % 2 and `move_mark` zeroes the other one for call t + 1 (every
//    kernel of call t - 1 that read it has finished, in stream order). The
//    class counters (A, B, S; S doubles as the scratch-slot counter) are
//    zeroed by `move_mark` and hold the last call's counts afterwards.
//  * Ids outside [0, rows) are skipped: the kernels never touch memory outside
//    the pools (the contract requires in-range ids; the wrappers do not sync
//    to check them). Real destinations must be distinct, as under gather
//    semantics; a row written by two real entries ends with one of them.
//
// C interface (pointers and the stream as void*, loaded with ctypes). Each
// function returns cudaGetLastError() after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kDepth = 8;  // 16-byte loads in flight per lane

// page_move's counters (int32 words, a 128-byte line each): the class
// counts A, B, S of the last call, then the two alternating real counts.
// kernels/page_copy.py mirrors this layout.
constexpr int kLine = 32;
constexpr int kCtrA = 0;
constexpr int kCtrB = kLine;
constexpr int kCtrS = 2 * kLine;
constexpr int kCtrReal = 3 * kLine;  // and kCtrReal + kLine

// page_move classes as stored per real entry; S stores kS + its scratch slot
constexpr int kA = 0;
constexpr int kB = 1;
constexpr int kS = 2;

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
    for (i = lane; i < nv; i += kDepth * kWarp) {
      uint4 r[kDepth];
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (i + u * kWarp < nv) r[u] = sv[i + u * kWarp];
      }
#pragma unroll
      for (int u = 0; u < kDepth; ++u) {
        if (i + u * kWarp < nv) dv[i + u * kWarp] = r[u];
      }
    }
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

// page_copy: entry r copies src row `src_ids[r]` to dst row `dst_ids[r]`,
// one warp per entry.
__global__ void copy_rows(const unsigned char* __restrict__ src, long long src_rows,
                          unsigned char* __restrict__ dst, long long dst_rows,
                          const int* __restrict__ src_ids, const int* __restrict__ dst_ids,
                          int m, long long row_bytes) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) / kWarp;
  for (long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
       r < m; r += warps) {
    const long long s = src_ids[r];
    const long long d = dst_ids[r];
    if (s < 0 || s >= src_rows || d < 0 || d >= dst_rows) continue;
    copy_row(src + s * row_bytes, dst + d * row_bytes, row_bytes, lane);
  }
}

// page_move pass 1: marks and the compacted list of real entries.
__global__ void move_mark(const int* __restrict__ src_ids, const int* __restrict__ dst_ids,
                          int m, long long rows, unsigned char* __restrict__ marks,
                          int2* __restrict__ plan, int* __restrict__ ctr, int parity) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    ctr[kCtrReal + (parity ^ 1) * kLine] = 0;
    ctr[kCtrA] = 0;
    ctr[kCtrB] = 0;
    ctr[kCtrS] = 0;
  }
  int* n_real = ctr + kCtrReal + parity * kLine;
  const int lane = threadIdx.x & (kWarp - 1);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  // the loop runs while the warp's first entry is in the plan, so that all
  // 32 lanes reach the ballot
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i - lane < m; i += stride) {
    int s = 0, d = 0;
    if (i < m) {
      s = src_ids[i];
      d = dst_ids[i];
    }
    const bool real = i < m && s != d && s >= 0 && s < rows && d >= 0 && d < rows;
    const unsigned ballot = __ballot_sync(0xffffffffu, real);
    if (ballot == 0) continue;
    int base = 0;
    if (lane == 0) base = atomicAdd(n_real, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, 0);
    if (real) {
      plan[base + __popc(ballot & ((1u << lane) - 1))] = make_int2(s, d);
      marks[2 * static_cast<long long>(s)] = 1;      // R: read by a real entry
      marks[2 * static_cast<long long>(d) + 1] = 1;  // W: written by a real entry
    }
  }
}

// page_move pass 2: classify each real entry; copy A, stage S into scratch.
__global__ void move_pass_a(unsigned char* __restrict__ pool, long long row_bytes,
                            const int2* __restrict__ plan, int* __restrict__ cls,
                            const unsigned char* __restrict__ marks, int* __restrict__ ctr,
                            int parity, unsigned char* __restrict__ scratch) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) / kWarp;
  const int n = ctr[kCtrReal + parity * kLine];
  for (long long k = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
       k < n; k += warps) {
    const int2 e = plan[k];
    int c = 0;
    if (lane == 0) {
      if (!marks[2 * static_cast<long long>(e.y)]) {
        c = kA;
        atomicAdd(ctr + kCtrA, 1);
      } else if (!marks[2 * static_cast<long long>(e.x) + 1]) {
        c = kB;
        atomicAdd(ctr + kCtrB, 1);
      } else {
        c = kS + atomicAdd(ctr + kCtrS, 1);
      }
      cls[k] = c;
    }
    c = __shfl_sync(0xffffffffu, c, 0);
    if (c == kB) continue;
    unsigned char* to = c == kA ? pool + e.y * row_bytes : scratch + (c - kS) * row_bytes;
    copy_row(pool + e.x * row_bytes, to, row_bytes, lane);
  }
}

// page_move pass 3: copy B from the pool and S from scratch; clear the marks.
__global__ void move_pass_b(unsigned char* __restrict__ pool, long long row_bytes,
                            const int2* __restrict__ plan, const int* __restrict__ cls,
                            unsigned char* __restrict__ marks, const int* __restrict__ ctr,
                            int parity, const unsigned char* __restrict__ scratch) {
  const int lane = threadIdx.x & (kWarp - 1);
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x) / kWarp;
  const int n = ctr[kCtrReal + parity * kLine];
  for (long long k = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
       k < n; k += warps) {
    const int2 e = plan[k];
    const int c = cls[k];
    if (lane == 0) {
      marks[2 * static_cast<long long>(e.x)] = 0;
      marks[2 * static_cast<long long>(e.y) + 1] = 0;
    }
    if (c == kA) continue;
    const unsigned char* from = c == kB ? pool + e.x * row_bytes : scratch + (c - kS) * row_bytes;
    copy_row(from, pool + e.y * row_bytes, row_bytes, lane);
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// blocks for `items` work items of `per_block` each, at most `per_sm` per SM
int grid_for(long long items, int per_block, int per_sm) {
  const long long want = (items + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sm_count()) * per_sm;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

extern "C" {

// page_move: pool[dst[i]] = pool[src[i]] with gather semantics. Workspace
// from the caller: `marks` u8[2 * rows], zero on entry and left zero;
// `plan` int2[m]; `cls` int[m]; `ctr` int[5 * 32], its real count for
// `parity` zero on entry (zero on first use, then kept so by the kernels
// while calls alternate parity); `scratch` min(m, rows) rows.
int page_move(void* pool, long long rows, const void* src_ids, const void* dst_ids, int m,
              long long row_bytes, void* marks, void* plan, void* cls, void* ctr, int parity,
              void* scratch, void* stream) {
  if (m <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned char* p = static_cast<unsigned char*>(pool);
  unsigned char* mk = static_cast<unsigned char*>(marks);
  int2* pl = static_cast<int2*>(plan);
  int* cl = static_cast<int*>(cls);
  int* c = static_cast<int*>(ctr);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  move_mark<<<grid_for(m, kThreads, 8), kThreads, 0, st>>>(
      static_cast<const int*>(src_ids), static_cast<const int*>(dst_ids), m, rows, mk, pl, c,
      parity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = grid_for(m, kThreads / kWarp, 8);  // a warp per entry
  move_pass_a<<<grid, kThreads, 0, st>>>(p, row_bytes, pl, cl, mk, c, parity, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  move_pass_b<<<grid, kThreads, 0, st>>>(p, row_bytes, pl, cl, mk, c, parity, sc);
  return static_cast<int>(cudaGetLastError());
}

// page_copy: dst_pool[dst[i]] = src_pool[src[i]], one pass.
int page_copy(const void* src_pool, long long src_rows, void* dst_pool, long long dst_rows,
              const void* src_ids, const void* dst_ids, int m, long long row_bytes,
              void* stream) {
  if (m <= 0 || row_bytes <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  copy_rows<<<grid_for(m, kThreads / kWarp, 16), kThreads, 0, st>>>(
      static_cast<const unsigned char*>(src_pool), src_rows,
      static_cast<unsigned char*>(dst_pool), dst_rows, static_cast<const int*>(src_ids),
      static_cast<const int*>(dst_ids), m, row_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
